// Deterministic scatter-accumulate: the backward of the train path's h1
// gathers (ops/scatter_accum.gather_h1).
//
//   out_t[row] = sum over updates u with idx[u, t] == row, in the order of
//                u, of (float) g_t[u]          for each table t (<= 3)
//
// Replaces the Pallas TPU kernels of lirec_tpu/ops/scatter_accum.py:
//   _make_kernel3 (line 91, three tables, [N, R, d] updates)
//   _make_kernel  (line 49, three tables, updates flattened to [N * R, d])
//   _make_kernel1 (line 282, one table)
// The TPU kernels kept the f32 accumulators resident in VMEM and walked
// the updates in a sequential grid, one read-modify-write per update row.
// On the GPU blocks run in parallel and in no order, and f32 atomicAdd
// would make the order of the sums, and so their bits, change from run to
// run. So the wrapper first orders the updates by destination: a stable
// sort of the (table-offset) row ids gives `perm`, the update positions
// grouped by destination row in their original order, and `offsets`, each
// destination row's segment of `perm`. The three [N, R] layouts above are
// all contiguous [M, d] here, so one entry serves them all.
//
// Why the arithmetic order is fixed: every output column of a row is one
// f32 chain of __fadd_rn over the row's updates in their original order
// (no contraction, no reassociation), so the result is bitwise the CPU's
// in-order index_add_ and the JAX kernels' in-order sums, and it does not
// change from run to run. The chain is serial in the updates and parallel
// only in the columns; that is part of the result, not of the design.
//
// What bounds it on this card: bytes, and on the skewed row, the chain.
// Every update row is read once and every output row written once: at the
// train step's shapes (B = 64, T = 20, R = 18: 23,040 updates of 1024 + 2
// x 512 columns into the Localizer's tables of 2,816 / 5,376 rows) 188.7 MB
// of f32 updates (94.4 MB bf16) and 33.5 MB of f32 outputs, 66 us (38 us)
// at 3.35 TB/s. The data is skewed: every masked ctx slot points at row 0,
// which collects a quarter of each table's updates (6,543 of 23,040); the
// other segments are short (8 updates on average, at most 28). The chain
// puts a floor of 6,543 dependent adds, ~15 us, on the padding row's
// columns, and those rows' 53.6 MB (f32) have to stream through the few
// SMs that own their columns. The first design (one block per destination
// row with scalar loads, then a second launch for rows over 128 updates in
// 16-column tiles that 240 of 256 threads only loaded) took 0.180 / 0.187
// ms there (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Design: the sort below lists the (segment, column tile) pairs of every
// segment longer than kShort (the hot tiles), and their count; then two
// kernels run at once on two streams.
// * scatter_hot_kernel, on a stream of the highest priority: a block of
//   five warps per hot tile, one 128-byte line of columns (32 f32 or 64
//   bf16) of a long segment. Four copier warps stream the tile's update
//   rows into a 96 KB ring of six 128-row stages with 16-byte cp.async
//   copies and signal a stage once per warp, two stages behind their issue
//   (cp.async.wait_group, then one mbarrier arrival); the adder warp, a
//   lane per 4 bytes of the line, loads a stage's rows from shared memory
//   a batch of 32 ahead of its adds and frees the stage with one arrival.
// * scatter_short_kernel, on the caller's stream at the same time: one
//   warp per item, an item being kRun consecutive rows of a table times a
//   column tile of one 16-byte vector per lane (512 bytes of each update
//   row). Each lane copies its 16 bytes of the update row kAhead positions
//   ahead into its own ring of kSlots shared slots (cp.async) and reads
//   back only what it copied, so a warp keeps 7 KB in flight without a
//   barrier. Update positions come 32 at a time (one perm load per lane),
//   a chunk ahead. Rows of more than kShort updates are skipped; a row no
//   update touches is written as zeros by the same vector stores, so the
//   output needs no clearing pass.
// * Updates whose rows are not all whole 16-byte vectors on 16-byte
//   boundaries (a view off an aligned base, or a width in bytes not a
//   multiple of 16) take scalar loads in the same kernels: one column per
//   lane, and per thread in a hot tile. The wrapper decides per table
//   (ops/scatter_accum.scatter_plan).
// Earlier versions of this design, measured on the card, were slower for
// four reasons it now avoids: a bulk copy (cp.async.bulk) per 128-byte
// piece of an update row left the SM's copy engine the bottleneck; an
// mbarrier arrival per copier thread serialised on the barrier's word; an
// adder whose every add waited on its own shared load; and update
// positions divided as soon as they were loaded, which stalled the copiers
// on every load (PERF.md).
//
// The front end: a stable counting sort by destination row, in place of
// the library sort the port first used (torch.sort of the int32 keys plus
// searchsorted: 0.079 ms at the train step's caps against this sort's
// 0.023 and the scatter's 0.096, NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// The TPU kernels needed none: their grid walked the
// updates in order. A stable sort of keys into S row segments is unique,
// so `perm` and `offsets` are bitwise what ops/scatter_accum.sort_by_row
// (the plain version) gives. Its positions (P = M x n_tables) are cut
// into units of at most kSortUnit, and a pass is three launches, none of
// which waits on another block or on the host:
// * sort_count_kernel, a block per unit: the unit's count of each digit,
//   as 16-bit pairs in shared memory, written densely as the unit's row
//   of an [units, digits] matrix.
// * sort_prefix_kernel, a thread per digit: each column of the matrix
//   becomes its exclusive prefix in unit order, and its sum the digit's
//   length; a block scans its range of digits' lengths and writes the
//   range's sum.
// * sort_place_kernel, a block per unit: scans the ranges' sums, stages
//   each position's digit, destination base and rank among the equal
//   digits of its step of 32 (__match_any_sync), then one warp walks the
//   steps in order, a 16-bit counter per digit in shared memory carrying
//   the rank from step to step. Destination: the digit's start + the
//   unit's prefix + the rank.
// Where the [units, S + 2] matrix is small (at most 2**22 ints and 2**16
// buckets: the train step's caps, 68 x 13,570, and split-scale tables,
// 68 x 61,442) one pass sorts by the whole bucket (a row, plus one before
// the rows and one after them for ids out of range); the prefix kernel
// lists the hot tiles and the place kernel writes `offsets`. Past it
// (2**17 rows and beyond) a stable pass per digit of the bucket, the low
// digit first (an LSD radix sort), each pass carrying the buckets and
// positions in its order to the next, so the units stay 1,024 positions
// and the counters stay in shared memory at every S; then
// sort_offsets_kernel, a thread per row, finds `offsets` by a binary
// search of the sorted buckets and lists the hot tiles. The matrix is
// latency, from L2.
//
// And for few updates, one launch with no sort (scatter_small_kernel): a
// warp per output row of one table, lanes over its columns, walks the
// update ids in order from shared memory 32 at a time (__ballot_sync) and
// adds the rows that hit from 0.f, in update order: the same chain, so the
// same bits. The int_rels sweep's score table (a few dozen to a thousand
// updates of 6-15 columns) takes it; the wrapper's size rule
// (ops/scatter_accum.scatter_path) decides.
//
// Memory safety does not depend on the ids: reads go through `perm`
// (positions < M) and writes through each item's own row. Ids out of a
// table's range land in another table's segments or in none (the sort's
// first or last bucket); the callers check the ids on the host before the
// step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 128;  // scatter_short_kernel: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kShort = 32;     // longest segment a warp sums
constexpr int kRun = 8;        // consecutive rows of one short item
constexpr int kSlots = 16;     // a lane's ring of 16-byte shared slots,
constexpr int kAhead = kSlots - 2;  // and the update rows it copies ahead
constexpr int kLaneBytes = 16;
constexpr int kShortSmem = kThreads * kSlots * kLaneBytes;  // 32 KB
constexpr int kShortBlocksPerSm = 6;
constexpr int kUnroll = 8;     // scalar loads issued ahead of their adds
constexpr int kHotRowBytes = 128;  // a hot tile's bytes of each update row
constexpr int kProducers = 4;      // scatter_hot_kernel: warps that copy,
constexpr int kHotThreads = 32 * (kProducers + 1);  // and one that adds
constexpr int kStageRows = 128;                           // update rows
constexpr int kStageBytes = kStageRows * kHotRowBytes;    // 16 KB
constexpr int kStages = 6;                                // ring stages
constexpr int kRingBytes = kStages * kStageBytes;         // 96 KB
constexpr int kCycle = 2;  // stages whose update positions a copier holds
constexpr int kLag = 2;    // stages a copier issues before it signals one
constexpr int kBatch = 32;  // rows the adder loads before it adds them
constexpr int kPieces = kHotRowBytes / 16;                // copies a row
constexpr int kRowsPerPass = 32 * kProducers / kPieces;   // 16
constexpr int kPasses = kStageRows / kRowsPerPass;        // 8 copies a stage
constexpr int kBarBytes = 512;  // the stages' full and empty mbarriers
constexpr unsigned kFull = 0xffffffffu;
// the sort
constexpr int kCountThreads = 512;     // sort_count_kernel
constexpr int kPrefixThreads = 256;    // sort_prefix_kernel
constexpr int kPrefixAhead = 16;       // unit counts a thread loads at once
constexpr int kPlaceThreads = 256;     // sort_place_kernel: stage, then walk
constexpr int kOffsetThreads = 256;    // sort_offsets_kernel
constexpr int kSortUnit = 1024;        // the most positions of a unit
constexpr int kMaxBuckets = 1 << 16;   // the most buckets (digits) of a pass
constexpr int kMaxRanges = kMaxBuckets / kPrefixThreads;  // prefix blocks
// the one-launch path
constexpr int kSmallWarps = 8;         // output rows of a block
constexpr int kSmallMaxIds = 12288;    // update ids it stages (48 KB)

static_assert(kShort <= 32, "one update position per lane");
static_assert(kRun < 32, "a lane per segment start and the run's end");
static_assert((kSlots & (kSlots - 1)) == 0 && kAhead <= 32, "the lane ring");
static_assert(2 * kStages * 8 <= kBarBytes, "barrier space");
static_assert(kStageRows % kRowsPerPass == 0, "whole copy passes");
static_assert(kLag < kStages, "a stage is signalled before its reuse");
static_assert(kStageRows % kBatch == 0, "whole adder batches");
static_assert(kSortUnit < (1 << 16), "16-bit counts of a unit's positions");
static_assert(kMaxRanges * 16 + kSortUnit * 4 * 5 + kMaxBuckets * 2 <=
                  227 * 1024,
              "sort_place_kernel's shared memory");

struct Table {
  const void* g;  // [M, d] updates (T_in)
  void* out;      // [rows, d] output (float or bf16)
  int64_t rows;
  int d;
  int vec;        // the updates are read in 16-byte vectors
  int out_vec;    // the output is written in vectors
  int tiles;      // short items (warp tiles) per row
  int hot_tiles;  // hot tiles per row
};

struct Tables {
  Table t[3];
  int64_t seg0[4];   // first segment of each table; seg0[n] = all
  int64_t item0[4];  // first short item of each table; item0[n] = all
};

template <typename T>
struct Vec {  // one 16-byte load of T values
  using type = uint4;
  static constexpr int n = 8;
};
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};

__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
// bf16 -> f32 is the 16 bits on top of a zero mantissa tail
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float elem(const uint4& v, int e) {
  const uint32_t w = (e >> 1) == 0 ? v.x : (e >> 1) == 1 ? v.y
                   : (e >> 1) == 2 ? v.z : v.w;
  return (e & 1) ? hi_bf16(w) : lo_bf16(w);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store1(const Table& tab, int64_t o, float v,
                                       int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(tab.out)[o] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(tab.out)[o] = v;
}

// n consecutive outputs from element o, in vectors where the table allows
template <int n>
__device__ __forceinline__ void store_n(const Table& tab, int64_t o,
                                        const float (&v)[n], int out_bf16) {
  if constexpr (n == 1) {
    store1(tab, o, v[0], out_bf16);
  } else if (!tab.out_vec) {
#pragma unroll
    for (int e = 0; e < n; ++e) store1(tab, o + e, v[e], out_bf16);
  } else if (out_bf16) {
    uint32_t w[n / 2];
#pragma unroll
    for (int e = 0; e < n; e += 2)
      w[e / 2] = bf16_bits(v[e]) | (bf16_bits(v[e + 1]) << 16);
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(tab.out) + o;
    if constexpr (n == 8)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    float* p = static_cast<float*>(tab.out) + o;
#pragma unroll
    for (int e = 0; e < n; e += 4)
      *reinterpret_cast<float4*>(p + e) =
          make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
  }
}

// table and row of segment `seg`: segments are laid out table after table
__device__ __forceinline__ int locate(const Tables& tabs, int n_tables,
                                      int64_t seg, int64_t* row) {
  int t = 0;
  while (t + 1 < n_tables && seg >= tabs.seg0[t + 1]) ++t;
  *row = seg - tabs.seg0[t];
  return t;
}

// the update row of a flat position u * n_tables + t of perm (positions
// are below 2**31: the wrapper checks). Positions are loaded ahead as raw
// 32-bit values and divided only where used, so a load is not waited for
// when it is issued.
template <int n_tables>
__device__ __forceinline__ int64_t update_row(uint32_t flat) {
  return flat / static_cast<uint32_t>(n_tables);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, cached in L2 only; completes asynchronously
__device__ __forceinline__ void copy16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Waits for the phase of parity `parity` to complete. A wait that never
// completes traps after ~4M polls, so a launch fails with an error instead
// of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 22)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// How a lane reads its columns of an update row: one 16-byte vector of n
// values, or (kVec false) one value
template <typename T, bool kVec>
struct Lane {
  using Raw = typename Vec<T>::type;
  static constexpr int n = Vec<T>::n;
  static __device__ __forceinline__ float get(const Raw& r, int e) {
    return elem(r, e);
  }
};
template <typename T>
struct Lane<T, false> {
  using Raw = float;
  static constexpr int n = 1;
  static __device__ __forceinline__ float get(Raw r, int) { return r; }
};

// One short item by one warp: the column tile `tile` (32 lanes of L::n
// columns) of kRun consecutive rows of a table. Rows of more than kShort
// updates are skipped (the hot tiles sum them); the others form sub-runs
// whose segments are one contiguous range of perm each, walked position
// by position in update order; a segment's sum is stored when the walk
// passes its end, so a row without updates gets zeros.
//   kVec: each lane copies its 16 bytes of the update row kAhead positions
//   ahead into its own ring of kSlots shared slots (cp.async), so a warp
//   keeps kAhead x 512 bytes in flight; each lane reads back only what it
//   copied itself, so no barrier is needed. The update positions come in
//   chunks of 32 (one perm load per lane), a chunk ahead of the copies.
//   Scalar (kVec false): one column per lane, kUnroll loads ahead.
template <typename T, int n_tables, bool kVec>
__device__ __forceinline__ void short_item(const Tables& tabs, int t,
                                           int64_t local,
                                           const int64_t* __restrict__ perm,
                                           const int64_t* __restrict__ offsets,
                                           int out_bf16,
                                           unsigned char* ring) {
  using L = Lane<T, kVec>;
  constexpr int n = L::n;
  const Table& tab = tabs.t[t];
  const int64_t run = local / tab.tiles;
  const int tile = static_cast<int>(local - run * tab.tiles);
  const int64_t row0 = run * kRun;
  const int nrow = static_cast<int>(
      tab.rows - row0 < kRun ? tab.rows - row0 : kRun);
  const int lane = threadIdx.x & 31;
  // lane j <= nrow holds the start of segment j (and the end of j - 1)
  const int64_t off = lane <= nrow ? offsets[tabs.seg0[t] + row0 + lane] : 0;
  const int64_t next = __shfl_down_sync(kFull, off, 1);
  const unsigned hot =
      __ballot_sync(kFull, lane < nrow && next - off > kShort);
  const T* g = static_cast<const T*>(tab.g);
  const int d = tab.d;
  const int c = tile * 32 * n + lane * n;
  const bool active = c < d;
  unsigned char* slots = ring + lane * kLaneBytes;  // slot k: + k * 512
  const uint32_t slot0 = smem_addr(slots);

  float acc[n];
#pragma unroll
  for (int e = 0; e < n; ++e) acc[e] = 0.f;
  int s = 0;
  while (s < nrow) {
    if ((hot >> s) & 1) {  // a hot segment: its row is the hot tiles'
      ++s;
      continue;
    }
    // the sub-run of segments s .. e - 1, positions a .. b - 1
    const unsigned later = hot >> s;
    const int e = later ? s + __ffs(later) - 1 : nrow;
    const int64_t a = __shfl_sync(kFull, off, s);
    const int64_t len = __shfl_sync(kFull, off, e) - a;
    int cur = s;  // the segment being summed, and where it ends
    int64_t cur_end = __shfl_sync(kFull, off, s + 1) - a;
    // close (store) every segment of the sub-run that ends at or before q
    auto close_until = [&](int64_t q) {
      while (cur < e && cur_end <= q) {
        if (active) store_n<n>(tab, (row0 + cur) * d + c, acc, out_bf16);
#pragma unroll
        for (int k = 0; k < n; ++k) acc[k] = 0.f;
        ++cur;
        cur_end = __shfl_sync(kFull, off, cur + 1) - a;
      }
    };
    close_until(0);
    // perm holds flat positions u * n_tables + t; u is the update row
    uint32_t ch0 = lane < len ? static_cast<uint32_t>(perm[a + lane]) : 0;
    if constexpr (kVec) {
      uint32_t ch1 =
          32 + lane < len ? static_cast<uint32_t>(perm[a + 32 + lane]) : 0;
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int64_t src =
            update_row<n_tables>(__shfl_sync(kFull, ch0, k));
        if (active && k < len) copy16(slot0 + k * 32 * kLaneBytes,
                                      g + src * d + c);
        copy_commit();
      }
      for (int64_t j = 0; j < len; ++j) {
        if ((j & 31) == 0 && j > 0) {  // the next chunk of positions
          ch0 = ch1;
          ch1 = j + 32 + lane < len
                    ? static_cast<uint32_t>(perm[a + j + 32 + lane]) : 0;
        }
        copy_wait<kAhead - 1>();  // position j has landed
        typename L::Raw x;
        if (active)
          x = *reinterpret_cast<const typename L::Raw*>(
              slots + (j & (kSlots - 1)) * 32 * kLaneBytes);
        close_until(j);
        if (active)
#pragma unroll
          for (int k = 0; k < n; ++k) acc[k] = __fadd_rn(acc[k], L::get(x, k));
        // position j + kAhead into the slot position j - 2 freed
        const int64_t q = j + kAhead;
        const int64_t src = update_row<n_tables>(
            __shfl_sync(kFull, (q >> 5) == (j >> 5) ? ch0 : ch1, q & 31));
        if (active && q < len)
          copy16(slot0 + (q & (kSlots - 1)) * 32 * kLaneBytes,
                 g + src * d + c);
        copy_commit();
      }
    } else {
      for (int64_t p = 0; p < len; p += 32) {
        if (p > 0)
          ch0 = p + lane < len ? static_cast<uint32_t>(perm[a + p + lane])
                               : 0;
        const int cnt = static_cast<int>(len - p < 32 ? len - p : 32);
        for (int j0 = 0; j0 < cnt; j0 += kUnroll) {
          float x[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int64_t src = update_row<n_tables>(
                __shfl_sync(kFull, ch0, (j0 + u) & 31));
            if (active && j0 + u < cnt) x[u] = to_f32(g[src * d + c]);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (j0 + u >= cnt) break;
            close_until(p + j0 + u);
            if (active) acc[0] = __fadd_rn(acc[0], x[u]);
          }
        }
      }
    }
    close_until(len);
    s = e;
  }
}

// A thread's place in the hot kernel's ring: the buffer, the parity of its
// current use, and whether every buffer has been used once
struct Ring {
  int buf = 0;
  uint32_t phase = 0;
  bool wrapped = false;
  __device__ __forceinline__ void next() {
    if (++buf == kStages) {
      buf = 0;
      phase ^= 1;
      wrapped = true;
    }
  }
};

// The hot tiles, one block each at a time (a block walks hot tiles h,
// h + gridDim.x, ...): columns col0 .. col0 + kHotCols - 1 of a long
// segment, kHotCols = one 128-byte line of each update row. Warp
// specialised around a ring of kStages stages of kStageRows update rows:
// the copier warps fill a stage with 16-byte cp.async copies (a row is
// kPieces lanes), and once a warp's copies of a stage have landed (kLag
// stages later) its lane 0 arrives on the stage's `full` mbarrier; the
// adder warp's lanes own 4 bytes of the line each (one f32 or two bf16
// columns) and, stage after stage, add the stage's rows in update order,
// then lane 0 arrives on the stage's `empty` mbarrier so the copiers may
// refill it. Copiers load the update positions of the next kCycle stages
// while they issue this cycle's copies. Tables
// that cannot take 16-byte copies are summed from plain loads, one column
// per thread.
template <typename T, int n_tables>
__global__ void __launch_bounds__(kHotThreads)
scatter_hot_kernel(Tables tabs, const int64_t* __restrict__ perm,
                   const int64_t* __restrict__ offsets, int out_bf16,
                   const int* __restrict__ plan, int64_t cap) {
  constexpr int kHotCols = kHotRowBytes / static_cast<int>(sizeof(T));
  constexpr int kPerLane = 4 / static_cast<int>(sizeof(T));
  static_assert(kHotCols <= kHotThreads, "a thread a column (scalar path)");
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_hot = plan[0];
  if (static_cast<int>(blockIdx.x) >= n_hot) return;  // the whole block
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31;
  const uint32_t full0 = smem_addr(smem);
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t ring = smem_addr(smem + kBarBytes);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      bar_init(full0 + 8 * i, kProducers);
      bar_init(empty0 + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Ring pos;  // this thread's place in the ring, carried across tiles
  for (int h = blockIdx.x; h < n_hot; h += gridDim.x) {
    int64_t row;
    const int64_t seg = plan[1 + h];
    const Table& tab = tabs.t[locate(tabs, n_tables, seg, &row)];
    const int d = tab.d;
    const int col0 = plan[1 + cap + h] * kHotCols;
    const int ncols = d - col0 < kHotCols ? d - col0 : kHotCols;
    const int64_t beg = offsets[seg];
    const int64_t len = offsets[seg + 1] - beg;
    const T* g = static_cast<const T*>(tab.g);
    if (!tab.vec) {
      if (tid < ncols) {
        const int c = col0 + tid;
        float acc = 0.f;
        for (int64_t j0 = 0; j0 < len; j0 += kUnroll) {
          float x[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (j0 + u < len)
              x[u] = to_f32(g[update_row<n_tables>(static_cast<uint32_t>(
                                  perm[beg + j0 + u])) * d + c]);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (j0 + u < len) acc = __fadd_rn(acc, x[u]);
        }
        store1(tab, row * d + c, acc, out_bf16);
      }
      continue;
    }
    const int64_t n_stages = (len + kStageRows - 1) / kStageRows;
    if (warp < kProducers) {
      // copier: 16-byte piece `piece` of rows r0 + kRowsPerPass * k
      const int piece = tid % kPieces, r0 = tid / kPieces;
      const bool copies = piece * 16 < ncols * static_cast<int>(sizeof(T));
      const T* src0 = g + col0 + piece * (16 / static_cast<int>(sizeof(T)));
      uint32_t cur[kCycle][kPasses], nxt[kCycle][kPasses];
      auto fetch = [&](int64_t cycle, uint32_t (&u)[kCycle][kPasses]) {
#pragma unroll
        for (int i = 0; i < kCycle; ++i)
#pragma unroll
          for (int k = 0; k < kPasses; ++k) {
            const int64_t r = (cycle * kCycle + i) * kStageRows + r0 +
                              k * kRowsPerPass;
            u[i][k] = r < len ? static_cast<uint32_t>(perm[beg + r]) : 0;
          }
      };
      fetch(0, cur);
      for (int64_t cy = 0; cy * kCycle < n_stages; ++cy) {
        if ((cy + 1) * kCycle < n_stages) fetch(cy + 1, nxt);
#pragma unroll
        for (int i = 0; i < kCycle; ++i) {
          const int64_t s = cy * kCycle + i;
          if (s >= n_stages) break;
          if (pos.wrapped)  // the adder released this buffer's last use
            bar_wait(empty0 + 8 * pos.buf, pos.phase ^ 1);
          const uint32_t dst = ring + pos.buf * kStageBytes + piece * 16;
          const int64_t left = len - s * kStageRows - r0;
#pragma unroll
          for (int p = 0; p < kPasses; ++p)
            if (copies && p * kRowsPerPass < left)
              copy16(dst + (r0 + p * kRowsPerPass) * kHotRowBytes,
                     src0 + update_row<n_tables>(cur[i][p]) * d);
          copy_commit();
          if (s >= kLag) {  // this warp's copies of stage s - kLag landed
            copy_wait<kLag>();
            __syncwarp();
            if (lane == 0)
              bar_arrive(full0 + 8 * ((pos.buf + kStages - kLag) % kStages));
          }
          pos.next();
        }
#pragma unroll
        for (int i = 0; i < kCycle; ++i)
#pragma unroll
          for (int p = 0; p < kPasses; ++p) cur[i][p] = nxt[i][p];
      }
      copy_wait<0>();  // the last kLag stages
      __syncwarp();
      const int tail = static_cast<int>(n_stages < kLag ? n_stages : kLag);
      if (lane == 0)
        for (int i = 0; i < tail; ++i)
          bar_arrive(full0 + 8 * ((pos.buf + kStages - tail + i) % kStages));
    } else {
      // adder: lane owns bytes 4 * lane .. 4 * lane + 3 of the line
      const bool adder = lane * kPerLane < ncols;
      float acc[kPerLane];
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) acc[e] = 0.f;
      auto add = [&](uint32_t w) {  // one update row's 4 bytes
        if constexpr (kPerLane == 1) {
          acc[0] = __fadd_rn(acc[0], __uint_as_float(w));
        } else {
          acc[0] = __fadd_rn(acc[0], lo_bf16(w));
          acc[kPerLane - 1] = __fadd_rn(acc[kPerLane - 1], hi_bf16(w));
        }
      };
      for (int64_t s = 0; s < n_stages; ++s) {
        bar_wait(full0 + 8 * pos.buf, pos.phase);
        if (adder) {
          const uint32_t* b = reinterpret_cast<const uint32_t*>(
              smem + kBarBytes + pos.buf * kStageBytes) + lane;
          const int64_t left = len - s * kStageRows;
          if (left >= kStageRows) {
            // the next batch's loads go out before this batch's chain
            uint32_t v[kBatch], w[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) v[u] = b[u * (kHotRowBytes / 4)];
#pragma unroll
            for (int q = 0; q < kStageRows; q += kBatch) {
              if (q + kBatch < kStageRows)
#pragma unroll
                for (int u = 0; u < kBatch; ++u)
                  w[u] = b[(q + kBatch + u) * (kHotRowBytes / 4)];
#pragma unroll
              for (int u = 0; u < kBatch; ++u) add(v[u]);
#pragma unroll
              for (int u = 0; u < kBatch; ++u) v[u] = w[u];
            }
          } else {
            for (int u = 0; u < left; ++u) add(b[u * (kHotRowBytes / 4)]);
          }
        }
        __syncwarp();
        if (lane == 0) bar_arrive(empty0 + 8 * pos.buf);
        pos.next();
      }
      if (adder)
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          store1(tab, row * d + col0 + lane * kPerLane + e, acc[e],
                 out_bf16);
    }
  }
}

// The short items, one per warp, each warp with its ring of lane slots.
template <typename T, int n_tables>
__global__ void __launch_bounds__(kThreads, kShortBlocksPerSm)
scatter_short_kernel(Tables tabs, const int64_t* __restrict__ perm,
                     const int64_t* __restrict__ offsets, int out_bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t it =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (it >= tabs.item0[n_tables]) return;  // the whole warp
  unsigned char* ring = smem + (threadIdx.x / 32) * 32 * kSlots * kLaneBytes;
  int t = 0;
  while (t + 1 < n_tables && it >= tabs.item0[t + 1]) ++t;
  if (tabs.t[t].vec)
    short_item<T, n_tables, true>(tabs, t, it - tabs.item0[t], perm, offsets,
                                  out_bf16, ring);
  else
    short_item<T, n_tables, false>(tabs, t, it - tabs.item0[t], perm,
                                   offsets, out_bf16, ring);
}

// ------------------------------------------------------------------ sort

struct Sort {
  const int* idx;    // [P] row ids; position p = u * n_tables + t
  const int* keys;   // a later pass: [P] buckets, in the last pass's order
  const int* order;  // a later pass: [P] their positions
  int64_t seg0[4];   // first segment (key) of each table; seg0[n] = S
  int64_t P;         // positions
  int S;             // segments: the tables' rows
  int nb;            // this pass's buckets
  int shift, mask;   // a bucket's digit in this pass: (bucket >> shift) & mask
  int unit;          // positions of a unit (the last may hold fewer)
  int ranges;        // sort_prefix_kernel's blocks, kPrefixThreads buckets each
};

// Where a pass writes: perm (the last pass) or order (an earlier one) at
// each position's place; with several passes the buckets beside them
// (keys); with one, its share of offsets
struct Placed {
  int64_t* perm;
  int* order;
  int* keys;
  int64_t* offsets;
};

// The bucket of the pass's i-th input: 1 + the key (table offset + row
// id) for keys in [0, S), 0 below, S + 1 at or above; a later pass reads
// it from the last pass's keys
template <int n_tables>
__device__ __forceinline__ int bucket_in(const Sort& a, int64_t i) {
  if (a.keys) return a.keys[i];
  const int t = n_tables == 1 ? 0 : static_cast<int>(i % n_tables);
  const int64_t key = static_cast<int64_t>(a.idx[i]) + a.seg0[t];
  return key < 0 ? 0 : key >= a.S ? a.S + 1 : static_cast<int>(key) + 1;
}

__device__ __forceinline__ int digit_of(const Sort& a, int bucket) {
  return (bucket >> a.shift) & a.mask;
}

// The exclusive scan of one int a thread over the block (blockDim.x a
// multiple of 32, at most 32 warps), and the block's sum; `sums` is the
// block's scratch of 32 ints
__device__ __forceinline__ int block_exclusive(int v, int* sums,
                                               int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  int incl = v;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, k);
    if (lane >= k) incl += y;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? sums[lane] : 0;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int y = __shfl_up_sync(kFull, w, k);
      if (lane >= k) w += y;
    }
    sums[lane] = w;
  }
  __syncthreads();
  const int out = (warp ? sums[warp - 1] : 0) + incl - v;
  *total = sums[warps - 1];
  __syncthreads();  // sums is rewritten by the next call
  return out;
}

// A unit's count of each digit, written as the unit's row of hist
// [units, nb]: counted by order-free atomics in shared memory, two 16-bit
// counts a word (a unit holds under 2**16 positions, so a count never
// carries into its neighbour). With cap > 0 block 0 also zeroes the hot
// tiles' count, which sort_prefix_kernel or sort_offsets_kernel adds to.
template <int n_tables>
__global__ void __launch_bounds__(kCountThreads)
sort_count_kernel(Sort a, int* __restrict__ hist, int* __restrict__ plan,
                  int64_t cap) {
  extern __shared__ __align__(16) uint32_t pairs[];
  if (blockIdx.x == 0 && threadIdx.x == 0 && cap > 0) plan[0] = 0;
  int* row = hist + static_cast<int64_t>(blockIdx.x) * a.nb;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * a.unit;
  const int64_t hi = lo + a.unit < a.P ? lo + a.unit : a.P;
  const int words = (a.nb + 1) / 2;
  for (int w = threadIdx.x; w < words; w += kCountThreads) pairs[w] = 0;
  __syncthreads();
  for (int64_t p = lo + threadIdx.x; p < hi; p += kCountThreads) {
    const int s = digit_of(a, bucket_in<n_tables>(a, p));
    atomicAdd(&pairs[s >> 1], 1u << (16 * (s & 1)));
  }
  __syncthreads();
  for (int s = threadIdx.x; s < a.nb; s += kCountThreads)
    row[s] = static_cast<int>((pairs[s >> 1] >> (16 * (s & 1))) & 0xffffu);
}

// The hot tiles of segment `seg` (one of over kShort updates) listed for
// scatter_hot_kernel: plan[0] their count, plan[1 + h] segments,
// plan[1 + cap + h] tiles, in no particular order
template <int n_tables>
__device__ __forceinline__ void list_hot(const Tables& tabs, int seg,
                                         int* plan, int64_t cap) {
  int64_t row;
  const int n = tabs.t[locate(tabs, n_tables, seg, &row)].hot_tiles;
  const int h = atomicAdd(plan, n);
  for (int t = 0; t < n; ++t) {
    plan[1 + h + t] = seg;
    plan[1 + cap + h + t] = t;
  }
}

// A block per range of kPrefixThreads digits, a thread per digit: its
// column of hist -> its exclusive prefix over the units, in place, and its
// sum, the digit's length; local[s] = the exclusive scan of the lengths
// within the range, range_sum[r] = the range's sum. With cap > 0 (one
// pass: a digit is a bucket) the buckets of over kShort updates are
// listed as hot tiles.
template <int n_tables>
__global__ void __launch_bounds__(kPrefixThreads)
sort_prefix_kernel(Tables tabs, Sort a, int units, int* __restrict__ hist,
                   int* __restrict__ local, int* __restrict__ range_sum,
                   int* __restrict__ plan, int64_t cap) {
  __shared__ int sums[32];
  const int s = blockIdx.x * kPrefixThreads + threadIdx.x;
  int run = 0;
  if (s < a.nb) {
    for (int b0 = 0; b0 < units; b0 += kPrefixAhead) {
      int v[kPrefixAhead];
#pragma unroll
      for (int u = 0; u < kPrefixAhead; ++u)
        v[u] = b0 + u < units ? hist[static_cast<int64_t>(b0 + u) * a.nb + s]
                              : 0;
#pragma unroll
      for (int u = 0; u < kPrefixAhead; ++u)
        if (b0 + u < units) {
          hist[static_cast<int64_t>(b0 + u) * a.nb + s] = run;
          run += v[u];
        }
    }
    if (cap > 0 && s >= 1 && s <= a.S && run > kShort)
      list_hot<n_tables>(tabs, s - 1, plan, cap);
  }
  int total;
  const int ex = block_exclusive(run, sums, &total);
  if (s < a.nb) local[s] = ex;
  if (threadIdx.x == 0) range_sum[blockIdx.x] = total;
}

// A unit's positions placed in order by one warp: 32 a step, a step's
// equal digits ranked by lane, a 16-bit counter per digit in shared memory
// carrying the rank from step to step (a block per unit; with one pass
// more blocks, up to one per range and one wave of SMs, that only write
// offsets). First the block scans the ranges' sums into range_start, so a
// digit starts at range_start[s / kPrefixThreads] + local[s], and with one
// pass writes its share of offsets (offsets[s - 1] = that start, for s in
// 1 .. S + 1). Then the block's warps stage, for every step at once, each
// position's digit, destination base (the digit's start plus the unit's
// prefix) and place among the step's equal digits (__match_any_sync:
// rank, group size and leader lane), and with several passes (kCarry) its
// position and bucket, so the ordered walk reads no global memory and
// matches nothing.
template <int n_tables, bool kCarry>
__global__ void __launch_bounds__(kPlaceThreads)
sort_place_kernel(Sort a, const int* __restrict__ local,
                  const int* __restrict__ range_sum,
                  const int* __restrict__ hist, Placed out) {
  extern __shared__ __align__(16) unsigned char staged[];
  __shared__ int sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const unsigned below = (1u << lane) - 1;
  int* range_start = reinterpret_cast<int*>(staged);  // [ranges]
  {
    const int per = (a.ranges + kPlaceThreads - 1) / kPlaceThreads;
    const int r0 = threadIdx.x * per;
    int sum = 0;
    for (int r = r0; r < r0 + per && r < a.ranges; ++r) sum += range_sum[r];
    int all;
    int at = block_exclusive(sum, sums, &all);
    for (int r = r0; r < r0 + per && r < a.ranges; ++r) {
      range_start[r] = at;
      at += range_sum[r];
    }
    __syncthreads();
  }
  auto start = [&](int s) {
    return range_start[s / kPrefixThreads] + local[s];
  };
  if (!kCarry) {
    const int span = (a.nb + gridDim.x - 1) / gridDim.x;
    const int s0 = blockIdx.x * span;
    for (int s = s0 + threadIdx.x; s < s0 + span && s < a.nb;
         s += kPlaceThreads)
      if (s >= 1) out.offsets[s - 1] = start(s);
  }
  const int* row = hist + static_cast<int64_t>(blockIdx.x) * a.nb;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * a.unit;
  const int64_t hi = lo + a.unit < a.P ? lo + a.unit : a.P;
  const int n = hi > lo ? static_cast<int>(hi - lo) : 0;
  const int steps = (n + 31) / 32;
  int* digit = range_start + (a.ranges + 3) / 4 * 4;  // [steps * 32]
  int* base_of = digit + steps * 32;                  // [steps * 32]
  int* info_of = base_of + steps * 32;                // [steps * 32]
  int* pos_of = info_of + steps * 32;                 // [steps * 32], kCarry
  int* key_of = pos_of + steps * 32;                  // [steps * 32], kCarry
  uint16_t* rel =
      reinterpret_cast<uint16_t*>(kCarry ? key_of + steps * 32 : pos_of);
#pragma unroll 4
  for (int k = warp; k < steps; k += kPlaceThreads / 32) {
    const int i = k * 32 + lane;
    const bool valid = i < n;
    const int b = valid ? bucket_in<n_tables>(a, lo + i) : -1;
    const int s = valid ? digit_of(a, b) : -1;
    const unsigned peers = __match_any_sync(kFull, s);
    if (valid) {
      digit[i] = s;
      base_of[i] = start(s) + row[s];
      info_of[i] = __popc(peers & below) | (__popc(peers) << 8) |
                   ((__ffs(peers) - 1) << 16);
      rel[s] = 0;
      if (kCarry) {
        pos_of[i] = a.order ? a.order[lo + i] : static_cast<int>(lo + i);
        key_of[i] = b;
      }
    }
  }
  __syncthreads();
  if (warp > 0) return;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const bool valid = i < n;
    const int s = valid ? digit[i] : 0;
    const int info = valid ? info_of[i] : 0;
    const int leader = (info >> 16) & 31;
    int r = 0;
    if (valid && lane == leader) {
      r = rel[s];
      rel[s] = static_cast<uint16_t>(r + ((info >> 8) & 63));
    }
    r = __shfl_sync(kFull, r, leader);
    if (valid) {
      const int64_t d = base_of[i] + r + (info & 31);
      if (!kCarry) {
        out.perm[d] = lo + i;
      } else {
        if (out.perm)
          out.perm[d] = pos_of[i];
        else
          out.order[d] = pos_of[i];
        out.keys[d] = key_of[i];
      }
    }
    __syncwarp();
  }
}

// After several passes, a thread per segment k = 0 .. S: offsets[k] = the
// positions whose bucket is at most k, a binary search of the sorted
// buckets (keys [P]); with cap > 0 the segments of over kShort updates
// (a segment's end from the next lane) are listed as hot tiles.
template <int n_tables>
__global__ void __launch_bounds__(kOffsetThreads)
sort_offsets_kernel(Tables tabs, const int* __restrict__ keys, int64_t P,
                    int S, int64_t* __restrict__ offsets, int* plan,
                    int64_t cap) {
  const int64_t k =
      static_cast<int64_t>(blockIdx.x) * kOffsetThreads + threadIdx.x;
  auto at_most = [&](int64_t v) {  // positions whose bucket is at most v
    long long lo = 0, hi = P;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (keys[mid] <= v)
        lo = mid + 1;
      else
        hi = mid;
    }
    return lo;
  };
  const long long o = at_most(k);
  long long end = __shfl_down_sync(kFull, o, 1);
  if ((threadIdx.x & 31) == 31) end = at_most(k + 1);
  if (k <= S) offsets[k] = o;
  if (cap > 0 && k < S && end - o > kShort)
    list_hot<n_tables>(tabs, static_cast<int>(k), plan, cap);
}

// ------------------------------------------------- the one-launch path

// A warp per output row of one table, its lanes over the columns 32 at a
// time: the update ids, staged in shared memory, are walked in order 32
// at a time; the rows that hit are loaded up to 8 ahead of their adds and
// added in update order from 0.f. A row no id hits is written as zeros.
template <typename T>
__global__ void __launch_bounds__(32 * kSmallWarps)
scatter_small_kernel(Table tab, const int* __restrict__ idx, int M,
                     int out_bf16) {
  constexpr int kAheadRows = 8;
  __shared__ int ids[kSmallMaxIds];
  for (int u = threadIdx.x; u < M; u += 32 * kSmallWarps) ids[u] = idx[u];
  __syncthreads();
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kSmallWarps + threadIdx.x / 32;
  if (row >= tab.rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const T* g = static_cast<const T*>(tab.g);
  const int d = tab.d;
  for (int c0 = 0; c0 < d; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.f;
    for (int j0 = 0; j0 < M; j0 += 32) {
      unsigned hit = __ballot_sync(
          kFull, j0 + lane < M && ids[j0 + lane] == row);
      while (hit) {
        int u[kAheadRows];
        float x[kAheadRows];
#pragma unroll
        for (int k = 0; k < kAheadRows; ++k) {
          u[k] = hit ? j0 + __ffs(hit) - 1 : -1;
          hit &= hit - 1;
        }
#pragma unroll
        for (int k = 0; k < kAheadRows; ++k)
          if (u[k] >= 0 && c < d)
            x[k] = to_f32(g[static_cast<int64_t>(u[k]) * d + c]);
#pragma unroll
        for (int k = 0; k < kAheadRows; ++k)
          if (u[k] >= 0 && c < d) acc = __fadd_rn(acc, x[k]);
      }
    }
    if (c < d) store1(tab, row * d + c, acc, out_bf16);
  }
}

// A stream of the highest priority per device for the hot
// tiles, and the events that fork it from and join it to the caller's
// stream
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};
std::mutex side_mu;
Side sides[64];

cudaError_t side_of(int dev, Side** out) {
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(side_mu);
  Side& side = sides[dev];
  if (!side.stream) {
    int lo = 0, hi = 0;
    cudaError_t err = cudaDeviceGetStreamPriorityRange(&lo, &hi);
    if (err == cudaSuccess)
      err = cudaStreamCreateWithPriority(&side.stream, cudaStreamNonBlocking,
                                         hi);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&side.fork, cudaEventDisableTiming);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&side.join, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
  }
  *out = &side;
  return cudaSuccess;
}

int64_t hot_cap(int64_t n_positions, int max_hot_tiles) {
  return n_positions / (kShort + 1) * max_hot_tiles;
}

template <typename T, int n_tables>
int launch(const void* g0, const void* g1, const void* g2, void* out0,
           void* out1, void* out2, int64_t rows0, int64_t rows1,
           int64_t rows2, int d0, int d1, int d2, const void* perm,
           const void* offsets, int64_t n_positions, int out_bf16, int flags,
           int64_t cap, void* workspace, void* stream) {
  constexpr int n = Vec<T>::n;
  constexpr int kHotCols = kHotRowBytes / static_cast<int>(sizeof(T));
  const void* gs[3] = {g0, g1, g2};
  void* outs[3] = {out0, out1, out2};
  const int64_t rows[3] = {rows0, rows1, rows2};
  const int ds[3] = {d0, d1, d2};
  Tables tabs;
  tabs.seg0[0] = tabs.item0[0] = 0;
  int max_hot = 0;
  for (int t = 0; t < 3; ++t) {
    Table& tab = tabs.t[t];
    const bool used = t < n_tables;
    tab.g = gs[t];
    tab.out = outs[t];
    tab.rows = used ? rows[t] : 0;
    tab.d = used ? ds[t] : 0;
    tab.vec = (flags >> t) & 1;
    tab.out_vec = tab.vec && ((flags >> (3 + t)) & 1);
    const int cols = 32 * (tab.vec ? n : 1);
    tab.tiles = (tab.d + cols - 1) / cols;
    tab.hot_tiles = (tab.d + kHotCols - 1) / kHotCols;
    if (used && tab.hot_tiles > max_hot) max_hot = tab.hot_tiles;
    tabs.seg0[t + 1] = tabs.seg0[t] + tab.rows;
    tabs.item0[t + 1] =
        tabs.item0[t] + (tab.rows + kRun - 1) / kRun * tab.tiles;
  }
  if (tabs.seg0[3] == 0) return 0;
  if (cap < hot_cap(n_positions, max_hot))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* p = static_cast<const int64_t*>(perm);
  const int64_t* o = static_cast<const int64_t*>(offsets);
  const int64_t n_items = tabs.item0[3];
  cudaError_t err = cudaSuccess;
  Side* side = nullptr;
  if (cap > 0) {
    // the hot tiles the sort listed, on the side stream, concurrent with
    // the short items
    const int* plan = static_cast<const int*>(workspace);
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = side_of(dev, &side)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             scatter_hot_kernel<T, n_tables>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             kBarBytes + kRingBytes)) != cudaSuccess ||
        (err = cudaEventRecord(side->fork, s)) != cudaSuccess ||
        (err = cudaStreamWaitEvent(side->stream, side->fork, 0)) !=
            cudaSuccess)
      return static_cast<int>(err);
    const int64_t hot_grid = cap < sms ? cap : sms;
    scatter_hot_kernel<T, n_tables>
        <<<static_cast<unsigned>(hot_grid), kHotThreads,
           kBarBytes + kRingBytes, side->stream>>>(tabs, p, o, out_bf16, plan,
                                                   cap);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (n_items > 0) {
    scatter_short_kernel<T, n_tables>
        <<<static_cast<unsigned>((n_items + kWarps - 1) / kWarps), kThreads,
           kShortSmem, s>>>(tabs, p, o, out_bf16);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (side &&
      ((err = cudaEventRecord(side->join, side->stream)) != cudaSuccess ||
       (err = cudaStreamWaitEvent(s, side->join, 0)) != cudaSuccess))
    return static_cast<int>(err);
  return 0;
}

// the kernels take the table count as a constant: perm's flat positions
// are divided by it on every update row
template <typename T>
int launch_n(const void* g0, const void* g1, const void* g2, void* out0,
             void* out1, void* out2, int64_t rows0, int64_t rows1,
             int64_t rows2, int d0, int d1, int d2, int n_tables,
             const void* perm, const void* offsets, int64_t n_positions,
             int out_bf16, int flags, int64_t cap, void* workspace,
             void* stream) {
  switch (n_tables) {
    case 1:
      return launch<T, 1>(g0, g1, g2, out0, out1, out2, rows0, rows1, rows2,
                          d0, d1, d2, perm, offsets, n_positions, out_bf16,
                          flags, cap, workspace, stream);
    case 3:
      return launch<T, 3>(g0, g1, g2, out0, out1, out2, rows0, rows1, rows2,
                          d0, d1, d2, perm, offsets, n_positions, out_bf16,
                          flags, cap, workspace, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int n_tables>
int sort_n(const int* idx, const int64_t* rows, const int* hot_tiles,
           int64_t n_positions, int units, int unit, int digit_bits,
           int64_t* perm, int64_t* offsets, int* hist, int* local,
           int* range_sum, int* keys, int* plan, int64_t cap,
           cudaStream_t s) {
  Tables tabs;
  Sort a;
  tabs.seg0[0] = a.seg0[0] = 0;
  for (int t = 0; t < 3; ++t) {
    Table& tab = tabs.t[t];
    tab = Table{};
    tab.rows = t < n_tables ? rows[t] : 0;
    tab.hot_tiles = t < n_tables ? hot_tiles[t] : 0;
    tabs.seg0[t + 1] = a.seg0[t + 1] = tabs.seg0[t] + tab.rows;
  }
  const int64_t S = tabs.seg0[3];
  // one pass: a digit is the bucket; several: digit_bits of it a pass,
  // the low digits first
  int passes = 1;
  int64_t nb = S + 2;
  if (digit_bits > 0 && digit_bits <= 16) {
    int width = 0;
    while ((S + 1) >> width) ++width;  // bits of the largest bucket
    passes = (width + digit_bits - 1) / digit_bits;
    nb = int64_t{1} << digit_bits;
  }
  if (S + 2 >= (int64_t{1} << 31) || digit_bits < 0 || digit_bits > 16 ||
      (digit_bits > 0 && passes < 2) || nb > kMaxBuckets || units < 1 ||
      unit < 32 || unit > kSortUnit ||
      static_cast<int64_t>(units) * unit < n_positions ||
      static_cast<int64_t>(units - 1) * unit >=
          (n_positions > 0 ? n_positions : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  a.idx = idx;
  a.P = n_positions;
  a.S = static_cast<int>(S);
  a.nb = static_cast<int>(nb);
  a.mask = digit_bits > 0 ? a.nb - 1 : 0x7fffffff;
  a.unit = unit;
  a.ranges = (a.nb + kPrefixThreads - 1) / kPrefixThreads;
  const bool several = passes > 1;
  const int count_smem = (a.nb + 1) / 2 * 4;
  const int place_smem = (a.ranges + 3) / 4 * 16 +
                         (unit + 31) / 32 * 32 * 4 * (several ? 5 : 3) +
                         (a.nb * 2 + 15) / 16 * 16;
  int dev = 0, sms = 0;
  cudaError_t err = cudaSuccess;
  auto place = several ? sort_place_kernel<n_tables, true>
                       : sort_place_kernel<n_tables, false>;
  if ((err = cudaFuncSetAttribute(sort_count_kernel<n_tables>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  count_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(place,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  place_smem)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  // with one pass, blocks past the last unit only write their share of
  // offsets: up to a block per range of buckets, at most one wave of SMs
  const int writers = a.ranges < sms ? a.ranges : sms;
  const int place_grid = !several && writers > units ? writers : units;
  // several passes go through two pairs of (keys, order) in turn
  const int64_t stride = (n_positions + 3) / 4 * 4;
  for (int pass = 0; pass < passes; ++pass) {
    const bool last = pass == passes - 1;
    int* keys_in = keys + (pass + 1) % 2 * 2 * stride;
    int* keys_out = keys + pass % 2 * 2 * stride;
    a.shift = pass * digit_bits;
    a.keys = pass > 0 ? keys_in : nullptr;
    a.order = pass > 0 ? keys_in + stride : nullptr;
    Placed out{last ? perm : nullptr, last ? nullptr : keys_out + stride,
               several ? keys_out : nullptr, several ? nullptr : offsets};
    sort_count_kernel<n_tables><<<units, kCountThreads, count_smem, s>>>(
        a, hist, plan, pass == 0 ? cap : 0);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    sort_prefix_kernel<n_tables><<<a.ranges, kPrefixThreads, 0, s>>>(
        tabs, a, units, hist, local, range_sum, plan, several ? 0 : cap);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    place<<<place_grid, kPlaceThreads, place_smem, s>>>(a, local, range_sum,
                                                        hist, out);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (several) {
    const int* sorted = keys + (passes - 1) % 2 * 2 * stride;
    const int64_t grid = (S + 1 + kOffsetThreads - 1) / kOffsetThreads;
    sort_offsets_kernel<n_tables>
        <<<static_cast<unsigned>(grid), kOffsetThreads, 0, s>>>(
            tabs, sorted, n_positions, a.S, offsets, plan, cap);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int small_launch(const void* g, void* out, int64_t rows, int d,
                 const void* idx, int64_t n_updates, int out_bf16,
                 void* stream) {
  if (n_updates > kSmallMaxIds || n_updates < 0 || rows < 0 || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  Table tab{};
  tab.g = g;
  tab.out = out;
  tab.rows = rows;
  tab.d = d;
  const int64_t grid = (rows + kSmallWarps - 1) / kSmallWarps;
  if (grid >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  scatter_small_kernel<T>
      <<<static_cast<unsigned>(grid), 32 * kSmallWarps, 0,
         static_cast<cudaStream_t>(stream)>>>(
          tab, static_cast<const int*>(idx), static_cast<int>(n_updates),
          out_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The kernel's constants, for the wrapper's plan to check against:
// kShort, kHotRowBytes, kRun, kThreads, kUnroll, kSmallMaxIds, kMaxRanges,
// kSortUnit, kMaxBuckets.
void scatter_accum_config(int* out) {
  out[0] = kShort;
  out[1] = kHotRowBytes;
  out[2] = kRun;
  out[3] = kThreads;
  out[4] = kUnroll;
  out[5] = kSmallMaxIds;
  out[6] = kMaxRanges;
  out[7] = kSortUnit;
  out[8] = kMaxBuckets;
}

// The stable counting sort: idx int32 [n_positions] (flat [M, n_tables]
// row ids of tables of rows_t rows) -> perm int64 [n_positions] (positions
// u * n_tables + t stably sorted by table, then row), offsets int64
// [rows_0 + ... + rows_{n-1} + 1] (each row's segment of perm). Positions
// are cut into `units` units of `unit` (32 .. kSortUnit; the last unit
// non-empty). digit_bits 0: one pass over the S + 2 buckets (S = the rows'
// sum, at most kMaxBuckets - 2); else passes of 2**digit_bits digits
// (digit_bits <= 16), the low digits first, until every bit of S + 1 is
// sorted. Scratch int32: hist [units, buckets of a pass], local [buckets
// of a pass], range_sum [kMaxRanges], and with several passes keys
// [4 x n_positions rounded up to 4]. With cap > 0 it also lists the hot
// tiles (hot_t per row of table t) into plan int32 [1 + 2 * cap], for
// scatter_accum_*. Returns the cudaError_t of the launches.
int scatter_sort(const void* idx, int n_tables, int64_t rows0, int64_t rows1,
                 int64_t rows2, int hot0, int hot1, int hot2,
                 int64_t n_positions, int units, int unit, int digit_bits,
                 void* perm, void* offsets, void* hist, void* local,
                 void* range_sum, void* keys, void* plan, int64_t cap,
                 void* stream) {
  const int64_t rows[3] = {rows0, rows1, rows2};
  const int hot[3] = {hot0, hot1, hot2};
  const int* i = static_cast<const int*>(idx);
  int64_t* p = static_cast<int64_t*>(perm);
  int64_t* o = static_cast<int64_t*>(offsets);
  int* h = static_cast<int*>(hist);
  int* l = static_cast<int*>(local);
  int* r = static_cast<int*>(range_sum);
  int* k = static_cast<int*>(keys);
  int* pl = static_cast<int*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_tables) {
    case 1:
      return sort_n<1>(i, rows, hot, n_positions, units, unit, digit_bits, p,
                       o, h, l, r, k, pl, cap, s);
    case 3:
      return sort_n<3>(i, rows, hot, n_positions, units, unit, digit_bits, p,
                       o, h, l, r, k, pl, cap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The one-launch path for one table: g [n_updates, d] updates, idx int32
// [n_updates] row ids, out [rows, d] float32 (bfloat16 when out_bf16);
// n_updates <= kSmallMaxIds. Returns the cudaError_t of the launch.
int scatter_small_f32(const void* g, void* out, int64_t rows, int d,
                      const void* idx, int64_t n_updates, int out_bf16,
                      void* stream) {
  return small_launch<float>(g, out, rows, d, idx, n_updates, out_bf16,
                             stream);
}

int scatter_small_bf16(const void* g, void* out, int64_t rows, int d,
                       const void* idx, int64_t n_updates, int out_bf16,
                       void* stream) {
  return small_launch<__nv_bfloat16>(g, out, rows, d, idx, n_updates,
                                     out_bf16, stream);
}

// Device pointers of contiguous tensors: g_t [M, d_t] updates, out_t
// [rows_t, d_t] outputs (float32, or bfloat16 when out_bf16), perm int64
// [n_positions = M * n_tables] (flat positions u * n_tables + t, stably
// sorted by destination), offsets int64 [rows_0 + ... + rows_{n-1} + 1],
// workspace int32 [1 + 2 * cap]. flags: bit t set where table t's updates
// are whole 16-byte vectors on 16-byte boundaries, bit 3 + t where its
// output may be written in vectors. cap: hot tiles the workspace holds, at
// least n_positions / (kShort + 1) x the most hot tiles of a row; the
// workspace's plan is scatter_sort's list of the hot tiles for this cap.
// Unused table slots (t >= n_tables) are ignored. Returns the cudaError_t
// of the launches.
int scatter_accum_f32(const void* g0, const void* g1, const void* g2,
                      void* out0, void* out1, void* out2, int64_t rows0,
                      int64_t rows1, int64_t rows2, int d0, int d1, int d2,
                      int n_tables, const void* perm, const void* offsets,
                      int64_t n_positions, int out_bf16, int flags,
                      int64_t cap, void* workspace, void* stream) {
  return launch_n<float>(g0, g1, g2, out0, out1, out2, rows0, rows1, rows2,
                         d0, d1, d2, n_tables, perm, offsets, n_positions,
                         out_bf16, flags, cap, workspace, stream);
}

int scatter_accum_bf16(const void* g0, const void* g1, const void* g2,
                       void* out0, void* out1, void* out2, int64_t rows0,
                       int64_t rows1, int64_t rows2, int d0, int d1, int d2,
                       int n_tables, const void* perm, const void* offsets,
                       int64_t n_positions, int out_bf16, int flags,
                       int64_t cap, void* workspace, void* stream) {
  return launch_n<__nv_bfloat16>(g0, g1, g2, out0, out1, out2, rows0, rows1,
                                 rows2, d0, d1, d2, n_tables, perm, offsets,
                                 n_positions, out_bf16, flags, cap, workspace,
                                 stream);
}

}  // extern "C"
