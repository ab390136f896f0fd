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
// Design: a plan kernel, then two kernels at once on two streams.
// * scatter_plan_kernel, one block, alone on the caller's stream (a block
//   of 1024 threads finds no room beside the short items): lists the
//   (segment, column tile) pairs of every segment longer than kShort (the
//   hot tiles), and their count. It writes the count itself, so the
//   workspace needs no clearing.
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
// Memory safety does not depend on the ids: reads go through `perm`
// (positions < M) and writes through each item's own row. Ids out of a
// table's range land in another table's segments or in none; the callers
// check the ids on the host before the step.

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
constexpr int kPlanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kShort <= 32, "one update position per lane");
static_assert(kRun < 32, "a lane per segment start and the run's end");
static_assert((kSlots & (kSlots - 1)) == 0 && kAhead <= 32, "the lane ring");
static_assert(2 * kStages * 8 <= kBarBytes, "barrier space");
static_assert(kStageRows % kRowsPerPass == 0, "whole copy passes");
static_assert(kLag < kStages, "a stage is signalled before its reuse");
static_assert(kStageRows % kBatch == 0, "whole adder batches");

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

// plan[0] = number of hot tiles; plan[1 + h] their segments and
// plan[1 + cap + h] their tiles, in no particular order
template <int n_tables>
__global__ void __launch_bounds__(kPlanThreads)
scatter_plan_kernel(Tables tabs, const int64_t* __restrict__ offsets,
                    int* __restrict__ plan, int64_t cap) {
  constexpr int kAheadSeg = 8;  // segment lengths loaded before any is used
  __shared__ int count;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  const int64_t n_seg = tabs.seg0[n_tables];
  for (int64_t base = threadIdx.x; base < n_seg;
       base += static_cast<int64_t>(kPlanThreads) * kAheadSeg) {
    int64_t len[kAheadSeg];
#pragma unroll
    for (int u = 0; u < kAheadSeg; ++u) {
      const int64_t s = base + u * kPlanThreads;
      len[u] = s < n_seg ? offsets[s + 1] - offsets[s] : 0;
    }
#pragma unroll
    for (int u = 0; u < kAheadSeg; ++u) {
      if (len[u] <= kShort) continue;
      const int64_t s = base + u * kPlanThreads;
      int64_t row;
      const int n = tabs.t[locate(tabs, n_tables, s, &row)].hot_tiles;
      const int at = atomicAdd(&count, n);
      for (int k = 0; k < n; ++k) {
        plan[1 + at + k] = static_cast<int>(s);
        plan[1 + cap + at + k] = k;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) plan[0] = count;
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

// A stream of the highest priority per device for the plan and the hot
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
           int64_t rows2, int d0, int d1, int d2, const void* perm, const void* offsets, int64_t n_positions,
           int out_bf16, int flags, int64_t cap, void* workspace,
           void* stream) {
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
    // the plan alone (its block needs a whole SM's threads), then the hot
    // tiles on the side stream, concurrent with the short items
    int* plan = static_cast<int*>(workspace);
    scatter_plan_kernel<n_tables><<<1, kPlanThreads, 0, s>>>(tabs, o, plan,
                                                             cap);
    int dev = 0, sms = 0;
    if ((err = cudaGetLastError()) != cudaSuccess ||
        (err = cudaGetDevice(&dev)) != cudaSuccess ||
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

}  // namespace

extern "C" {

// The kernel's constants, for the wrapper's plan to check against:
// kShort, kHotRowBytes, kRun, kThreads, kUnroll.
void scatter_accum_config(int* out) {
  out[0] = kShort;
  out[1] = kHotRowBytes;
  out[2] = kRun;
  out[3] = kThreads;
  out[4] = kUnroll;
}

// Device pointers of contiguous tensors: g_t [M, d_t] updates, out_t
// [rows_t, d_t] outputs (float32, or bfloat16 when out_bf16), perm int64
// [n_positions = M * n_tables] (flat positions u * n_tables + t, stably
// sorted by destination), offsets int64 [rows_0 + ... + rows_{n-1} + 1],
// workspace int32 [1 + 2 * cap]. flags: bit t set where table t's updates
// are whole 16-byte vectors on 16-byte boundaries, bit 3 + t where its
// output may be written in vectors. cap: hot tiles the workspace holds, at
// least n_positions / (kShort + 1) x the most hot tiles of a row. Unused
// table slots (t >= n_tables) are ignored. Returns the cudaError_t of the
// launches.
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
