// Deterministic scatter-accumulate: the backward of the train path's h1
// gathers (ops/scatter_accum.gather_h1).
//
//   out_t[row] = sum over updates u with idx[u, t] == row, in the order of
//                u, of (float) g_t[u]          for each table t (<= 3)
//
// Replaces the Pallas TPU kernels of lirec_tpu/ops/scatter_accum.py:
//   _make_kernel3 (three tables, [N, R, d] updates)
//   _make_kernel  (three tables, updates flattened to [N * R, d])
//   _make_kernel1 (one table)
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
// Every output column of a row is one f32 chain of __fadd_rn over the
// row's updates in their original order (no contraction, no
// reassociation), so the result is bitwise the in-order sum of the plain
// version on the CPU. The chain is serial in the updates and parallel only
// in the columns, so the work is split by segment length:
//
// * row_kernel, one block per destination row of every table, in one
//   launch: a segment of at most kShort updates is summed by its block.
//   The block stages the segment's update rows in shared memory, then
//   threads stride over the columns (kVec per thread, neighbouring threads
//   on neighbouring addresses) and load kUnroll updates ahead of the adds.
//   A row no update touches is written as zeros, so the output needs no
//   clearing pass. A longer segment is only listed (an integer atomicAdd on
//   a counter: which block takes which long row changes from run to run,
//   the sums do not).
// * hot_kernel, over the listed rows x column tiles of kHotCols: one
//   block per (row, tile) stages kChunk update rows of its tile in shared
//   memory with all its threads (many loads in flight), and one thread per
//   column adds them in order, chunk after chunk, while the next chunk
//   loads (two buffers). The train batches
//   need it: every masked ctx slot points at row 0, which then collects a
//   quarter of all updates (6,543 of 23,040 at B = 64); one block alone
//   would sum that row for milliseconds.
//
// What bounds it: bytes. Every update row is read exactly once and every
// output row written once: at B = 64, T = 20, R = 18 that is 23,040 x 2048
// update values (94.4 MB in bf16, 188.7 MB in f32) and, at full split-scale
// tables, 12,288 x 1024 + 2 x 24,576 x 512 f32 outputs (151.0 MB).
//
// Memory safety does not depend on the ids: reads go through `perm`
// (positions < M) and writes through the block's own row. Ids out of a
// table's range land in another table's segments or in none; the callers
// check the ids on the host before the step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // row_kernel
constexpr int kVec = 8;        // columns per thread per pass: 1024 per pass
constexpr int kUnroll = 4;     // updates loaded ahead of their adds
constexpr int kShort = 128;    // longest segment row_kernel sums itself
constexpr int kHotThreads = 256;
constexpr int kHotCols = 16;   // columns per hot_kernel block
constexpr int kChunk = 256;    // update rows staged per hot_kernel round
constexpr int kHotBlocks = 16;  // hot_kernel blocks per column tile
constexpr int kRowsPerPass = kHotThreads / kHotCols;
constexpr int kPer = kChunk / kRowsPerPass;  // elements per thread per round

static_assert(kShort <= kThreads, "one perm load per thread");
static_assert(kChunk <= kHotThreads, "one perm load per thread");

struct Table {
  const void* g;  // [M, d] updates (T_in)
  void* out;      // [rows, d] output (float or bf16)
  int64_t rows;
  int d;
};

struct Tables {
  Table t[3];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// table and row of segment `seg`: segments are laid out table after table
__device__ __forceinline__ int locate(const Tables& tabs, int n_tables,
                                      int64_t seg, int64_t* row) {
  int t = 0;
  while (t + 1 < n_tables && seg >= tabs.t[t].rows) {
    seg -= tabs.t[t].rows;
    ++t;
  }
  *row = seg;
  return t;
}

__device__ __forceinline__ void store(const Table& tab, int64_t o, float v,
                                      int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(tab.out)[o] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(tab.out)[o] = v;
}

template <typename T_in>
__global__ void __launch_bounds__(kThreads)
row_kernel(Tables tabs, int n_tables, const int64_t* __restrict__ perm,
           const int64_t* __restrict__ offsets, int out_bf16,
           int* __restrict__ hot) {
  __shared__ int64_t src[kShort];  // the segment's update rows, in order
  const int64_t seg = blockIdx.x;
  int64_t row;
  const int t = locate(tabs, n_tables, seg, &row);
  const int64_t beg = offsets[seg];
  const int len = static_cast<int>(offsets[seg + 1] - beg);
  if (len > kShort) {
    if (threadIdx.x == 0) hot[1 + atomicAdd(hot, 1)] = static_cast<int>(seg);
    return;
  }
  // perm holds flat positions u * n_tables + t; u is the update row
  if (threadIdx.x < len) src[threadIdx.x] = perm[beg + threadIdx.x] / n_tables;
  __syncthreads();
  const T_in* g = static_cast<const T_in*>(tabs.t[t].g);
  const int d = tabs.t[t].d;

  for (int base = 0; base < d; base += kThreads * kVec) {
    float acc[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[v] = 0.f;
    int j = 0;
    for (; j + kUnroll <= len; j += kUnroll) {
      float x[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T_in* s = g + src[j + u] * d;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const int col = base + v * kThreads + threadIdx.x;
          x[u][v] = col < d ? to_f32(s[col]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[v] = __fadd_rn(acc[v], x[u][v]);
    }
    for (; j < len; ++j) {
      const T_in* s = g + src[j] * d;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int col = base + v * kThreads + threadIdx.x;
        if (col < d) acc[v] = __fadd_rn(acc[v], to_f32(s[col]));
      }
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int col = base + v * kThreads + threadIdx.x;
      if (col < d) store(tabs.t[t], row * d + col, acc[v], out_bf16);
    }
  }
}

// one chunk of a hot segment (n update rows, staged in src): this thread's
// kPer elements (rows row0, row0 + kRowsPerPass, ..., column col) as f32
template <typename T_in>
__device__ __forceinline__ void load_chunk(float (&x)[kPer], const T_in* g,
                                           const int64_t* src, int n,
                                           int row0, int col, int d) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = row0 + i * kRowsPerPass;
    x[i] = k < n && col < d ? to_f32(g[src[k] * d + col]) : 0.f;
  }
}

template <typename T_in>
__global__ void __launch_bounds__(kHotThreads)
hot_kernel(Tables tabs, int n_tables, const int64_t* __restrict__ perm,
           const int64_t* __restrict__ offsets, int out_bf16,
           const int* __restrict__ hot) {
  // double-buffered: chunk c + 1 is loaded, and the update rows of chunk
  // c + 2 looked up, while chunk c is summed
  __shared__ float tile[2][kChunk][kHotCols];  // 32 KB
  __shared__ int64_t src[2][kChunk];
  const int n_hot = hot[0];
  const int tid = threadIdx.x;
  const int row0 = tid / kHotCols;
  const int col0 = blockIdx.y * kHotCols;
  const int col = col0 + tid % kHotCols;
  for (int slot = blockIdx.x; slot < n_hot; slot += gridDim.x) {
    const int64_t seg = hot[1 + slot];
    int64_t row;
    const int t = locate(tabs, n_tables, seg, &row);
    const int d = tabs.t[t].d;
    if (col0 >= d) continue;  // the same for every thread of the block
    const T_in* g = static_cast<const T_in*>(tabs.t[t].g);
    const int64_t beg = offsets[seg];
    const int64_t len = offsets[seg + 1] - beg;
    const int n_chunks = static_cast<int>((len + kChunk - 1) / kChunk);
    auto rows_in = [&](int c) {
      const int64_t left = len - static_cast<int64_t>(c) * kChunk;
      return static_cast<int>(left < kChunk ? left : kChunk);
    };
    auto look_up = [&](int c, int b) {  // perm holds u * n_tables + t
      if (tid < rows_in(c))
        src[b][tid] = perm[beg + static_cast<int64_t>(c) * kChunk + tid] /
                      n_tables;
    };
    float x[kPer];
    auto stage = [&](int b) {
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        tile[b][row0 + i * kRowsPerPass][tid % kHotCols] = x[i];
    };
    look_up(0, 0);
    __syncthreads();
    load_chunk(x, g, src[0], rows_in(0), row0, col, d);
    if (n_chunks > 1) look_up(1, 1);
    stage(0);
    __syncthreads();
    float acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int b = c & 1;
      if (c + 1 < n_chunks)
        load_chunk(x, g, src[b ^ 1], rows_in(c + 1), row0, col, d);
      if (c + 2 < n_chunks) look_up(c + 2, b);
      if (tid < kHotCols) {
        const int n = rows_in(c);
        int k = 0;
        for (; k + 8 <= n; k += 8) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = tile[b][k + u][tid];
#pragma unroll
          for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, v[u]);
        }
        for (; k < n; ++k) acc = __fadd_rn(acc, tile[b][k][tid]);
      }
      if (c + 1 < n_chunks) stage(b ^ 1);
      __syncthreads();
    }
    if (tid < kHotCols && col < d)
      store(tabs.t[t], row * d + col, acc, out_bf16);
  }
}

template <typename T_in>
int launch(const void* g0, const void* g1, const void* g2, void* out0,
           void* out1, void* out2, int64_t rows0, int64_t rows1,
           int64_t rows2, int d0, int d1, int d2, int n_tables,
           const void* perm, const void* offsets, int out_bf16,
           void* workspace, void* stream) {
  Tables tabs;
  tabs.t[0] = Table{g0, out0, rows0, d0};
  tabs.t[1] = Table{g1, out1, rows1, d1};
  tabs.t[2] = Table{g2, out2, rows2, d2};
  int64_t blocks = 0;
  int max_d = 0;
  for (int t = 0; t < n_tables; ++t) {
    blocks += tabs.t[t].rows;
    if (tabs.t[t].d > max_d) max_d = tabs.t[t].d;
  }
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* hot = static_cast<int*>(workspace);
  cudaError_t err = cudaMemsetAsync(hot, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t* p = static_cast<const int64_t*>(perm);
  const int64_t* o = static_cast<const int64_t*>(offsets);
  row_kernel<T_in><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      tabs, n_tables, p, o, out_bf16, hot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(kHotBlocks, (max_d + kHotCols - 1) / kHotCols);
  hot_kernel<T_in><<<grid, kHotThreads, 0, s>>>(tabs, n_tables, p, o,
                                                out_bf16, hot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// int32 entries of the workspace a launch over `n_positions` (= M *
// n_tables) sorted update positions needs: a counter and the list of the
// rows whose segments are longer than kShort.
int64_t scatter_accum_workspace_ints(int64_t n_positions) {
  return 1 + n_positions / (kShort + 1);
}

// Device pointers of contiguous tensors: g_t [M, d_t] updates, out_t
// [rows_t, d_t] outputs (float32, or bfloat16 when out_bf16), perm int64
// [M * n_tables] (flat positions u * n_tables + t, stably sorted by
// destination), offsets int64 [rows_0 + ... + rows_{n-1} + 1], workspace
// int32 [scatter_accum_workspace_ints(M * n_tables)]. Unused table slots
// (t >= n_tables) are ignored. Returns the cudaError_t of the launches.
int scatter_accum_f32(const void* g0, const void* g1, const void* g2,
                      void* out0, void* out1, void* out2, int64_t rows0,
                      int64_t rows1, int64_t rows2, int d0, int d1, int d2,
                      int n_tables, const void* perm, const void* offsets,
                      int out_bf16, void* workspace, void* stream) {
  return launch<float>(g0, g1, g2, out0, out1, out2, rows0, rows1, rows2, d0,
                       d1, d2, n_tables, perm, offsets, out_bf16, workspace,
                       stream);
}

int scatter_accum_bf16(const void* g0, const void* g1, const void* g2,
                       void* out0, void* out1, void* out2, int64_t rows0,
                       int64_t rows1, int64_t rows2, int d0, int d1, int d2,
                       int n_tables, const void* perm, const void* offsets,
                       int out_bf16, void* workspace, void* stream) {
  return launch<__nv_bfloat16>(g0, g1, g2, out0, out1, out2, rows0, rows1,
                               rows2, d0, d1, d2, n_tables, perm, offsets,
                               out_bf16, workspace, stream);
}

}  // extern "C"
