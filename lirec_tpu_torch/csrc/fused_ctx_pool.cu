// Fused context pool for the forward of the mid-fusion models (the eval
// sweep's 3-table pool and the serve path's).
//
//   out[m] = tanh([ sum_r w[m,r] * clip[idx[m,r,0]]
//                 | sum_r w[m,r] * tr1 [idx[m,r,1]]
//                 | sum_r w[m,r] * tr2 [idx[m,r,2]] ] * inv[m])
//   inv[m] = 1 / sum_r w[m,r]   (guard_zero: a zero divider becomes 1)
//
// Replaces the Pallas TPU kernels of lirec_tpu/ops/gather_pool.py:
//   _make_fused_kernel        (line 178, f32 tables resident in VMEM)
//   _make_fused_packed_kernel (line 218, bf16 tables packed two columns
//                              per int32)
//   _make_fused_hbm_kernel    (line 334, tables left in HBM, per-row DMA)
// On the GPU every table lives in device memory, so the three are one
// kernel with two instantiations: float tables and native bfloat16 tables.
// The packed-int32 layout only existed because Mosaic cannot gather single
// rows of a 16-bit VMEM array; here bf16 rows load directly.
//
// Why the arithmetic order is fixed: every output column is one chain
//   acc = __fadd_rn(acc, __fmul_rn(w_r, x_r))   for r = 0 .. R-1, from 0.f,
// the divider is the __fadd_rn sum of the weights in r order, inv =
// __fdiv_rn(1, div), out = tanhf(__fmul_rn(acc, inv)). The _rn intrinsics
// keep nvcc from contracting into FMAs. The triple-tier kernel
// (fused_ctx_pool_triple.cu) and the run-pool probe (probe_hbm_dma.cu) do
// the same operations in the same order, and chip_smoke.py holds them, and
// the eval sweep's three localisation tiers, to this kernel bit for bit.
//
// What bounds it on this card. At the eval sweep's shapes (B = 64, T = 20,
// R = 18: M = 1280 pooled rows of 1024 + 2 x 256 columns) a structured
// batch references about 2,800 distinct rows of each table, so HBM sees
// ~25 MB (f32) / ~17 MB (bf16) and the bytes bound is 5-8 us. But every
// pooled row gathers its own 18 x 3 rows: 23,040 gathered row-triples,
// 141.6 MB (f32) / 70.8 MB (bf16) pulled from L2 into the SMs. The first
// design (one 256-thread block per pooled row, thread 0 summing the
// divider between two barriers, scalar 4-B / 2-B loads behind one
// dependent add chain) issued one load instruction per column and gathered
// row and kept few of them in flight: 0.040 / 0.039 ms, 19% / 13% of the
// bound (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Design:
// * 16-byte loads. A thread owns one "lane" of a pooled row: 4 f32 or 8
//   bf16 columns of one table, read with one 16-B load per gathered row
//   (a 1536-wide row is 384 lanes in f32, 192 in bf16). bf16 pairs are
//   widened by shifts, exactly as __bfloat162float.
// * Loads ahead of the chain. A thread issues the loads of kChunk gathered
//   rows before it adds any of them (R = 18 is two chunks), so each lane
//   keeps kChunk x 16 B in flight instead of one scalar.
// * Several pooled rows per block (rows_per_block, chosen by the wrapper
//   so that a block has about three lanes per thread), their index triples
//   and weights staged in shared memory once.
// * No serial thread and no second barrier: each thread sums the divider
//   itself from the staged weights, in r order.
// * Any R: past ops/gather_pool.CONTEXT_CHUNK (2,048) entries the context
//   is staged a chunk at a time (32 KB of one row's indices and weights),
//   so shared memory stays within 48 KB however long a row's context is.
//   The plan then takes the one-table kernels' geometry (one pooled row a
//   block, its lanes cut into column slabs of at most kThreads over
//   blockIdx.y), so each thread carries one lane's chains and the divider
//   in registers from chunk to chunk. Every chain still runs in r order
//   from 0.f, so the result is bitwise the one-pass kernel's (and the
//   triple kernel's) on the same rows. At R <= 2,048 the one-pass
//   instantiation runs, unchanged.
// * A table whose rows do not all start on 16-byte boundaries (a view off
//   an aligned base, or a row width in bytes not a multiple of 16) is read
//   by the same code with one column per lane and scalar loads; the
//   wrapper decides per table (ops/gather_pool.pool_plan).
// Tried on the card and left out (PERF.md): up to 40 pooled rows per
// block, with the row cut into up to 16 column slabs so that one sample's
// pooled rows could share their gathered rows in L1, never beat one (f32)
// or two (bf16) rows per block; nor did loading 6 or 18 rows ahead.
//
// Indices are not range-checked here (the TPU path's XLA gather clamped
// them); callers validate them on the host before the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 9;  // gathered rows loaded ahead of their adds

// 16 bytes of a row: the raw vector and its values as f32
__device__ __forceinline__ float4 load16(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ float elem(const uint4& v, int e) {
  const uint32_t w = (e >> 1) == 0 ? v.x : (e >> 1) == 1 ? v.y
                   : (e >> 1) == 2 ? v.z : v.w;
  // bf16 -> f32 is the 16 bits on top of a zero mantissa tail
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
struct Raw {  // one 16-byte load of T values
  using type = uint4;
  static constexpr int n = 8;
};
template <>
struct Raw<float> {
  using type = float4;
  static constexpr int n = 4;
};

// One lane of 16 bytes: columns c .. c + n - 1 of `table` (row stride ld).
// Adds the k staged entries of a chunk to the lane's n chains in acc, in r
// order.
template <typename T>
__device__ __forceinline__ void chain_vec(const T* __restrict__ table,
                                          int ld, int c, const int32_t* ix,
                                          int which, const float* w, int k,
                                          float* acc) {
  using V = typename Raw<T>::type;
  constexpr int n = Raw<T>::n;
  for (int r0 = 0; r0 < k; r0 += kChunk) {
    const int a = k - r0 < kChunk ? k - r0 : kChunk;
    V x[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < a)
        x[j] = load16(table + static_cast<int64_t>(ix[3 * (r0 + j) + which]) *
                                  ld + c);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < a) {
        const float wr = w[r0 + j];
#pragma unroll
        for (int e = 0; e < n; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(wr, elem(x[j], e)));
      }
  }
}

// One column c with scalar loads: tables whose rows are not 16-B aligned
template <typename T>
__device__ __forceinline__ void chain_col(const T* __restrict__ table,
                                          int ld, int c, const int32_t* ix,
                                          int which, const float* w, int k,
                                          float* acc) {
  float a0 = *acc;
  for (int r0 = 0; r0 < k; r0 += kChunk) {
    const int a = k - r0 < kChunk ? k - r0 : kChunk;
    float x[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < a)
        x[j] = to_f32(table[static_cast<int64_t>(ix[3 * (r0 + j) + which]) *
                                ld + c]);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < a) a0 = __fadd_rn(a0, __fmul_rn(w[r0 + j], x[j]));
  }
  *acc = a0;
}

// tanh(acc * inv) of a lane's n columns to o (16-byte stores where o is on
// a 16-byte boundary)
template <int n>
__device__ __forceinline__ void store_tanh(float* o, const float* acc,
                                           float inv) {
  float res[n];
#pragma unroll
  for (int e = 0; e < n; ++e) res[e] = tanhf(__fmul_rn(acc[e], inv));
  if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
#pragma unroll
    for (int e = 0; e < n; e += 4)
      *reinterpret_cast<float4*>(o + e) =
          make_float4(res[e], res[e + 1], res[e + 2], res[e + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < n; ++e) o[e] = res[e];
  }
}

// Block (x, y): pooled rows x * rows_per_block .. and lanes y * slab_lanes
// .. of each; an item is one lane of one pooled row. kChunked = false: the
// block stages its rows' whole context at once (chunk == R) and each item
// sums its chains and its row's divider in one pass. kChunked = true (R >
// chunk): the block stages the context a chunk at a time, and the plan
// gives it one pooled row and at most kThreads lanes, so a thread holds
// one item and carries its chains and divider in registers from chunk to
// chunk. Every sum runs in r order from 0.f either way: the same
// operations in the same order.
template <typename T, bool kChunked>
__global__ void __launch_bounds__(kThreads)
fused_ctx_pool_kernel(const T* __restrict__ clip, const T* __restrict__ tr1,
                      const T* __restrict__ tr2,
                      const int32_t* __restrict__ idx,
                      const float* __restrict__ mask,
                      float* __restrict__ out, int M, int R, int chunk,
                      int d_clip, int d_tr, int guard_zero,
                      int rows_per_block, int slab_lanes, int vec_clip,
                      int vec_tr) {
  extern __shared__ int32_t smem[];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(
      M - m0 < rows_per_block ? M - m0 : rows_per_block);
  const int step = kChunked ? chunk : R;  // entries staged at once
  int32_t* s_idx = smem;                                    // [rows, step, 3]
  float* s_w = reinterpret_cast<float*>(smem + 3 * rows_per_block * step);

  constexpr int n = Raw<T>::n;
  const int n_clip = vec_clip ? d_clip / n : d_clip;  // lanes per table
  const int n_tr = vec_tr ? d_tr / n : d_tr;
  const int lanes = n_clip + 2 * n_tr;
  const int width = d_clip + 2 * d_tr;
  const int lane0 = blockIdx.y * slab_lanes;
  const int slab = lanes - lane0 < slab_lanes ? lanes - lane0 : slab_lanes;
  float acc[n];
  float div = 0.f;
  for (int c0 = 0; c0 < R; c0 += step) {
    const int k = R - c0 < step ? R - c0 : step;
    const bool first = !kChunked || c0 == 0;
    const bool last = !kChunked || c0 + k == R;
    if (!first) __syncthreads();  // the previous chunk is done with
    // one chunk, or one row: the staged entries are contiguous in idx/mask
    for (int i = threadIdx.x; i < rows * 3 * k; i += kThreads)
      s_idx[i] = idx[(m0 * R + c0) * 3 + i];
    for (int i = threadIdx.x; i < rows * k; i += kThreads)
      s_w[i] = mask[m0 * R + c0 + i];
    __syncthreads();

    for (int item = threadIdx.x; item < rows * slab; item += kThreads) {
      const int g = item / slab;
      int lane = lane0 + item - g * slab;
      const float* w = s_w + g * k;
      const int32_t* ix = s_idx + g * 3 * k;
      if (first) {
#pragma unroll
        for (int e = 0; e < n; ++e) acc[e] = 0.f;
        div = 0.f;
      }
      for (int r = 0; r < k; ++r) div = __fadd_rn(div, w[r]);
      const T* table;
      int which, ld, vec, col0;
      if (lane < n_clip) {
        table = clip; which = 0; ld = d_clip; vec = vec_clip; col0 = 0;
      } else {
        lane -= n_clip;
        which = lane < n_tr ? 1 : 2;
        if (which == 2) lane -= n_tr;
        table = which == 1 ? tr1 : tr2;
        ld = d_tr; vec = vec_tr; col0 = d_clip + (which - 1) * d_tr;
      }
      if (vec)
        chain_vec(table, ld, lane * n, ix, which, w, k, acc);
      else
        chain_col(table, ld, lane, ix, which, w, k, acc);
      if (last) {
        const float inv =
            __fdiv_rn(1.f, guard_zero && div == 0.f ? 1.f : div);
        float* o = out + (m0 + g) * width + col0;
        if (vec)
          store_tanh<n>(o + lane * n, acc, inv);
        else
          o[lane] = tanhf(__fmul_rn(acc[0], inv));
      }
    }
  }
}

template <typename T>
int launch(const void* clip, const void* tr1, const void* tr2,
           const void* idx, const void* mask, void* out, int M, int R,
           int chunk, int d_clip, int d_tr, int guard_zero,
           int rows_per_block, int slab_lanes, int vec_clip, int vec_tr,
           void* stream) {
  constexpr int n = Raw<T>::n;
  const int lanes =
      (vec_clip ? d_clip / n : d_clip) + 2 * (vec_tr ? d_tr / n : d_tr);
  const bool chunked = R > chunk;
  if (rows_per_block < 1 || slab_lanes < 1 || chunk < 1 || chunk > R ||
      (chunked && (rows_per_block != 1 || slab_lanes > kThreads)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(
      static_cast<unsigned>((static_cast<int64_t>(M) + rows_per_block - 1) /
                            rows_per_block),
      static_cast<unsigned>((lanes + slab_lanes - 1) / slab_lanes));
  // a chunk's index triples and weights of each pooled row, 16 B an entry
  const size_t smem = static_cast<size_t>(rows_per_block) * chunk * 16;
  auto kernel = chunked ? fused_ctx_pool_kernel<T, true>
                        : fused_ctx_pool_kernel<T, false>;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(clip), static_cast<const T*>(tr1),
      static_cast<const T*>(tr2), static_cast<const int32_t*>(idx),
      static_cast<const float*>(mask), static_cast<float*>(out), M, R, chunk,
      d_clip, d_tr, guard_zero, rows_per_block, slab_lanes, vec_clip,
      vec_tr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pointers are device pointers of contiguous tensors: clip [Nc, d_clip],
// tr1/tr2 [Nt, d_tr], idx int32 [M, R, 3], mask f32 [M, R], out f32
// [M, d_clip + 2 * d_tr]. The context is staged `chunk` entries at a time
// (1 <= chunk <= R; 16 bytes an entry of each of the block's pooled rows
// in shared memory); rows_per_block pooled rows per block and slab_lanes
// lanes of them (past one chunk: one row, at most 128 lanes); vec_clip /
// vec_tr: 1 where every row of that table (tr1 and tr2 both) starts on a
// 16-byte boundary, so it is read in 16-byte lanes. Returns the
// cudaError_t of the launch (0 = ok).
int fused_ctx_pool_f32(const void* clip, const void* tr1, const void* tr2,
                       const void* idx, const void* mask, void* out, int M,
                       int R, int chunk, int d_clip, int d_tr,
                       int guard_zero, int rows_per_block, int slab_lanes,
                       int vec_clip, int vec_tr, void* stream) {
  return launch<float>(clip, tr1, tr2, idx, mask, out, M, R, chunk, d_clip,
                       d_tr, guard_zero, rows_per_block, slab_lanes,
                       vec_clip, vec_tr, stream);
}

int fused_ctx_pool_bf16(const void* clip, const void* tr1, const void* tr2,
                        const void* idx, const void* mask, void* out, int M,
                        int R, int chunk, int d_clip, int d_tr,
                        int guard_zero, int rows_per_block, int slab_lanes,
                        int vec_clip, int vec_tr, void* stream) {
  return launch<__nv_bfloat16>(clip, tr1, tr2, idx, mask, out, M, R, chunk,
                               d_clip, d_tr, guard_zero, rows_per_block,
                               slab_lanes, vec_clip, vec_tr, stream);
}

}  // extern "C"
