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

// One lane of 16 bytes: columns c .. c + n - 1 of `table` (row stride ld)
template <typename T>
__device__ __forceinline__ void pool_vec(const T* __restrict__ table,
                                         int ld, int c,
                                         const int32_t* ix, int which,
                                         const float* w, int R, float inv,
                                         float* o) {
  using V = typename Raw<T>::type;
  constexpr int n = Raw<T>::n;
  float acc[n];
#pragma unroll
  for (int e = 0; e < n; ++e) acc[e] = 0.f;
  for (int r0 = 0; r0 < R; r0 += kChunk) {
    const int k = R - r0 < kChunk ? R - r0 : kChunk;
    V x[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < k)
        x[j] = load16(table + static_cast<int64_t>(ix[3 * (r0 + j) + which]) *
                                  ld + c);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < k) {
        const float wr = w[r0 + j];
#pragma unroll
        for (int e = 0; e < n; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(wr, elem(x[j], e)));
      }
  }
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

// One column c with scalar loads: tables whose rows are not 16-B aligned
template <typename T>
__device__ __forceinline__ void pool_col(const T* __restrict__ table, int ld,
                                         int c, const int32_t* ix, int which,
                                         const float* w, int R, float inv,
                                         float* o) {
  float acc = 0.f;
  for (int r0 = 0; r0 < R; r0 += kChunk) {
    const int k = R - r0 < kChunk ? R - r0 : kChunk;
    float x[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < k)
        x[j] = to_f32(table[static_cast<int64_t>(ix[3 * (r0 + j) + which]) *
                                ld + c]);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < k) acc = __fadd_rn(acc, __fmul_rn(w[r0 + j], x[j]));
  }
  *o = tanhf(__fmul_rn(acc, inv));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ctx_pool_kernel(const T* __restrict__ clip, const T* __restrict__ tr1,
                      const T* __restrict__ tr2,
                      const int32_t* __restrict__ idx,
                      const float* __restrict__ mask,
                      float* __restrict__ out, int M, int R, int d_clip,
                      int d_tr, int guard_zero, int rows_per_block,
                      int vec_clip, int vec_tr) {
  extern __shared__ int32_t smem[];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(
      M - m0 < rows_per_block ? M - m0 : rows_per_block);
  int32_t* s_idx = smem;                                        // [rows, R, 3]
  float* s_w = reinterpret_cast<float*>(smem + 3 * rows_per_block * R);
  for (int i = threadIdx.x; i < rows * 3 * R; i += kThreads)
    s_idx[i] = idx[m0 * 3 * R + i];
  for (int i = threadIdx.x; i < rows * R; i += kThreads)
    s_w[i] = mask[m0 * R + i];
  __syncthreads();

  constexpr int n = Raw<T>::n;
  const int n_clip = vec_clip ? d_clip / n : d_clip;  // lanes per table
  const int n_tr = vec_tr ? d_tr / n : d_tr;
  const int lanes = n_clip + 2 * n_tr;
  const int width = d_clip + 2 * d_tr;
  for (int item = threadIdx.x; item < rows * lanes; item += kThreads) {
    const int g = item / lanes;
    int lane = item - g * lanes;
    const float* w = s_w + g * R;
    const int32_t* ix = s_idx + g * 3 * R;
    float div = 0.f;
    for (int r = 0; r < R; ++r) div = __fadd_rn(div, w[r]);
    if (guard_zero && div == 0.f) div = 1.f;
    const float inv = __fdiv_rn(1.f, div);
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
    float* o = out + (m0 + g) * width + col0;
    if (vec)
      pool_vec(table, ld, lane * n, ix, which, w, R, inv, o + lane * n);
    else
      pool_col(table, ld, lane, ix, which, w, R, inv, o + lane);
  }
}

size_t smem_bytes(int R, int rows_per_block) {
  return static_cast<size_t>(rows_per_block) * R * 4 * sizeof(int32_t);
}

template <typename T>
int launch(const void* clip, const void* tr1, const void* tr2,
           const void* idx, const void* mask, void* out, int M, int R,
           int d_clip, int d_tr, int guard_zero, int rows_per_block,
           int vec_clip, int vec_tr, void* stream) {
  if (rows_per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((M + rows_per_block - 1) / rows_per_block);
  fused_ctx_pool_kernel<T><<<blocks, kThreads,
                             smem_bytes(R, rows_per_block),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(clip), static_cast<const T*>(tr1),
      static_cast<const T*>(tr2), static_cast<const int32_t*>(idx),
      static_cast<const float*>(mask), static_cast<float*>(out), M, R,
      d_clip, d_tr, guard_zero, rows_per_block, vec_clip, vec_tr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pointers are device pointers of contiguous tensors: clip [Nc, d_clip],
// tr1/tr2 [Nt, d_tr], idx int32 [M, R, 3], mask f32 [M, R], out f32
// [M, d_clip + 2 * d_tr]. rows_per_block pooled rows per block (their
// R x 16 bytes of indices and weights in shared memory); vec_clip /
// vec_tr: 1 where every row of that table (tr1 and tr2 both) starts on a
// 16-byte boundary, so it is read in 16-byte lanes. Returns the
// cudaError_t of the launch (0 = ok).
int fused_ctx_pool_f32(const void* clip, const void* tr1, const void* tr2,
                       const void* idx, const void* mask, void* out, int M,
                       int R, int d_clip, int d_tr, int guard_zero,
                       int rows_per_block, int vec_clip, int vec_tr,
                       void* stream) {
  return launch<float>(clip, tr1, tr2, idx, mask, out, M, R, d_clip, d_tr,
                       guard_zero, rows_per_block, vec_clip, vec_tr, stream);
}

int fused_ctx_pool_bf16(const void* clip, const void* tr1, const void* tr2,
                        const void* idx, const void* mask, void* out, int M,
                        int R, int d_clip, int d_tr, int guard_zero,
                        int rows_per_block, int vec_clip, int vec_tr,
                        void* stream) {
  return launch<__nv_bfloat16>(clip, tr1, tr2, idx, mask, out, M, R, d_clip,
                               d_tr, guard_zero, rows_per_block, vec_clip,
                               vec_tr, stream);
}

}  // extern "C"
