// Triple-tier context pool and masked gather-sum, for the eval sweep.
//
//   fused_ctx_pool_triple:
//     out[m] = tanh(sum_r w[m,r] * fused[tidx[m,r]] * inv[m])
//     inv[m] = 1 / sum_r w[m,r]   (guard_zero: a zero divider becomes 1)
//   gather_masked_sum:
//     out[m] = sum_r w[m,r] * table[idx[m,r]]   (in the table's dtype)
//
// Replaces the Pallas TPU kernels of lirec_tpu/ops/gather_pool.py:
//   _make_triple_kernel (line 719, through _triple_pallas_call:787): one
//     gathered row of a batch-local FUSED [clip | tr1 | tr2] table per
//     context entry, where the 3-table kernel gathers three rows;
//   _make_kernel (line 106, gather_masked_sum): the same gather and
//     weighted sum over one table, without the divide and tanh.
// The TPU packed the bf16 fused rows two columns per int32 word because
// Mosaic cannot gather single 16-bit rows; Hopper loads bf16 rows, so the
// fused table is plain float or bfloat16 in natural column order.
//
// What bounds it: bytes. At the int_rel_ch eval shapes (B = 64, T = 20,
// R = 18: M = 1280 pooled rows of 1536 columns) the kernel gathers 23,040
// rows, 141.6 MB in f32 and 70.8 MB in bf16, the same as the 3-table
// kernel. But the rows come from a local table of U unique triples
// (U is a few thousand at B = 64: at most ~18 MB in f32), which fits in
// the 50 MB L2; device memory then sees the local table once, 7.9 MB of
// output and 0.2 MB of tidx and mask, a floor of a few microseconds. A
// gather out of L2 is issue- and latency-bound, not bytes-bound.
//
// Design (simple and exact first), the arithmetic of fused_ctx_pool.cu on
// the same values: one block per pooled row m stages its R indices and
// weights in shared memory; thread 0 sums the divider in r order; threads
// stride over the columns (neighbouring threads read neighbouring
// addresses of one row), each column one __fadd_rn(acc, __fmul_rn(w, x))
// chain in r order, then tanhf(__fmul_rn(acc, inv)). The _rn intrinsics
// keep nvcc from contracting into FMAs, so on the rows of the
// corresponding global index triples the triple kernel equals the 3-table
// kernel bit for bit.
//
// Indices are not range-checked here; they come from the host-side
// localisation (data/localize.localize_eval_ctx_triples), whose every id
// is below U by construction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Stage row m's R indices and weights; with want_inv, thread 0 also sums
// the divider in r order and stores 1/div.
__device__ __forceinline__ void stage(const int32_t* __restrict__ idx,
                                     const float* __restrict__ mask,
                                     int64_t m, int R, int32_t* s_idx,
                                     float* s_w, float* s_inv,
                                     bool want_inv, int guard_zero) {
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    s_idx[i] = idx[m * R + i];
    s_w[i] = mask[m * R + i];
  }
  __syncthreads();
  if (want_inv && threadIdx.x == 0) {
    float div = 0.f;
    for (int r = 0; r < R; ++r) div = __fadd_rn(div, s_w[r]);
    if (guard_zero && div == 0.f) div = 1.f;
    *s_inv = __fdiv_rn(1.f, div);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
triple_pool_kernel(const T* __restrict__ fused,
                   const int32_t* __restrict__ tidx,
                   const float* __restrict__ mask, float* __restrict__ out,
                   int R, int width, int guard_zero) {
  extern __shared__ int32_t smem[];
  int32_t* s_idx = smem;                                // [R]
  float* s_w = reinterpret_cast<float*>(smem + R);      // [R]
  float* s_inv = s_w + R;                               // [1]
  const int64_t m = blockIdx.x;
  stage(tidx, mask, m, R, s_idx, s_w, s_inv, true, guard_zero);
  const float inv = *s_inv;
  float* out_row = out + m * width;
  for (int col = threadIdx.x; col < width; col += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < R; ++r) {
      const int64_t row = s_idx[r];
      acc = __fadd_rn(acc, __fmul_rn(s_w[r], to_f32(fused[row * width + col])));
    }
    out_row[col] = tanhf(__fmul_rn(acc, inv));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_sum_kernel(const T* __restrict__ table,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ mask, T* __restrict__ out, int R,
                  int width) {
  extern __shared__ int32_t smem[];
  int32_t* s_idx = smem;                                // [R]
  float* s_w = reinterpret_cast<float*>(smem + R);      // [R]
  const int64_t m = blockIdx.x;
  stage(idx, mask, m, R, s_idx, s_w, nullptr, false, 0);
  T* out_row = out + m * width;
  for (int col = threadIdx.x; col < width; col += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < R; ++r) {
      const int64_t row = s_idx[r];
      acc = __fadd_rn(acc, __fmul_rn(s_w[r], to_f32(table[row * width + col])));
    }
    store(out_row + col, acc);
  }
}

size_t smem_bytes(int R) {
  return (2 * static_cast<size_t>(R) + 1) * sizeof(int32_t);
}

template <typename T>
int launch_triple(const void* fused, const void* tidx, const void* mask,
                  void* out, int M, int R, int width, int guard_zero,
                  void* stream) {
  triple_pool_kernel<T><<<M, kThreads, smem_bytes(R),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(fused), static_cast<const int32_t*>(tidx),
      static_cast<const float*>(mask), static_cast<float*>(out), R, width,
      guard_zero);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_masked_sum(const void* table, const void* idx, const void* mask,
                      void* out, int M, int R, int width, void* stream) {
  masked_sum_kernel<T><<<M, kThreads, smem_bytes(R),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(mask), static_cast<T*>(out), R, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pointers are device pointers of contiguous tensors: fused [U, width],
// tidx int32 [M, R], mask f32 [M, R], out f32 [M, width]. Returns the
// cudaError_t of the launch (0 = ok).
int fused_ctx_pool_triple_f32(const void* fused, const void* tidx,
                              const void* mask, void* out, int M, int R,
                              int width, int guard_zero, void* stream) {
  return launch_triple<float>(fused, tidx, mask, out, M, R, width,
                              guard_zero, stream);
}

int fused_ctx_pool_triple_bf16(const void* fused, const void* tidx,
                               const void* mask, void* out, int M, int R,
                               int width, int guard_zero, void* stream) {
  return launch_triple<__nv_bfloat16>(fused, tidx, mask, out, M, R, width,
                                      guard_zero, stream);
}

// table [N, width], idx int32 [M, R], mask f32 [M, R], out [M, width] in
// the table's dtype.
int gather_masked_sum_f32(const void* table, const void* idx,
                          const void* mask, void* out, int M, int R,
                          int width, void* stream) {
  return launch_masked_sum<float>(table, idx, mask, out, M, R, width, stream);
}

int gather_masked_sum_bf16(const void* table, const void* idx,
                           const void* mask, void* out, int M, int R,
                           int width, void* stream) {
  return launch_masked_sum<__nv_bfloat16>(table, idx, mask, out, M, R, width,
                                          stream);
}

}  // extern "C"
