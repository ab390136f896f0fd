// Fused context pool for the eval forward of the mid-fusion models.
//
//   out[m] = tanh([ sum_r w[m,r] * clip[idx[m,r,0]]
//                 | sum_r w[m,r] * tr1 [idx[m,r,1]]
//                 | sum_r w[m,r] * tr2 [idx[m,r,2]] ] * inv[m])
//   inv[m] = 1 / sum_r w[m,r]   (guard_zero: a zero divider becomes 1)
//
// Replaces the Pallas TPU kernels of lirec_tpu/ops/gather_pool.py:
//   _make_fused_kernel        (f32 tables resident in VMEM)
//   _make_fused_packed_kernel (bf16 tables packed two columns per int32)
//   _make_fused_hbm_kernel    (tables left in HBM, per-row async DMA)
// On the GPU every table lives in device memory, so the three collapse into
// one kernel with two instantiations: float tables and native bfloat16
// tables. The packed-int32 layout only existed because Mosaic cannot gather
// single rows of a 16-bit VMEM array; here bf16 rows load directly.
//
// What bounds it: the bytes of the gathered rows. Each pooled row reads
// R rows of clip + tr1 + tr2 (18 x 1536 values, ~110 KB in f32, ~55 KB in
// bf16) and writes 1536 floats; there are no reuse or FLOPs to speak of.
// The only help is the L2 cache catching rows that repeat within a batch.
//
// Design (simple and exact first): one block per pooled row m. The block
// stages its R index triples and weights in shared memory and one thread
// sums the divider in r order, as the TPU kernel does. Threads then stride
// over the output columns, so neighbouring threads read neighbouring
// addresses of the same gathered row (coalesced), and each thread sums
// w_r * T[idx_r, col] in f32 in r order. Multiplies and adds are issued
// with the _rn intrinsics so that nvcc does not contract them into FMAs:
// the result then rounds like the plain PyTorch version. Ragged widths need
// no padding: the column loop stops at the row width.
//
// Indices are not range-checked here (the TPU path's XLA gather clamped
// them); callers validate them on the host before the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ctx_pool_kernel(const T* __restrict__ clip, const T* __restrict__ tr1,
                      const T* __restrict__ tr2,
                      const int32_t* __restrict__ idx,
                      const float* __restrict__ mask,
                      float* __restrict__ out, int R, int d_clip, int d_tr,
                      int guard_zero) {
  extern __shared__ int32_t smem[];
  int32_t* s_idx = smem;                                  // [R * 3]
  float* s_w = reinterpret_cast<float*>(smem + 3 * R);    // [R]
  float* s_inv = s_w + R;                                 // [1]

  const int64_t m = blockIdx.x;
  for (int i = threadIdx.x; i < 3 * R; i += blockDim.x)
    s_idx[i] = idx[m * 3 * R + i];
  for (int i = threadIdx.x; i < R; i += blockDim.x)
    s_w[i] = mask[m * R + i];
  __syncthreads();
  if (threadIdx.x == 0) {
    float div = 0.f;
    for (int r = 0; r < R; ++r) div = __fadd_rn(div, s_w[r]);
    if (guard_zero && div == 0.f) div = 1.f;
    *s_inv = __fdiv_rn(1.f, div);
  }
  __syncthreads();
  const float inv = *s_inv;

  const int width = d_clip + 2 * d_tr;
  float* out_row = out + m * width;
  for (int col = threadIdx.x; col < width; col += blockDim.x) {
    const T* table;
    int which, c, ld;
    if (col < d_clip) {
      table = clip; which = 0; c = col; ld = d_clip;
    } else if (col < d_clip + d_tr) {
      table = tr1; which = 1; c = col - d_clip; ld = d_tr;
    } else {
      table = tr2; which = 2; c = col - d_clip - d_tr; ld = d_tr;
    }
    float acc = 0.f;
    for (int r = 0; r < R; ++r) {
      const int64_t row = s_idx[3 * r + which];
      acc = __fadd_rn(acc, __fmul_rn(s_w[r], to_f32(table[row * ld + c])));
    }
    out_row[col] = tanhf(__fmul_rn(acc, inv));
  }
}

template <typename T>
int launch(const void* clip, const void* tr1, const void* tr2,
           const void* idx, const void* mask, void* out, int M, int R,
           int d_clip, int d_tr, int guard_zero, void* stream) {
  const size_t smem = (4 * static_cast<size_t>(R) + 1) * sizeof(int32_t);
  fused_ctx_pool_kernel<T><<<M, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(clip), static_cast<const T*>(tr1),
      static_cast<const T*>(tr2), static_cast<const int32_t*>(idx),
      static_cast<const float*>(mask), static_cast<float*>(out), R, d_clip,
      d_tr, guard_zero);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pointers are device pointers of contiguous tensors: clip [Nc, d_clip],
// tr1/tr2 [Nt, d_tr], idx int32 [M, R, 3], mask f32 [M, R], out f32
// [M, d_clip + 2 * d_tr]. Returns the cudaError_t of the launch (0 = ok).
int fused_ctx_pool_f32(const void* clip, const void* tr1, const void* tr2,
                       const void* idx, const void* mask, void* out, int M,
                       int R, int d_clip, int d_tr, int guard_zero,
                       void* stream) {
  return launch<float>(clip, tr1, tr2, idx, mask, out, M, R, d_clip, d_tr,
                       guard_zero, stream);
}

int fused_ctx_pool_bf16(const void* clip, const void* tr1, const void* tr2,
                        const void* idx, const void* mask, void* out, int M,
                        int R, int d_clip, int d_tr, int guard_zero,
                        void* stream) {
  return launch<__nv_bfloat16>(clip, tr1, tr2, idx, mask, out, M, R, d_clip,
                               d_tr, guard_zero, stream);
}

}  // extern "C"
