// Packed-bf16 masked gather-sum.
//
//   out[m, j]          = sum_r w[m,r] * lo(packed[idx[m,r], j])
//   out[m, j + D/2]    = sum_r w[m,r] * hi(packed[idx[m,r], j])
//   lo(v) = bf16 bits v & 0xffff as f32,  hi(v) = bf16 bits v >> 16 as f32
//
// Replaces the Pallas TPU kernel tools/probe_bf16_pack.py:make_kernel, a
// probe: a bf16 table stored as int32 words, column d in the low half and
// column d + D/2 in the high half (ops/probes.pack_bf16), unpacked by shift
// / mask and a bitcast. On the TPU the layout let Mosaic gather single rows
// of a 16-bit table; on the card it asks whether 32-bit row loads of packed
// pairs beat native bf16 row loads (gather_masked_sum on the bf16 table).
//
// What bounds it: the bytes of the gathered rows (D/2 words of 4 bytes per
// referenced row) and of the f32 output; two multiply-adds per word and
// entry are far from any arithmetic limit.
//
// Design (simple and exact first, as csrc/fused_ctx_pool.cu): one block per
// output row m, the R indices and weights staged in shared memory, threads
// striding over the D/2 words so that neighbouring threads load
// neighbouring words of one gathered row (coalesced). Each thread keeps two
// f32 accumulators and adds w * value in r order with the _rn intrinsics
// (no contraction into FMAs), as the TPU kernel adds. Indices are not
// range-checked: callers keep them in [0, N).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
packed_gather_sum_kernel(const uint32_t* __restrict__ packed,
                         const int32_t* __restrict__ idx,
                         const float* __restrict__ mask,
                         float* __restrict__ out, int R, int d_half) {
  extern __shared__ int32_t smem[];
  int32_t* s_idx = smem;                              // [R]
  float* s_w = reinterpret_cast<float*>(smem + R);    // [R]

  const int64_t m = blockIdx.x;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    s_idx[i] = idx[m * R + i];
    s_w[i] = mask[m * R + i];
  }
  __syncthreads();

  float* out_row = out + m * 2 * static_cast<int64_t>(d_half);
  for (int j = threadIdx.x; j < d_half; j += blockDim.x) {
    float acc_lo = 0.f, acc_hi = 0.f;
    for (int r = 0; r < R; ++r) {
      const uint32_t v = packed[static_cast<int64_t>(s_idx[r]) * d_half + j];
      const float lo = __uint_as_float(v << 16);
      const float hi = __uint_as_float(v & 0xffff0000u);
      acc_lo = __fadd_rn(acc_lo, __fmul_rn(s_w[r], lo));
      acc_hi = __fadd_rn(acc_hi, __fmul_rn(s_w[r], hi));
    }
    out_row[j] = acc_lo;
    out_row[j + d_half] = acc_hi;
  }
}

}  // namespace

extern "C" {

// Pointers are device pointers of contiguous tensors: packed int32
// [N, d_half], idx int32 [M, R], mask f32 [M, R], out f32 [M, 2 * d_half].
// Returns the cudaError_t of the launch (0 = ok).
int packed_gather_sum(const void* packed, const void* idx, const void* mask,
                      void* out, int M, int R, int d_half, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(R) * sizeof(int32_t);
  packed_gather_sum_kernel<<<M, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(idx),
      static_cast<const float*>(mask), static_cast<float*>(out), R, d_half);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
