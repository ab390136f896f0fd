// Run pool: the fused context pool over contiguous runs of table rows.
//
//   out[m] = tanh([ sum_r w[m,r] * clip[s0 + r]
//                 | sum_r w[m,r] * tr1 [s1 + r]
//                 | sum_r w[m,r] * tr2 [s2 + r] ] * inv[m])
//   (s0, s1, s2) = idx[m, 0, :],   inv[m] = 1 / max(sum_r w[m,r], 1)
//
// Replaces the Pallas TPU kernel tools/probe_hbm_dma.py:_make_run_kernel,
// a probe: the same bytes as the per-row pool (csrc/fused_ctx_pool.cu), but
// read as one contiguous [R, d] run per (m, table) instead of R scattered
// rows. Numerically it is the pool of the explicit run indices
// idx_run[m, r, k] = idx[m, 0, k] + r; with 0/1 weights it gives bit for
// bit what fused_ctx_pool(guard_zero=True) gives on idx_run (the same
// products and sums in r order with the _rn intrinsics, the same tanhf),
// since max(div, 1) and the zero guard agree on integer dividers. The two
// differ for fractional weights whose sum is below 1.
//
// What bounds it: the bytes of the runs (R x (dc + 2 dt) x 4 bytes per
// pooled row, ~110 KB at R = 18 and 1536 columns), as for the per-row pool.
// The probe asks how much of the per-row kernel's distance from that bound
// is the cost of issuing R x 3 row loads per pooled row.
//
// Design: the Hopper counterpart of the TPU's one DMA per run is one bulk
// copy (cp.async.bulk, the Tensor Memory Accelerator's non-tensor form) per
// (m, table), global -> shared, completed on an mbarrier that expects the
// runs' byte count. One block per pooled row m; thread 0 issues the three
// copies, every thread then waits on the barrier and the threads stride
// over the 1536 output columns, summing each column from shared memory in
// r order (neighbouring threads read neighbouring words: no bank
// conflicts). Shared memory per block: R x (dc + 2 dt) x 4 bytes of runs
// (110,592 at the probe's shapes, two blocks per SM) plus the weights and
// the barrier, set as the launch's dynamic shared memory after raising the
// kernel's limit with cudaFuncSetAttribute. Bulk copies need 16-byte
// aligned addresses and sizes: the wrapper checks the tables' pointers and
// that dc and dt are multiples of 4. A run that leaves its table is not
// copied and its output segment is NaN (no fault, no silent value).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kHeader = 16;  // the mbarrier, padded to 16 bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Waits for the barrier's phase `parity` to complete. A copy that never
// lands (a fault in the copies' byte count) traps after ~4M polls, so a
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void barrier_wait(uint32_t bar, uint32_t parity) {
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

// shared bytes of one block: barrier, R weights (padded to 16), the runs
size_t smem_bytes(int R, int d_clip, int d_tr) {
  const size_t w = (static_cast<size_t>(R) * 4 + 15) / 16 * 16;
  return kHeader + w +
         static_cast<size_t>(R) * (d_clip + 2 * static_cast<size_t>(d_tr)) *
             sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
run_pool_kernel(const float* __restrict__ clip, const float* __restrict__ tr1,
                const float* __restrict__ tr2,
                const int32_t* __restrict__ idx,
                const float* __restrict__ mask, float* __restrict__ out,
                int R, int d_clip, int d_tr, int n_clip, int n_tr) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + kHeader);
  float* s_inv = reinterpret_cast<float*>(smem + 8);  // beside the barrier
  float* buf_clip = reinterpret_cast<float*>(
      smem + kHeader + (static_cast<size_t>(R) * 4 + 15) / 16 * 16);
  float* buf_tr1 = buf_clip + static_cast<size_t>(R) * d_clip;
  float* buf_tr2 = buf_tr1 + static_cast<size_t>(R) * d_tr;

  const int64_t m = blockIdx.x;
  const int32_t* start = idx + m * 3 * R;  // idx[m, 0, :]
  const int s0 = start[0], s1 = start[1], s2 = start[2];
  const bool ok0 = s0 >= 0 && s0 <= n_clip - R;
  const bool ok1 = s1 >= 0 && s1 <= n_tr - R;
  const bool ok2 = s2 >= 0 && s2 <= n_tr - R;
  const uint32_t b = smem_addr(bar);

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t clip_bytes = static_cast<uint32_t>(R) * d_clip * 4;
    const uint32_t tr_bytes = static_cast<uint32_t>(R) * d_tr * 4;
    const uint32_t expect = (ok0 ? clip_bytes : 0) + (ok1 ? tr_bytes : 0) +
                            (ok2 ? tr_bytes : 0);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(expect) : "memory");
    if (ok0)
      bulk_copy_g2s(buf_clip, clip + static_cast<int64_t>(s0) * d_clip,
                    clip_bytes, b);
    if (ok1)
      bulk_copy_g2s(buf_tr1, tr1 + static_cast<int64_t>(s1) * d_tr,
                    tr_bytes, b);
    if (ok2)
      bulk_copy_g2s(buf_tr2, tr2 + static_cast<int64_t>(s2) * d_tr,
                    tr_bytes, b);
  }
  // the weights and the divider load while the runs are in flight
  for (int i = threadIdx.x; i < R; i += blockDim.x) s_w[i] = mask[m * R + i];
  __syncthreads();  // the barrier is initialised, the weights are staged
  if (threadIdx.x == 0) {
    float div = 0.f;
    for (int r = 0; r < R; ++r) div = __fadd_rn(div, s_w[r]);
    *s_inv = __fdiv_rn(1.f, fmaxf(div, 1.f));
  }
  barrier_wait(b, 0);
  __syncthreads();  // s_inv
  const float inv = *s_inv;

  const int width = d_clip + 2 * d_tr;
  float* out_row = out + m * width;
  for (int col = threadIdx.x; col < width; col += blockDim.x) {
    const float* buf;
    int c, ld;
    bool ok;
    if (col < d_clip) {
      buf = buf_clip; c = col; ld = d_clip; ok = ok0;
    } else if (col < d_clip + d_tr) {
      buf = buf_tr1; c = col - d_clip; ld = d_tr; ok = ok1;
    } else {
      buf = buf_tr2; c = col - d_clip - d_tr; ld = d_tr; ok = ok2;
    }
    if (!ok) {
      out_row[col] = __int_as_float(0x7fc00000);  // NaN: run out of range
      continue;
    }
    float acc = 0.f;
    for (int r = 0; r < R; ++r)
      acc = __fadd_rn(acc, __fmul_rn(s_w[r], buf[r * ld + c]));
    out_row[col] = tanhf(__fmul_rn(acc, inv));
  }
}

}  // namespace

extern "C" {

// The shared bytes one block needs, and the card's opt-in limit per block
// (cudaDevAttrMaxSharedMemoryPerBlockOptin of `device`, or -1 on error).
long long probe_hbm_dma_smem_bytes(int R, int d_clip, int d_tr) {
  return static_cast<long long>(smem_bytes(R, d_clip, d_tr));
}

int probe_hbm_dma_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Pointers are device pointers of contiguous f32 tensors, 16-byte aligned:
// clip [n_clip, d_clip], tr1/tr2 [n_tr, d_tr], idx int32 [M, R, 3] (only
// idx[:, 0, :] is read), mask f32 [M, R], out f32 [M, d_clip + 2 * d_tr].
// Returns the cudaError_t of the attribute call or the launch (0 = ok).
int probe_hbm_dma_f32(const void* clip, const void* tr1, const void* tr2,
                      const void* idx, const void* mask, void* out, int M,
                      int R, int d_clip, int d_tr, int n_clip, int n_tr,
                      void* stream) {
  const size_t smem = smem_bytes(R, d_clip, d_tr);
  cudaError_t err = cudaFuncSetAttribute(
      run_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  run_pool_kernel<<<M, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(clip), static_cast<const float*>(tr1),
      static_cast<const float*>(tr2), static_cast<const int32_t*>(idx),
      static_cast<const float*>(mask), static_cast<float*>(out), R, d_clip,
      d_tr, n_clip, n_tr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
