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
// Why the arithmetic order is fixed: every output column is one chain
//   acc = __fadd_rn(acc, __fmul_rn(w_r, x_r))   for r = 0 .. R-1, from 0.f;
// the pool's divider is the __fadd_rn sum of the weights in r order, inv =
// __fdiv_rn(1, div), out = tanhf(__fmul_rn(acc, inv)): the operations of
// fused_ctx_pool.cu in the same order, so on the rows of the corresponding
// global index triples the triple kernel equals the 3-table kernel bit for
// bit (chip_smoke.py phases 3 and 9). The masked sum stores the same chain
// in the table's dtype (__float2bfloat16_rn for bf16), which is what an
// r-ordered loop of separate multiplies and adds gives.
//
// What bounds it. At the int_rel_ch eval shapes (B = 64, T = 20, R = 18:
// M = 1280 pooled rows of 1536 columns) the pool gathers 23,040 rows,
// 141.6 MB (f32) / 70.8 MB (bf16) pulled from L2 into the SMs, out of a
// local table of U ~ 3,000 rows that device memory sees once: the bytes
// bound counts those and the output, 8.0 / 5.2 us. The masked sum at the
// bf16 probe's shape ([512, 1024], M = 64) moves 0.3 us of bytes; it is
// held by the latency of its dependent loads and the launch. The first
// design (one 256-thread block per pooled row, thread 0 summing the
// divider between two barriers, one scalar 4-B / 2-B load per column and
// gathered row inside the dependent add chain, 64 blocks at M = 64) ran
// the pool at 24% / 15% of its bound (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md).
//
// Design (fused_ctx_pool.cu's, on one table):
// * 16-byte loads. A thread owns one "lane" of a pooled row: 4 f32 or 8
//   bf16 columns, read with one 16-B load per gathered row (a 1536-wide
//   row is 384 lanes in f32, 192 in bf16). bf16 pairs are widened by
//   shifts, exactly as __bfloat162float; outputs go out in 16-B stores.
// * Loads ahead of the chain: a thread issues the loads of kChunk
//   gathered rows before it adds any of them (R = 18 is three chunks).
// * A block takes rows_per_block pooled rows (at least two lanes per
//   thread) with their R indices and weights staged in shared memory
//   once, 8 bytes per entry; no serial thread and no second barrier:
//   each thread sums the divider itself from the staged weights, in r
//   order.
// * Column slabs where the rows are few: blockIdx.y takes slab_lanes
//   lanes of the block's rows, so that M = 64 pooled rows still spread
//   over every SM (ops/gather_pool.gather_plan chooses both numbers).
// * A table whose rows do not all start on 16-byte boundaries (a view off
//   an aligned base, or a row width in bytes not a multiple of 16) is read
//   by the same code with one column per lane and scalar loads; the
//   wrapper decides (ops/gather_pool.rows_aligned).
// Tried on the card and left out (tools/pool_variants.py; times in
// PERF.md section 6): 9, 12 or 18 rows ahead (more registers, fewer blocks
// resident; 18 ahead only wins at the bf16 probe's M = 64), three lanes
// per thread, registers capped by __launch_bounds__ (at 48 they spill)
// and 256 threads per block. The column slabs measure level with none at M = 64:
// the latency chain (launch, index staging, three chunks of gathered
// rows), not the SM count, holds that case.
//
// Indices are not range-checked here; they come from the host-side
// localisation (data/localize.localize_eval_ctx_triples), whose every id
// is below U by construction, or are validated by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 6;  // gathered rows loaded ahead of their adds

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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
         | (static_cast<uint32_t>(
                __bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// n values to o in 16-byte stores: a lane's output is 16-byte aligned
// whenever its table rows are (the wrapper allocates out, and a row of
// width columns is whole 16-byte vectors in f32 and in the table's dtype)
template <int n>
__device__ __forceinline__ void store_lane(float* o, const float (&v)[n]) {
#pragma unroll
  for (int e = 0; e < n; e += 4)
    *reinterpret_cast<float4*>(o + e) =
        make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
}
__device__ __forceinline__ void store_lane(__nv_bfloat16* o,
                                           const float (&v)[8]) {
  *reinterpret_cast<uint4*>(o) =
      make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                 bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
}

// The chains of one 16-byte lane: columns c .. c + n - 1 of `table`
template <typename T>
__device__ __forceinline__ void sum_vec(const T* __restrict__ table,
                                        int64_t ld, int c, const int32_t* ix,
                                        const float* w, int R,
                                        float (&acc)[Raw<T>::n]) {
  using V = typename Raw<T>::type;
  constexpr int n = Raw<T>::n;
#pragma unroll
  for (int e = 0; e < n; ++e) acc[e] = 0.f;
  for (int r0 = 0; r0 < R; r0 += kChunk) {
    const int k = R - r0 < kChunk ? R - r0 : kChunk;
    V x[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < k) x[j] = load16(table + ix[r0 + j] * ld + c);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < k) {
        const float wr = w[r0 + j];
#pragma unroll
        for (int e = 0; e < n; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(wr, elem(x[j], e)));
      }
  }
}

// The chain of one column c with scalar loads: rows not 16-B aligned
template <typename T>
__device__ __forceinline__ float sum_col(const T* __restrict__ table,
                                         int64_t ld, int c, const int32_t* ix,
                                         const float* w, int R) {
  float acc = 0.f;
  for (int r0 = 0; r0 < R; r0 += kChunk) {
    const int k = R - r0 < kChunk ? R - r0 : kChunk;
    float x[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < k) x[j] = to_f32(table[ix[r0 + j] * ld + c]);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < k) acc = __fadd_rn(acc, __fmul_rn(w[r0 + j], x[j]));
  }
  return acc;
}

// kPool: the triple pool (tanh of the mean, f32 out); else the masked sum
// (out in T). Block (x, y): pooled rows x * rows_per_block .. and lanes
// y * slab_lanes .. of each.
template <typename T, bool kPool>
__global__ void __launch_bounds__(kThreads)
gather_lanes_kernel(const T* __restrict__ table,
                    const int32_t* __restrict__ idx,
                    const float* __restrict__ mask, void* __restrict__ out,
                    int M, int R, int width, int guard_zero,
                    int rows_per_block, int slab_lanes, int vec) {
  using Out = typename std::conditional<kPool, float, T>::type;
  extern __shared__ int32_t smem[];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(
      M - m0 < rows_per_block ? M - m0 : rows_per_block);
  int32_t* s_idx = smem;                                          // [rows, R]
  float* s_w = reinterpret_cast<float*>(smem + rows_per_block * R);  // [rows, R]
  for (int i = threadIdx.x; i < rows * R; i += kThreads) {
    s_idx[i] = idx[m0 * R + i];
    s_w[i] = mask[m0 * R + i];
  }
  __syncthreads();

  constexpr int n = Raw<T>::n;
  const int lanes = vec ? width / n : width;
  const int lane0 = blockIdx.y * slab_lanes;
  const int slab = lanes - lane0 < slab_lanes ? lanes - lane0 : slab_lanes;
  for (int item = threadIdx.x; item < rows * slab; item += kThreads) {
    const int g = item / slab;
    const int lane = lane0 + item - g * slab;
    const float* w = s_w + g * R;
    const int32_t* ix = s_idx + g * R;
    float inv = 1.f;
    if constexpr (kPool) {
      float div = 0.f;
      for (int r = 0; r < R; ++r) div = __fadd_rn(div, w[r]);
      if (guard_zero && div == 0.f) div = 1.f;
      inv = __fdiv_rn(1.f, div);
    }
    Out* o = static_cast<Out*>(out) + (m0 + g) * width;
    if (vec) {
      float acc[n];
      sum_vec(table, width, lane * n, ix, w, R, acc);
      if constexpr (kPool) {
#pragma unroll
        for (int e = 0; e < n; ++e) acc[e] = tanhf(__fmul_rn(acc[e], inv));
      }
      store_lane(o + lane * n, acc);
    } else {
      const float acc = sum_col(table, width, lane, ix, w, R);
      if constexpr (kPool)
        o[lane] = tanhf(__fmul_rn(acc, inv));
      else
        store(o + lane, acc);
    }
  }
}

template <typename T, bool kPool>
int launch(const void* table, const void* idx, const void* mask, void* out,
           int M, int R, int width, int guard_zero, int rows_per_block,
           int slab_lanes, int vec, void* stream) {
  if (rows_per_block < 1 || slab_lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = vec ? width / Raw<T>::n : width;
  const dim3 grid(
      static_cast<unsigned>((static_cast<int64_t>(M) + rows_per_block - 1) /
                            rows_per_block),
      static_cast<unsigned>((lanes + slab_lanes - 1) / slab_lanes));
  const size_t smem = static_cast<size_t>(rows_per_block) * R * 8;
  gather_lanes_kernel<T, kPool><<<grid, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(mask), out, M, R, width, guard_zero,
      rows_per_block, slab_lanes, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pointers are device pointers of contiguous tensors: fused [U, width],
// tidx int32 [M, R], mask f32 [M, R], out f32 [M, width]. rows_per_block
// pooled rows per block (their R x 8 bytes of indices and weights in
// shared memory), slab_lanes lanes of them per block; vec: 1 where every
// row of the table starts on a 16-byte boundary, so it is read in 16-byte
// lanes. Returns the cudaError_t of the launch (0 = ok).
int fused_ctx_pool_triple_f32(const void* fused, const void* tidx,
                              const void* mask, void* out, int M, int R,
                              int width, int guard_zero, int rows_per_block,
                              int slab_lanes, int vec, void* stream) {
  return launch<float, true>(fused, tidx, mask, out, M, R, width, guard_zero,
                             rows_per_block, slab_lanes, vec, stream);
}

int fused_ctx_pool_triple_bf16(const void* fused, const void* tidx,
                               const void* mask, void* out, int M, int R,
                               int width, int guard_zero, int rows_per_block,
                               int slab_lanes, int vec, void* stream) {
  return launch<__nv_bfloat16, true>(fused, tidx, mask, out, M, R, width,
                                     guard_zero, rows_per_block, slab_lanes,
                                     vec, stream);
}

// table [N, width], idx int32 [M, R], mask f32 [M, R], out [M, width] in
// the table's dtype; the launch geometry as above.
int gather_masked_sum_f32(const void* table, const void* idx,
                          const void* mask, void* out, int M, int R,
                          int width, int rows_per_block, int slab_lanes,
                          int vec, void* stream) {
  return launch<float, false>(table, idx, mask, out, M, R, width, 0,
                              rows_per_block, slab_lanes, vec, stream);
}

int gather_masked_sum_bf16(const void* table, const void* idx,
                           const void* mask, void* out, int M, int R,
                           int width, int rows_per_block, int slab_lanes,
                           int vec, void* stream) {
  return launch<__nv_bfloat16, false>(table, idx, mask, out, M, R, width, 0,
                                      rows_per_block, slab_lanes, vec,
                                      stream);
}

}  // extern "C"
