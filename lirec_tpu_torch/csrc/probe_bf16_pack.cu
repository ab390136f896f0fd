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
// of a 16-bit table; on the card it asks whether packed words pay against
// native bf16 rows (gather_masked_sum on the bf16 table, kernel 5) when
// both load 16-byte lanes.
//
// Why the arithmetic order is fixed: every output column is one chain
//   acc = __fadd_rn(acc, __fmul_rn(w_r, x_r))   for r = 0 .. R-1, from 0.f,
// stored in f32: what an r-ordered loop of separate multiplies and adds
// over unpack_bf16(packed).float() gives, bit for bit (chip_smoke.py phase
// 11), and what the first design of this kernel computed.
//
// What bounds it. At the clip table's shape ([12,288, 1024], M = 1280,
// R = 18) the bytes of the distinct gathered rows and the f32 output, 8.0
// us; every output row gathers its own 18 rows, 47 MB pulled from L2 into
// the SMs. At the TPU probe's shape ([512, 1024], M = 64) the bytes take
// 0.4 us and the call is held by the latency of its dependent loads and
// the launch. The first design (one 256-thread block per output row: 64
// blocks at M = 64; the indices and weights staged through a barrier; one
// 4-byte load per word and gathered row inside the dependent add chain)
// took 0.0130 / 0.0265 ms, 3% / 30% of the bound (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).
//
// Design (csrc/fused_ctx_pool_triple.cu's one-table design, on packed
// words):
// * 16-byte lanes. A thread owns a lane of 4 packed words: the low-half
//   columns j .. j+3 and the high-half columns D/2 + j .. D/2 + j+3, read
//   with one 16-B load per gathered row, widened by shift and mask, and
//   stored as two 16-B vectors of f32.
// * Loads ahead of the chain: a thread issues the loads of kChunk gathered
//   rows before it adds any of them (R = 18 is three chunks).
// * A block takes rows_per_block output rows with their R indices and
//   weights staged in shared memory once, 8 bytes per entry, one barrier,
//   no serial thread; where the rows are few (M = 64), blockIdx.y takes a
//   column slab of slab_lanes lanes so that every SM gets a block
//   (ops/gather_pool.gather_plan on the packed width, elem_size 4).
// * A table whose rows do not all start on 16-byte boundaries (D/2 not a
//   multiple of 4, or a view off an aligned base) is read by the same code
//   with one word per lane and scalar loads; the wrapper decides
//   (ops/gather_pool.rows_aligned).
// Measured (PERF.md section 6): 0.0129 -> 0.0087-0.0089 ms at the
// probe's shape and 0.0264 -> 0.0196-0.0200 ms at the clip table's, level
// with kernel 5 on the native bf16 table (0.0086-0.0088 / 0.0194-0.0195):
// at equal load width the packed layout buys nothing on this card.
// Left out: the load depth, threads per block and lanes per thread are
// kernel 5's, whose alternatives were measured with kernels 4-5's redesign
// (CHANGES.md; kernel 5's rows in PERF.md section 6); kernel 10 was not
// varied apart from them.
//
// Indices are not range-checked: callers keep them in [0, N).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // ops/gather_pool.POOL_THREADS
constexpr int kChunk = 6;      // gathered rows loaded ahead of their adds

__device__ __forceinline__ float lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ uint32_t word(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The 8 chains of one 16-byte lane: words c .. c + 3 of each gathered row
__device__ __forceinline__ void sum_vec(const uint32_t* __restrict__ packed,
                                        int64_t ld, int c, const int32_t* ix,
                                        const float* w, int R,
                                        float (&acc_lo)[4],
                                        float (&acc_hi)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc_lo[e] = acc_hi[e] = 0.f;
  for (int r0 = 0; r0 < R; r0 += kChunk) {
    const int k = R - r0 < kChunk ? R - r0 : kChunk;
    uint4 x[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < k)
        x[j] = __ldg(reinterpret_cast<const uint4*>(packed + ix[r0 + j] * ld +
                                                    c));
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < k) {
        const float wr = w[r0 + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t v = word(x[j], e);
          acc_lo[e] = __fadd_rn(acc_lo[e], __fmul_rn(wr, lo(v)));
          acc_hi[e] = __fadd_rn(acc_hi[e], __fmul_rn(wr, hi(v)));
        }
      }
  }
}

// The 2 chains of one word c with scalar loads: rows not 16-B aligned
__device__ __forceinline__ void sum_word(const uint32_t* __restrict__ packed,
                                         int64_t ld, int c, const int32_t* ix,
                                         const float* w, int R, float* acc_lo,
                                         float* acc_hi) {
  float a = 0.f, b = 0.f;
  for (int r0 = 0; r0 < R; r0 += kChunk) {
    const int k = R - r0 < kChunk ? R - r0 : kChunk;
    uint32_t x[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < k) x[j] = __ldg(packed + ix[r0 + j] * ld + c);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < k) {
        a = __fadd_rn(a, __fmul_rn(w[r0 + j], lo(x[j])));
        b = __fadd_rn(b, __fmul_rn(w[r0 + j], hi(x[j])));
      }
  }
  *acc_lo = a;
  *acc_hi = b;
}

// Block (x, y): output rows x * rows_per_block .. and lanes y * slab_lanes
// .. of each; a lane is 4 words where vec, else one.
__global__ void __launch_bounds__(kThreads)
packed_gather_sum_kernel(const uint32_t* __restrict__ packed,
                         const int32_t* __restrict__ idx,
                         const float* __restrict__ mask,
                         float* __restrict__ out, int M, int R, int d_half,
                         int rows_per_block, int slab_lanes, int vec) {
  extern __shared__ int32_t smem[];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(
      M - m0 < rows_per_block ? M - m0 : rows_per_block);
  int32_t* s_idx = smem;                                             // [rows, R]
  float* s_w = reinterpret_cast<float*>(smem + rows_per_block * R);  // [rows, R]
  for (int i = threadIdx.x; i < rows * R; i += kThreads) {
    s_idx[i] = idx[m0 * R + i];
    s_w[i] = mask[m0 * R + i];
  }
  __syncthreads();

  const int lanes = vec ? d_half / 4 : d_half;
  const int lane0 = blockIdx.y * slab_lanes;
  const int slab = lanes - lane0 < slab_lanes ? lanes - lane0 : slab_lanes;
  for (int item = threadIdx.x; item < rows * slab; item += kThreads) {
    const int g = item / slab;
    const int lane = lane0 + item - g * slab;
    const float* w = s_w + g * R;
    const int32_t* ix = s_idx + g * R;
    float* o = out + (m0 + g) * 2 * static_cast<int64_t>(d_half);
    if (vec) {
      float acc_lo[4], acc_hi[4];
      const int c = lane * 4;
      sum_vec(packed, d_half, c, ix, w, R, acc_lo, acc_hi);
      // 16-byte aligned: d_half and c are multiples of 4, out is allocated
      *reinterpret_cast<float4*>(o + c) =
          make_float4(acc_lo[0], acc_lo[1], acc_lo[2], acc_lo[3]);
      *reinterpret_cast<float4*>(o + d_half + c) =
          make_float4(acc_hi[0], acc_hi[1], acc_hi[2], acc_hi[3]);
    } else {
      sum_word(packed, d_half, lane, ix, w, R, o + lane, o + d_half + lane);
    }
  }
}

}  // namespace

extern "C" {

// Pointers are device pointers of contiguous tensors: packed int32
// [N, d_half], idx int32 [M, R], mask f32 [M, R], out f32 [M, 2 * d_half].
// rows_per_block output rows per block (their R x 8 bytes of indices and
// weights in shared memory), slab_lanes lanes of them per block; vec: 1
// where every row of the table starts on a 16-byte boundary, so it is read
// in lanes of 4 words. Returns the cudaError_t of the launch (0 = ok).
int packed_gather_sum(const void* packed, const void* idx, const void* mask,
                      void* out, int M, int R, int d_half, int rows_per_block,
                      int slab_lanes, int vec, void* stream) {
  if (rows_per_block < 1 || slab_lanes < 1 || (vec && d_half % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = vec ? d_half / 4 : d_half;
  const dim3 grid(
      static_cast<unsigned>((static_cast<int64_t>(M) + rows_per_block - 1) /
                            rows_per_block),
      static_cast<unsigned>((lanes + slab_lanes - 1) / slab_lanes));
  const size_t smem = static_cast<size_t>(rows_per_block) * R * 8;
  packed_gather_sum_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(idx),
      static_cast<const float*>(mask), static_cast<float*>(out), M, R, d_half,
      rows_per_block, slab_lanes, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
