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
// What bounds it. At the probe's shapes (M = 1280 pooled rows, R = 18,
// clip rows of 1024 and track rows of 256 f32) the distinct rows of the
// runs and the output take 0.024 ms at the card's memory rate; every pooled
// row reads its own 18 x 3 rows, 141.6 MB pulled into the SMs. The runs'
// ~73 MB of distinct rows do not fit in the 50 MB L2, and random starts
// reuse them far apart in time, so most of the 141.6 MB comes from device
// memory: the ring's copies alone take as long as kernel 1's row loads of
// the same rows (0.053 against 0.050 ms; with a quarter of the table rows,
// whose runs fit in L2, 0.033 against 0.035). The first design (one block
// per pooled row holding all 110,592 B of its runs: two blocks per SM, a
// block adding nothing until its runs had landed and copying nothing while
// it added; thread 0 summing the divider between two barriers) took
// 0.053-0.055 ms, 45% of the bound (NVIDIA H100 80GB HBM3, 700 W; PERF.md
// section 6).
//
// Design: a producer/consumer ring of bulk copies (the Tensor Memory
// Accelerator's non-tensor form), without tensor cores.
// * Persistent blocks, one per SM (ops/probes.run_pool_plan: the grid is
//   the card's SM count, or M where smaller), each walking the pooled rows
//   blockIdx.x, blockIdx.x + gridDim.x, ...
// * The ring: `stages` stages of shared memory, each with a full and an
//   empty mbarrier and a header. A stage holds a chunk of k <= 32
//   consecutive run rows of all three tables (k rows of clip, then of
//   tr1, then of tr2, from a 128-byte boundary), so that every consumer
//   lane has work in every stage; its header holds the chunk's k weights
//   and the pooled row's run flags. The plan ships two stages of a pooled
//   row's whole runs (108 KB at the probe's shapes).
// * The producer: one warp. Per stage each lane stores one weight of the
//   header; after a __syncwarp the first lane arrives on the stage's full
//   barrier (its release publishes the header) expecting the bytes of one
//   cp.async.bulk of k x d x 4 bytes per table (a multiple of 16: the
//   widths are multiples of 4), and issues them. The next chunk's weights
//   and the next row's starts are loaded a stage ahead. It runs up to
//   `stages` stages ahead of the consumers, into the next pooled row while
//   they finish the last one.
// * The consumers: 12 warps, on kernel 1's lane map (16-byte lanes of 4
//   columns: 256 clip lanes and 2 x 64 track lanes of a 1536-wide row, one
//   per thread; up to kMaxLanes per thread, so rows of up to 9,216
//   columns). They read nothing from device memory: each thread keeps its
//   accumulators in registers across the chunks of a pooled row, adds in r
//   order with the _rn intrinsics (16-byte shared loads, kAhead rows ahead
//   of the chain), sums the divider itself from the staged weights in r
//   order, and its warp releases the stage with one arrive on the empty
//   barrier.
// * The epilogue: each consumer thread multiplies by the divider's
//   reciprocal, applies tanhf and stores 16-byte vectors.
// * The ring's size depends on neither R nor the width: the wrapper raises
//   only where one row of the three tables exceeds a stage or the lanes the
//   consumers keep; R is limited by the probes' own limit alone
//   (ops/probes.PROBE_MAX_CONTEXT).
// * A run that leaves its table is not copied: its bytes are left out of
//   the stage's expected count and its output segment is NaN (no fault, no
//   silent value).
// * A wait on either barrier kind that never completes traps after ~4M
//   polls, so a launch fails with an error instead of hanging the card.
// Tried on the card and left out (this kernel's redesign in CHANGES.md;
// kernel 9's row in PERF.md section 6): consumers that read the starts and
// the weights from device memory at each row and summed the divider in the
// epilogue (their adds alone took 0.047 ms, the ring 0.060); headers inside
// the stages, which put the copies' destinations off 128-byte boundaries
// (the copies alone 0.055 ms instead of 0.053); 2 to 9 rows per stage in 4
// to 8 stages (0.055-0.066 ms against 0.054 for whole runs x 2); two blocks
// per SM (registers capped at 72: spills, 0.10 ms).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 384;  // ops/probes.RUN_CONSUMERS
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxLanes = 6;     // ops/probes.RUN_MAX_LANES, per consumer
constexpr int kMaxStages = 8;    // ops/probes.RUN_MAX_STAGES
constexpr int kMaxChunkRows = 32;  // ops/probes.RUN_MAX_CHUNK_ROWS
constexpr int kMeta = 16 + 4 * kMaxChunkRows;  // a stage's flags, weights
// the 2 x kMaxStages barriers, then the stages' headers: the stages' rows
// start on a 128-byte boundary (ops/probes.RUN_HEADER_BYTES)
constexpr int kHeader = 128 + kMaxStages * kMeta;
static_assert(kHeader % 128 == 0, "the rows' alignment");
constexpr int kAhead = 6;        // staged rows loaded ahead of their adds

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

// Waits for the barrier's phase of parity `parity` to complete. A wait
// that never completes (a fault in the copies' byte count or the arrivals)
// traps after ~4M polls, so a launch fails instead of hanging the card.
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

__device__ __forceinline__ void barrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar)
               : "memory");
}

__device__ __forceinline__ bool run_ok(int s, int n, int R) {
  return s >= 0 && s <= n - R;
}

// A stage's header (kMeta bytes, in the array after the barriers): the
// pooled row's run flags and the chunk's weights. The stage's rows of
// clip, tr1 and tr2 are in the ring.
struct Meta {
  int ok;                  // bit t: table t's run is inside its table
  int pad[3];
  float w[kMaxChunkRows];  // mask[m, r0 .. r0 + kk - 1]
};
static_assert(sizeof(Meta) == kMeta, "the stage header");

// The producer warp: it issues the bulk copies of every chunk of every
// pooled row of this block, in the order the consumers take them, and
// stages each chunk's weights and the row's run flags in the chunk's
// header. The next chunk's weights, and the next row's starts, are loaded
// a stage ahead, so no global read waits on the way from one stage to the
// next.
__device__ void produce(const float* __restrict__ clip,
                        const float* __restrict__ tr1,
                        const float* __restrict__ tr2,
                        const int32_t* __restrict__ idx,
                        const float* __restrict__ mask, Meta* metas,
                        float* ring, uint32_t full0, uint32_t empty0, int M,
                        int R, int d_clip, int d_tr, int n_clip, int n_tr,
                        int k, int stages) {
  const int lane = threadIdx.x & 31;
  const int stage_floats = k * (d_clip + 2 * d_tr);
  int s = 0;
  uint32_t phase = 0;
  int64_t m = blockIdx.x;
  // the next chunk to stage: its row's starts, its first run row, the
  // weight this lane stages (chunk row `lane`)
  const int32_t* p = idx + m * 3 * R;
  int n0 = __ldg(p), n1 = __ldg(p + 1), n2 = __ldg(p + 2);
  int r0 = 0;
  float wn = lane < (R < k ? R : k) ? __ldg(mask + m * R + lane) : 0.f;
  while (m < M) {
    const int s0 = n0, s1 = n1, s2 = n2;
    const int kk = R - r0 < k ? R - r0 : k;
    const float w = wn;
    const int cr0 = r0;
    // advance to the next chunk and load what it stages
    r0 += k;
    if (r0 >= R) {
      r0 = 0;
      m += gridDim.x;
      if (m < M) {
        p = idx + m * 3 * R;
        n0 = __ldg(p); n1 = __ldg(p + 1); n2 = __ldg(p + 2);
      }
    }
    if (m < M)
      wn = lane < (R - r0 < k ? R - r0 : k) ? __ldg(mask + m * R + r0 + lane)
                                            : 0.f;
    const int ok = run_ok(s0, n_clip, R) | run_ok(s1, n_tr, R) << 1 |
                   run_ok(s2, n_tr, R) << 2;
    const uint32_t full = full0 + 8 * s, empty = empty0 + 8 * s;
    barrier_wait(empty, phase ^ 1);  // round 0 passes at once
    Meta* meta = metas + s;
    if (lane < kk) meta->w[lane] = w;
    if (lane == 0) meta->ok = ok;
    __syncwarp();  // orders the lanes' stores before lane 0's release
    if (lane == 0) {
      float* rows = ring + static_cast<int64_t>(s) * stage_floats;
      const uint32_t clip_bytes = static_cast<uint32_t>(kk) * d_clip * 4;
      const uint32_t tr_bytes = static_cast<uint32_t>(kk) * d_tr * 4;
      const uint32_t expect = (ok & 1 ? clip_bytes : 0) +
                              (ok & 2 ? tr_bytes : 0) +
                              (ok & 4 ? tr_bytes : 0);
      // the arrive releases the header and sets the bytes to expect
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(full), "r"(expect) : "memory");
      if (ok & 1)
        bulk_copy_g2s(rows, clip + static_cast<int64_t>(s0 + cr0) * d_clip,
                      clip_bytes, full);
      if (ok & 2)
        bulk_copy_g2s(rows + k * d_clip,
                      tr1 + static_cast<int64_t>(s1 + cr0) * d_tr, tr_bytes,
                      full);
      if (ok & 4)
        bulk_copy_g2s(rows + k * (d_clip + d_tr),
                      tr2 + static_cast<int64_t>(s2 + cr0) * d_tr, tr_bytes,
                      full);
    }
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
}

// The consumers: thread t owns the lanes t, t + kConsumers, ... of a pooled
// row (lane = 4 output columns of one table). They read nothing from
// global memory: the rows, the weights and the run flags come in the
// stages.
__device__ void consume(float* __restrict__ out, const Meta* metas,
                        const float* ring, uint32_t full0, uint32_t empty0,
                        int M, int R, int d_clip, int d_tr, int k,
                        int stages) {
  const int width = d_clip + 2 * d_tr;
  const int stage_floats = k * width;
  const int lanes = width / 4;
  const int c_clip = d_clip / 4, c_tr = d_tr / 4;
  // per owned lane: its table, its offset in a stage's row 0, the stage's
  // row stride for it, its first output column
  int tab[kMaxLanes], soff[kMaxLanes], ld[kMaxLanes], ocol[kMaxLanes];
  int nl = 0;
#pragma unroll
  for (int i = 0; i < kMaxLanes; ++i) {
    const int lane = threadIdx.x + i * kConsumers;
    tab[i] = soff[i] = ld[i] = ocol[i] = 0;
    if (lane < lanes) {
      nl = i + 1;
      if (lane < c_clip) {
        tab[i] = 0; soff[i] = lane * 4; ld[i] = d_clip; ocol[i] = lane * 4;
      } else {
        const int l = lane - c_clip;
        const int t = l < c_tr ? 1 : 2;
        const int c = (l - (t - 1) * c_tr) * 4;
        tab[i] = t;
        soff[i] = k * (d_clip + (t - 1) * d_tr) + c;
        ld[i] = d_tr;
        ocol[i] = d_clip + (t - 1) * d_tr + c;
      }
    }
  }
  const bool leader = (threadIdx.x & 31) == 0;
  int s = 0;
  uint32_t phase = 0;
  for (int64_t m = blockIdx.x; m < M; m += gridDim.x) {
    float acc[kMaxLanes][4];
#pragma unroll
    for (int i = 0; i < kMaxLanes; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float div = 0.f;
    int ok = 0;
    for (int r0 = 0; r0 < R; r0 += k) {
      const int kk = R - r0 < k ? R - r0 : k;
      barrier_wait(full0 + 8 * s, phase);
      const Meta* meta = metas + s;
      const float* rows = ring + static_cast<int64_t>(s) * stage_floats;
      ok = meta->ok;
      for (int j = 0; j < kk; ++j) div = __fadd_rn(div, meta->w[j]);
#pragma unroll
      for (int i = 0; i < kMaxLanes; ++i) {
        if (i >= nl || !(ok >> tab[i] & 1)) continue;
        const float* p = rows + soff[i];
        for (int j0 = 0; j0 < kk; j0 += kAhead) {
          float4 x[kAhead];
          float w[kAhead];
#pragma unroll
          for (int j = 0; j < kAhead; ++j)
            if (j0 + j < kk) {
              x[j] = *reinterpret_cast<const float4*>(p + (j0 + j) * ld[i]);
              w[j] = meta->w[j0 + j];
            }
#pragma unroll
          for (int j = 0; j < kAhead; ++j)
            if (j0 + j < kk) {
              acc[i][0] = __fadd_rn(acc[i][0], __fmul_rn(w[j], x[j].x));
              acc[i][1] = __fadd_rn(acc[i][1], __fmul_rn(w[j], x[j].y));
              acc[i][2] = __fadd_rn(acc[i][2], __fmul_rn(w[j], x[j].z));
              acc[i][3] = __fadd_rn(acc[i][3], __fmul_rn(w[j], x[j].w));
            }
        }
      }
      __syncwarp();  // the warp's reads of the stage are done
      if (leader) barrier_arrive(empty0 + 8 * s);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    const float inv = __fdiv_rn(1.f, fmaxf(div, 1.f));
    float* o = out + m * width;
#pragma unroll
    for (int i = 0; i < kMaxLanes; ++i) {
      if (i >= nl) continue;
      const float nan = __int_as_float(0x7fc00000);  // the run left its table
      *reinterpret_cast<float4*>(o + ocol[i]) =
          ok >> tab[i] & 1 ? make_float4(tanhf(__fmul_rn(acc[i][0], inv)),
                                         tanhf(__fmul_rn(acc[i][1], inv)),
                                         tanhf(__fmul_rn(acc[i][2], inv)),
                                         tanhf(__fmul_rn(acc[i][3], inv)))
                           : make_float4(nan, nan, nan, nan);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
run_pool_kernel(const float* __restrict__ clip, const float* __restrict__ tr1,
                const float* __restrict__ tr2,
                const int32_t* __restrict__ idx,
                const float* __restrict__ mask, float* __restrict__ out,
                int M, int R, int d_clip, int d_tr, int n_clip, int n_tr,
                int k, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_addr(smem);  // full[s] at + 8 s
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  Meta* metas = reinterpret_cast<Meta*>(smem + 128);
  float* ring = reinterpret_cast<float*>(smem + kHeader);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(full0 + 8 * s) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(empty0 + 8 * s), "r"(kConsumers / 32) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier
  if (threadIdx.x >= kConsumers)
    produce(clip, tr1, tr2, idx, mask, metas, ring, full0, empty0, M, R,
            d_clip, d_tr, n_clip, n_tr, k, stages);
  else
    consume(out, metas, ring, full0, empty0, M, R, d_clip, d_tr, k, stages);
}

}  // namespace

extern "C" {

// Pointers are device pointers of contiguous f32 tensors, 16-byte aligned:
// clip [n_clip, d_clip], tr1/tr2 [n_tr, d_tr], idx int32 [M, R, 3] (only
// idx[:, 0, :] is read), mask f32 [M, R], out f32 [M, d_clip + 2 * d_tr];
// d_clip and d_tr multiples of 4. The geometry is ops/probes.run_pool_plan's:
// rows_per_chunk run rows of each table per stage, `stages` stages, `grid`
// persistent blocks. Returns the cudaError_t of the attribute call or the
// launch (0 = ok).
int probe_hbm_dma_f32(const void* clip, const void* tr1, const void* tr2,
                      const void* idx, const void* mask, void* out, int M,
                      int R, int d_clip, int d_tr, int n_clip, int n_tr,
                      int rows_per_chunk, int stages, int grid,
                      void* stream) {
  const int width = d_clip + 2 * d_tr;
  if (rows_per_chunk < 1 || rows_per_chunk > kMaxChunkRows || stages < 1 ||
      stages > kMaxStages || grid < 1 || d_clip % 4 || d_tr % 4 ||
      width / 4 > kConsumers * kMaxLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kHeader + static_cast<size_t>(stages) *
                                    rows_per_chunk * width * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      run_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  run_pool_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(clip), static_cast<const float*>(tr1),
      static_cast<const float*>(tr2), static_cast<const int32_t*>(idx),
      static_cast<const float*>(mask), static_cast<float*>(out), M, R, d_clip,
      d_tr, n_clip, n_tr, rows_per_chunk, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
