// Native batch-assembly engine: executes precompiled sample "site
// programs" (data/plan.py) with a bit-exact reimplementation of numpy's
// SeedSequence -> PCG64 -> Generator draw chain, so epoch assembly is
// bitwise-identical to the per-sample Python path under the
// (seed, epoch, i) stream contract while running ~100x faster.
//
// The replicated draw semantics (validated against numpy 2.x in
// tests/test_assembly_plan.py):
//   - SeedSequence entropy mixing (O'Neill seed_seq_fe: hashmix/mix with
//     INIT_A/MULT_A/INIT_B/MULT_B and subtract-mix), pool size 4;
//   - PCG64 (XSL-RR 128/64) seeded from generate_state(4, uint64), with
//     the next32 half-word buffer;
//   - Generator.integers(n): Lemire rejection, 32-bit path for ranges
//     <= 2^32 (consumes the half-word buffer);
//   - Generator.choice(n, k, replace=False): Floyd's sampling with a
//     membership set, then Fisher-Yates shuffle via Lemire draws.
//
// Build: python -m lirec_tpu_torch.native.build  (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>

extern "C" {

typedef __uint128_t u128;

static const uint32_t INIT_A = 0x43b0d7e5u, MULT_A = 0x931e8875u;
static const uint32_t INIT_B = 0x8b51f9ddu, MULT_B = 0x58f38dedu;
static const uint32_t MIX_L = 0xca01f9ddu, MIX_R = 0x4973f715u;
static const int XSHIFT = 16, POOL = 4;

struct Pcg64 {
  u128 state, inc;
  int has_uint32;
  uint32_t uinteger;
};

static inline uint32_t hashmix(uint32_t value, uint32_t *hc) {
  value ^= *hc;
  *hc *= MULT_A;
  value *= *hc;
  value ^= value >> XSHIFT;
  return value;
}

static inline uint32_t mix(uint32_t x, uint32_t y) {
  uint32_t r = MIX_L * x - MIX_R * y;
  r ^= r >> XSHIFT;
  return r;
}

// SeedSequence((w0, w1, w2)).generate_state(4, uint64) -> seeded PCG64.
static void pcg_init(Pcg64 *g, const uint32_t *entropy, int n_ent) {
  uint32_t pool[POOL];
  uint32_t hc = INIT_A;
  for (int i = 0; i < POOL; ++i)
    pool[i] = hashmix(i < n_ent ? entropy[i] : 0u, &hc);
  for (int s = 0; s < POOL; ++s)
    for (int d = 0; d < POOL; ++d)
      if (s != d) pool[d] = mix(pool[d], hashmix(pool[s], &hc));
  for (int s = POOL; s < n_ent; ++s)
    for (int d = 0; d < POOL; ++d) pool[d] = mix(pool[d], hashmix(entropy[s], &hc));

  uint32_t w[8];
  uint32_t hb = INIT_B;
  int src = 0;
  for (int i = 0; i < 8; ++i) {
    uint32_t v = pool[src];
    src = (src + 1) % POOL;
    v ^= hb;
    hb *= MULT_B;
    v *= hb;
    v ^= v >> XSHIFT;
    w[i] = v;
  }
  uint64_t u0 = (uint64_t)w[0] | ((uint64_t)w[1] << 32);
  uint64_t u1 = (uint64_t)w[2] | ((uint64_t)w[3] << 32);
  uint64_t u2 = (uint64_t)w[4] | ((uint64_t)w[5] << 32);
  uint64_t u3 = (uint64_t)w[6] | ((uint64_t)w[7] << 32);
  u128 seed = ((u128)u0 << 64) | u1;
  u128 incr = ((u128)u2 << 64) | u3;
  const u128 MUL = ((u128)2549297995355413924ULL << 64) | 4865540595714422341ULL;
  g->inc = (incr << 1) | 1;
  g->state = 0;
  g->state = g->state * MUL + g->inc;
  g->state += seed;
  g->state = g->state * MUL + g->inc;
  g->has_uint32 = 0;
  g->uinteger = 0;
}

static inline uint64_t pcg_next64(Pcg64 *g) {
  const u128 MUL = ((u128)2549297995355413924ULL << 64) | 4865540595714422341ULL;
  g->state = g->state * MUL + g->inc;
  uint64_t hi = (uint64_t)(g->state >> 64), lo = (uint64_t)g->state;
  uint64_t v = hi ^ lo;
  unsigned rot = (unsigned)(g->state >> 122);
  return rot ? ((v >> rot) | (v << (64 - rot))) : v;
}

static inline uint32_t pcg_next32(Pcg64 *g) {
  if (g->has_uint32) {
    g->has_uint32 = 0;
    return g->uinteger;
  }
  uint64_t v = pcg_next64(g);
  g->has_uint32 = 1;
  g->uinteger = (uint32_t)(v >> 32);
  return (uint32_t)v;
}

static inline uint64_t lemire64(Pcg64 *g, uint64_t rng_excl) {
  const uint64_t rng = rng_excl - 1;
  u128 m = (u128)pcg_next64(g) * rng_excl;
  uint64_t leftover = (uint64_t)m;
  if (leftover < rng_excl) {
    const uint64_t threshold = (UINT64_MAX - rng) % rng_excl;
    while (leftover < threshold) {
      m = (u128)pcg_next64(g) * rng_excl;
      leftover = (uint64_t)m;
    }
  }
  return (uint64_t)(m >> 64);
}

static inline uint32_t lemire32(Pcg64 *g, uint32_t rng_excl) {
  const uint32_t rng = rng_excl - 1;
  uint64_t m = (uint64_t)pcg_next32(g) * rng_excl;
  uint32_t leftover = (uint32_t)m;
  if (leftover < rng_excl) {
    const uint32_t threshold = (uint32_t)(-(uint32_t)rng_excl) % rng_excl;
    while (leftover < threshold) {
      m = (uint64_t)pcg_next32(g) * rng_excl;
      leftover = (uint32_t)m;
    }
  }
  return (uint32_t)(m >> 32);
}

// random_bounded_uint64(off=0, rng, mask=0, use_masked=0): [0, rng]
static inline uint64_t bounded_u64(Pcg64 *g, uint64_t rng) {
  if (rng == 0) return 0;
  if (rng <= 0xFFFFFFFFULL) {
    if (rng == 0xFFFFFFFFULL) return pcg_next32(g);
    return lemire32(g, (uint32_t)(rng + 1));
  }
  if (rng == UINT64_MAX) return pcg_next64(g);
  return lemire64(g, rng + 1);
}

// Generator.choice(pop, k, replace=False): Floyd + Fisher-Yates shuffle.
// k <= 64 in every plan (rels_n_clips); linear membership scan is fine.
static void choice_no_replace(Pcg64 *g, int64_t pop, int64_t k, int64_t *out) {
  for (int64_t t = 0; t < k; ++t) {
    int64_t j = pop - k + t;
    int64_t val = (int64_t)bounded_u64(g, (uint64_t)j);
    for (int64_t q = 0; q < t; ++q)
      if (out[q] == val) {
        val = j;
        break;
      }
    out[t] = val;
  }
  for (int64_t i = k - 1; i > 0; --i) {
    int64_t j = (int64_t)bounded_u64(g, (uint64_t)i);
    int64_t tmp = out[i];
    out[i] = out[j];
    out[j] = tmp;
  }
}

// ---------------------------------------------------------------- engine

enum { OP_SET = 0, OP_BLOCK = 1, OP_GATHER = 2 };
#define MAX_CHOICE 256

// Execute the dynamic-sample programs for one epoch.
//   code/prog_off: int64 site programs (layout in data/plan.py:encoded)
//   pos/sample_id: per dynamic instance, the epoch row and the absolute
//                  sample index (PRNG stream identity)
//   pool:          int32 constant pool
//   outs/strides:  flattened [n_epoch, stride] int32 output arrays
// Returns 0 on success, nonzero on malformed programs.
int assemble_epoch(
    const int64_t *code, const int64_t *prog_off, const int64_t *pos,
    const uint32_t *sample_id, int64_t n_dyn, uint32_t seed, uint32_t epoch,
    const int32_t *pool,
    int32_t *out0, int64_t s0, int32_t *out1, int64_t s1, int32_t *out2,
    int64_t s2, int32_t *out3, int64_t s3, int32_t *out4, int64_t s4) {
  int32_t *outs[5] = {out0, out1, out2, out3, out4};
  int64_t strides[5] = {s0, s1, s2, s3, s4};
  int64_t chosen[MAX_CHOICE];

  for (int64_t d = 0; d < n_dyn; ++d) {
    Pcg64 g;
    uint32_t entropy[3] = {seed, epoch, sample_id[d]};
    pcg_init(&g, entropy, 3);
    const int64_t *p = code + prog_off[d];
    int64_t n_sites = *p++;
    int64_t row = pos[d];
    for (int64_t s = 0; s < n_sites; ++s) {
      const int64_t *site = p;
      int64_t L = site[0], n_outc = site[1], end_rel = site[2];
      int64_t k = 0;
      if (L > 1) k = (int64_t)bounded_u64(&g, (uint64_t)(L - 1));
      if (k < 0 || k >= n_outc) return 1;
      const int64_t *oc = site + site[3 + k];
      int64_t choice_len = oc[0], n_ops = oc[1];
      const int64_t *op = oc + 2;
      int64_t n_chosen = 0;
      if (choice_len) {
        // peek the gather width (all gathers in one site share `chosen`)
        for (int64_t i = 0, q = 0; i < n_ops; ++i) {
          int64_t kind = op[q];
          if (kind == OP_GATHER) {
            n_chosen = op[q + 5];
            break;
          }
          q += (kind == OP_SET) ? 4 : 5;
        }
        if (n_chosen <= 0 || n_chosen > MAX_CHOICE) return 2;
        choice_no_replace(&g, choice_len, n_chosen, chosen);
      }
      for (int64_t i = 0; i < n_ops; ++i) {
        int64_t kind = *op++;
        if (kind == OP_SET) {
          int64_t arr = op[0], off = op[1], val = op[2];
          outs[arr][row * strides[arr] + off] = (int32_t)val;
          op += 3;
        } else if (kind == OP_BLOCK) {
          int64_t arr = op[0], off = op[1], poff = op[2], cnt = op[3];
          memcpy(outs[arr] + row * strides[arr] + off, pool + poff,
                 cnt * sizeof(int32_t));
          op += 4;
        } else if (kind == OP_GATHER) {
          int64_t arr = op[0], off = op[1], poff = op[2], rowlen = op[3],
                  nrows = op[4];
          int32_t *dst = outs[arr] + row * strides[arr] + off;
          for (int64_t r = 0; r < nrows; ++r) {
            const int32_t *src = pool + poff + chosen[r] * rowlen;
            for (int64_t c = 0; c < rowlen; ++c) dst[r * rowlen + c] = src[c];
          }
          op += 5;
        } else {
          return 3;
        }
      }
      p = site + end_rel;
    }
  }
  return 0;
}

// ------------------------------------------------- test shims (bindings)

// Expose the raw draw chain so tests can fuzz it against numpy directly.
void rng_selftest(uint32_t seed, uint32_t epoch, uint32_t i, int64_t n_raw,
                  uint64_t *raw_out, int64_t n_int, int64_t int_bound,
                  int64_t *int_out, int64_t choice_pop, int64_t choice_k,
                  int64_t *choice_out) {
  Pcg64 g;
  uint32_t entropy[3] = {seed, epoch, i};
  pcg_init(&g, entropy, 3);
  for (int64_t j = 0; j < n_raw; ++j) raw_out[j] = pcg_next64(&g);
  for (int64_t j = 0; j < n_int; ++j)
    int_out[j] = (int64_t)bounded_u64(&g, (uint64_t)(int_bound - 1));
  if (choice_k > 0) choice_no_replace(&g, choice_pop, choice_k, choice_out);
}

}  // extern "C"
