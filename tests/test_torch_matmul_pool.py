"""The triple pool's matmul tier (ops/gather_pool.matmul_pool, reached by
``fused_ctx_pool_triple(..., force="matmul")``) against the JAX package's
``fused_ctx_pool_triple(..., force="matmul")`` (``_matmul_pool``, plain
jnp) and against the port's own ``force="reference"``, on the CPU.

The inputs are made from a numpy seed as tests/test_ops.py makes them for
the JAX tier: three tables, index triples, a 0/1 mask, localized to one
fused table of unique [clip | tr1 | tr2] rows. Two cases: triples drawn
from a pool of five, so that rows hold the same fused row several times
(S counts above 1), and random triples with a row whose mask is all
zero (the divider's guard; without it the row is NaN on both sides).
bf16: the port's native bf16 table holds the values that the JAX
package's packed int32 table holds. The card holds the tier against
kernel 4 (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lirec_tpu.ops.gather_pool import fused_ctx_pool_triple as jax_triple
from lirec_tpu.ops.gather_pool import pack_bf16_table
from lirec_tpu_torch.data.localize import localize_eval_ctx_triples
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES, fused_ctx_pool_triple

M, R, NC, NT, DC, DT = 16, 18, 32, 48, 512, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed=21):
    """(tables, triples [U, 3], tidx [M, R], mask [M, R])."""
    rng = np.random.default_rng(seed)
    tables = [rng.standard_normal((n, d)).astype(np.float32)
              for n, d in ((NC, DC), (NT, DT), (NT, DT))]
    if case == "duplicates":
        pool = np.stack([rng.integers(0, n, 5) for n in (NC, NT, NT)], -1)
        idx = pool[rng.integers(0, 5, (M, R))]
    else:
        idx = np.stack([rng.integers(0, n, (M, R)) for n in (NC, NT, NT)],
                       axis=-1)
    mask = (rng.random((M, R)) < 0.4).astype(np.float32)
    mask[:, 1] = 1.0
    if case == "all_masked":
        mask[0] = 0.0
    fi = np.concatenate([np.zeros((M, 1, 3), np.int32),
                         idx.astype(np.int32)], axis=1)
    tidx, triples = localize_eval_ctx_triples(fi, M, 1, NT)
    return tables, triples[0], tidx, mask


def _fused(tables, tri):
    return np.concatenate([t[tri[:, k]] for k, t in enumerate(tables)],
                          axis=-1)


def _jax(tables, tri, tidx, mask, guard, bf16):
    if bf16:  # the packed layout: two bf16 columns per int32 word
        packed = [np.asarray(pack_bf16_table(jnp.asarray(t)))
                  for t in tables]
        fused, wc, wt = _fused(packed, tri), DC // 2, DT // 2
    else:
        fused, wc, wt = _fused(tables, tri), DC, DT
    return np.asarray(jax_triple(jnp.asarray(fused), jnp.asarray(tidx),
                                 jnp.asarray(mask), wc, wt, guard,
                                 force="matmul"))


@pytest.mark.parametrize("case", ["duplicates", "all_masked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("guard", [True, False])
def test_matmul_tier_matches_jax_and_the_plain_pool(guard, dtype, case):
    """f32 within rtol 2e-6 of JAX's tier (atol 1e-7: both sum in
    u-order, through different matrix products); bf16 within 4.1e-3 (the
    same bf16 values on both sides, f32 products); against the port's
    force="reference" (r-order gathers) within 1e-5 of scale. The
    decision is recorded as "matmul", "forced"."""
    tables, tri, tidx, mask = _inputs(case)
    if case == "duplicates":
        assert any(len(set(row[w > 0])) < int((w > 0).sum())
                   for row, w in zip(tidx, mask)), "no repeated row"
    fused = torch.from_numpy(_fused(tables, tri)).to(dtype)
    args = (torch.from_numpy(tidx), torch.from_numpy(mask), guard)
    name = KERNEL_NAMES[("fused_ctx_pool_triple", dtype)]
    before = dispatch.decisions(name).get("matmul", 0)
    got = fused_ctx_pool_triple(fused, *args, force="matmul")
    assert got.dtype == torch.float32 and got.shape == (M, DC + 2 * DT)
    assert dispatch.last_dispatch(name)["path"] == "matmul"
    assert dispatch.last_dispatch(name)["reason"] == "forced"
    assert dispatch.decisions(name)["matmul"] == before + 1
    got = got.numpy()
    assert np.isnan(got[0]).all() == (case == "all_masked" and not guard)
    want = _jax(tables, tri, tidx, mask, guard, dtype == torch.bfloat16)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
    else:
        assert np.array_equal(np.isnan(got), np.isnan(want))
        err = np.nanmax(np.abs(got - want))
        assert err <= 4.1e-3, "max |diff| %.3e" % err
    ref = fused_ctx_pool_triple(fused, *args, force="reference").numpy()
    assert dispatch.last_dispatch(name)["path"] == "reference"
    scale = np.nanmax(np.abs(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale,
                               equal_nan=True)


def test_triple_pool_refuses_an_unknown_force():
    tables, tri, tidx, mask = _inputs("all_masked")
    fused = torch.from_numpy(_fused(tables, tri))
    with pytest.raises(ValueError, match="force must be"):
        fused_ctx_pool_triple(fused, torch.from_numpy(tidx),
                              torch.from_numpy(mask), True, force="pallas")
