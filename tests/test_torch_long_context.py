"""The port's context pools past 2,048 context entries, against the JAX
package's.

The pool kernels stage a pooled row's context in chunks of
``gather_pool.CONTEXT_CHUNK`` (2,048) entries, so they take any R, as the
JAX package's pools do (their jnp path has no limit). On the CPU the
port's wrappers take their plain versions; the JAX side runs its jnp path,
as its own tests run it on the CPU (``force="auto"`` off a TPU, and
``"reference"``). The same numpy inputs, made from a seed, go to both. The
kernels themselves are held at these R on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 23(d)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lirec_tpu.models.tabular import EmbeddedTables as JaxTables
from lirec_tpu.ops import gather_pool as jax_gp
from lirec_tpu_torch.models.tabular import EmbeddedTables
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.ops import gather_pool as gp

LONG = [2049, 4096]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the plain versions' tanh stays deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(R, M=5, Nc=300, Nt=400, Dc=64, Dt=32, seed=0):
    """Tables, index triples [M, R, 3] and 0/1 weights [M, R] with rows of
    every length up to R (row 0 empty: the zero-divider guard; row 1 the
    whole context)."""
    rng = np.random.default_rng(seed)
    tables = [rng.standard_normal((n, d)).astype(np.float32)
              for n, d in ((Nc, Dc), (Nt, Dt), (Nt, Dt))]
    idx = np.stack([rng.integers(0, n, (M, R)) for n in (Nc, Nt, Nt)],
                   axis=-1).astype(np.int32)
    mask = (rng.random((M, R)) < 0.6).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 1.0
    mask[2, 2048:] = 0.0  # a row whose context ends inside the first chunk
    return tables, idx, mask


def _scale_close(got, want, rtol):
    """Within rtol of the output's scale (its largest magnitude): the two
    packages sum R terms in different orders."""
    scale = float(np.nanmax(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               equal_nan=True)


@pytest.mark.parametrize("force", ["auto", "reference"])
@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("R", LONG)
def test_pool_past_one_chunk_matches_jax(R, guard, force):
    """The 3-table pool (kernels 1-3's function), f32 tables: within 2e-6
    (values in [-1, 1]; the sums' order differs); an empty row is NaN on
    both sides without the guard. Nothing raises at R > 2,048."""
    tables, idx, mask = _inputs(R, seed=R)
    emb = EmbeddedTables(*(torch.from_numpy(t) for t in tables))
    got = gp.fused_ctx_pool(emb, torch.from_numpy(idx),
                            torch.from_numpy(mask), guard).numpy()
    want = np.asarray(jax_gp.fused_ctx_pool(
        JaxTables(*(jnp.asarray(t) for t in tables)), jnp.asarray(idx),
        jnp.asarray(mask), guard, force=force))
    assert got.shape == (5, 128)
    assert np.isnan(want[0]).all() != guard
    assert not np.isnan(want[1:]).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6, equal_nan=True)


@pytest.mark.parametrize("R", LONG)
def test_pool_bf16_tables_past_one_chunk_match_jax_packed(R):
    """bf16 tables against the JAX package's packed-bf16 tables (the same
    bf16 values, f32 sums): within 2e-6."""
    tables, idx, mask = _inputs(R, Dc=128, Dt=64, seed=R + 1)
    emb = EmbeddedTables(*(torch.from_numpy(t).to(torch.bfloat16)
                           for t in tables))
    got = gp.fused_ctx_pool(emb, torch.from_numpy(idx),
                            torch.from_numpy(mask), True).numpy()
    want = np.asarray(jax_gp.fused_ctx_pool(
        JaxTables(*(jax_gp.pack_bf16_table(jnp.asarray(t))
                    for t in tables)),
        jnp.asarray(idx), jnp.asarray(mask), True, force="reference"))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("R", LONG)
def test_triple_pool_past_one_chunk_matches_jax(R, guard):
    """The triple tier (kernel 4's function) on a fused local table of the
    rows' unique triples, against the JAX package's ``fused_ctx_pool_
    triple`` on the same f32 table: within 2e-6; and within 2e-6 of the
    port's 3-table pool on the corresponding triples."""
    tables, idx, mask = _inputs(R, seed=R + 2)
    tri, tidx = np.unique(idx.reshape(-1, 3), axis=0, return_inverse=True)
    fused = np.concatenate([tables[k][tri[:, k]] for k in range(3)], axis=1)
    tidx = tidx.reshape(idx.shape[:2]).astype(np.int32)
    got = gp.fused_ctx_pool_triple(torch.from_numpy(fused),
                                   torch.from_numpy(tidx),
                                   torch.from_numpy(mask), guard).numpy()
    want = np.asarray(jax_gp.fused_ctx_pool_triple(
        jnp.asarray(fused), jnp.asarray(tidx), jnp.asarray(mask), 64, 32,
        guard))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6, equal_nan=True)
    emb = EmbeddedTables(*(torch.from_numpy(t) for t in tables))
    three = gp.fused_ctx_pool(emb, torch.from_numpy(idx),
                              torch.from_numpy(mask), guard).numpy()
    np.testing.assert_allclose(got, three, rtol=0, atol=2e-6,
                               equal_nan=True)


@pytest.mark.parametrize("force", ["auto", "reference"])
@pytest.mark.parametrize("R", LONG)
def test_masked_sum_past_one_chunk_matches_jax(R, force):
    """The masked gather-sum (kernel 5's function), f32 table: within
    2e-6 of the output's scale (sums of up to R terms, taken in another
    order by each package)."""
    tables, idx, mask = _inputs(R, seed=R + 3)
    table, one = tables[0], np.ascontiguousarray(idx[..., 0])
    got = gp.gather_masked_sum(torch.from_numpy(table),
                               torch.from_numpy(one),
                               torch.from_numpy(mask)).numpy()
    want = np.asarray(jax_gp.gather_masked_sum(
        jnp.asarray(table), jnp.asarray(one), jnp.asarray(mask),
        force=force))
    assert got.dtype == np.float32 and (got[0] == 0).all()
    _scale_close(got, want, 2e-6)


@pytest.mark.parametrize("R", LONG)
def test_cpu_wrappers_take_the_plain_versions_past_one_chunk(R):
    """On CPU tensors every pool wrapper takes its plain version at R past
    the chunk (recorded as "reference", no launch), and its output equals
    the plain version's bit for bit."""
    tables, idx, mask = _inputs(R, M=3, seed=R + 4)
    emb = EmbeddedTables(*(torch.from_numpy(t) for t in tables))
    i, m = torch.from_numpy(idx), torch.from_numpy(mask)
    one = i[..., 0].contiguous()
    before = dispatch.launches()
    cases = [
        ("fused_ctx_pool", emb.clip,
         gp.fused_ctx_pool(emb, i, m, True),
         gp.fused_ctx_pool_reference(emb, i, m, True)),
        ("gather_masked_sum", emb.clip,
         gp.gather_masked_sum(emb.clip, one, m),
         gp.gather_masked_sum_reference(emb.clip, one, m)),
        ("fused_ctx_pool_triple", emb.clip,
         gp.fused_ctx_pool_triple(emb.clip, one, m, True),
         gp.fused_ctx_pool_triple_reference(emb.clip, one, m, True)),
    ]
    assert dispatch.launches() == before
    for op, table, got, want in cases:
        assert torch.equal(got, want), op
        rec = dispatch.last_dispatch(gp.KERNEL_NAMES[(op, table.dtype)])
        assert rec["path"] == "reference", op
