"""The port's fused ctx pool against the JAX package's.

On the CPU the port's wrapper takes its plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode and its jnp reference, as
tests/test_ops.py does. The same numpy inputs, made from a seed, go to
both. The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lirec_tpu.models.tabular import EmbeddedTables as JaxTables
from lirec_tpu.ops.gather_pool import fused_ctx_pool as jax_pool
from lirec_tpu.ops.gather_pool import pack_bf16_table
from lirec_tpu_torch.models.tabular import EmbeddedTables
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.ops.gather_pool import (
    KERNEL_NAMES,
    fused_ctx_pool,
    fused_ctx_pool_reference,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU tanh, run for the first time across several threads, has
    been seen to return values ~4e-5 off; one thread keeps the plain
    versions deterministic at these tolerances."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(M=8, R=18, Nc=32, Nt=48, Dc=256, Dt=128, seed=0):
    rng = np.random.default_rng(seed)
    tables = [rng.standard_normal((n, d)).astype(np.float32)
              for n, d in ((Nc, Dc), (Nt, Dt), (Nt, Dt))]
    idx = np.stack(
        [rng.integers(0, Nc, (M, R)), rng.integers(0, Nt, (M, R)),
         rng.integers(0, Nt, (M, R))], axis=-1,
    ).astype(np.int32)
    mask = (rng.random((M, R)) < 0.4).astype(np.float32)
    mask[:, 1] = 1.0
    mask[0] = 0.0  # rows without context: the zero-divider guard
    mask[5] = 0.0
    return tables, idx, mask


def _port(tables, idx, mask, guard, dtype=torch.float32):
    emb = EmbeddedTables(*(torch.from_numpy(t).to(dtype) for t in tables))
    out = fused_ctx_pool(emb, torch.from_numpy(idx), torch.from_numpy(mask),
                         guard)
    assert out.dtype == torch.float32
    return out.numpy()


def _jax(tables, idx, mask, guard, force, packed=False):
    arrs = [jnp.asarray(t) for t in tables]
    if packed:
        arrs = [pack_bf16_table(a) for a in arrs]
    return np.asarray(jax_pool(JaxTables(*arrs), jnp.asarray(idx),
                               jnp.asarray(mask), guard, force=force))


@pytest.mark.parametrize("force", ["interpret", "reference"])
@pytest.mark.parametrize("guard", [True, False])
def test_pool_f32_matches_jax(guard, force):
    """f32 tables. atol 2e-6: the Pallas kernel multiplies by 1/div where
    the plain versions divide, and sums run in another order (one-ulp
    differences of values in [-1, 1]). Without the guard an empty row is
    NaN (0/0) on both sides."""
    tables, idx, mask = _inputs(seed=1)
    got = _port(tables, idx, mask, guard)
    want = _jax(tables, idx, mask, guard, force)
    assert np.isnan(want[0]).all() != guard
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6, equal_nan=True)


@pytest.mark.parametrize("force", ["interpret", "reference"])
def test_pool_bf16_matches_jax_packed(force):
    """bf16 tables against the JAX package's packed-bf16 tables (two bf16
    columns per int32 word; logical widths 512 / 256 keep the packed halves
    at multiples of 128 for the interpret kernel). Both round the same f32
    values to the same bf16 values and sum them in f32: atol 1e-6."""
    tables, idx, mask = _inputs(Dc=512, Dt=256, seed=2)
    got = _port(tables, idx, mask, True, dtype=torch.bfloat16)
    want = _jax(tables, idx, mask, True, force, packed=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_pool_bf16_tables_near_f32():
    """bf16 tables against the JAX package's f32 tables: within 4.1e-3, the
    bound measured for the TPU's packed tables (BENCH.md), and elementwise
    within the bound of bf16 rounding itself: rounding moves each value by
    at most 2^-8 of its size, the mean moves by at most the mean of those,
    and tanh is 1-Lipschitz."""
    tables, idx, mask = _inputs(M=16, seed=3)
    got = _port(tables, idx, mask, True, dtype=torch.bfloat16)
    want = _jax(tables, idx, mask, True, "reference")
    err = np.abs(got - want)
    assert err.max() <= 4.1e-3, "max |diff| %.3e" % err.max()
    abs_mean = _jax([np.abs(t) for t in tables], idx, mask, True,
                    "reference")  # tanh(mean |x|) <= mean |x|
    bound = 2.0 ** -8 * np.arctanh(np.minimum(abs_mean, 1 - 1e-7)) + 1e-6
    assert (err <= bound).all(), "max |diff| %.3e" % err.max()


def test_pool_cpu_takes_plain_version_and_launches_nothing():
    tables, idx, mask = _inputs(seed=4)
    before = dispatch.launches()
    emb = EmbeddedTables(*(torch.from_numpy(t) for t in tables))
    args = (emb, torch.from_numpy(idx), torch.from_numpy(mask), True)
    torch.testing.assert_close(fused_ctx_pool(*args),
                               fused_ctx_pool_reference(*args),
                               rtol=0, atol=0)
    assert dispatch.launches() == before
    assert dispatch.last_dispatch(KERNEL_NAMES[torch.float32])["path"] == (
        "reference")


def test_pool_other_device_never_takes_plain_version():
    """Only CPU tensors reach the plain version: tensors elsewhere launch a
    kernel or raise (here the meta device, which has no kernel)."""
    emb = EmbeddedTables(*(torch.empty(n, d, device="meta")
                           for n, d in ((8, 16), (8, 8), (8, 8))))
    idx = torch.zeros(4, 3, 3, dtype=torch.int32, device="meta")
    mask = torch.ones(4, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_ctx_pool(emb, idx, mask, True)


def test_pool_rejects_what_the_kernel_does_not_take():
    tables, idx, mask = _inputs(seed=5)
    emb = EmbeddedTables(*(torch.from_numpy(t) for t in tables))
    i, m = torch.from_numpy(idx), torch.from_numpy(mask)
    with pytest.raises(ValueError, match="int32"):
        fused_ctx_pool(emb, i.long(), m, True)
    with pytest.raises(ValueError, match="mask"):
        fused_ctx_pool(emb, i, m[:, :-1].contiguous(), True)
    with pytest.raises(ValueError, match="contiguous"):
        fused_ctx_pool(emb, i, m.t().contiguous().t(), True)
    with pytest.raises(TypeError, match="one dtype"):
        fused_ctx_pool(emb._replace(tr2=emb.tr2.to(torch.bfloat16)), i, m,
                       True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_ctx_pool(EmbeddedTables(*(t.half() for t in emb)), i, m, True)
    with pytest.raises(ValueError, match="tables"):
        fused_ctx_pool(emb._replace(tr1=emb.tr1[:, :64].contiguous()), i, m,
                       True)
