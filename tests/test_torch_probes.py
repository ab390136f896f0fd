"""The port's probe kernels (ops/probes.py: the run pool and the
packed-bf16 gather-sum) and the two probe tools against the JAX package's
TPU probes, on the CPU.

The TPU probes live in the repo-root ``tools/`` directory (no package), so
they are loaded by path. Their Pallas kernels run in interpret mode inside
the same ``pl.pallas_call`` that the probes build; the port's wrappers
take their plain versions for CPU tensors. The CUDA kernels themselves are
held against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lirec_tpu_torch.models.tabular import EmbeddedTables
from lirec_tpu_torch.ops import dispatch, probes
from lirec_tpu_torch.ops.gather_pool import fused_ctx_pool_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread keeps torch's CPU tanh deterministic at these tolerances
    (see tests/test_torch_eval.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        "tpu_" + name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------ run pool, kernel 9


def _run_inputs(M=16, R=5, Nc=40, Nt=56, Dc=256, Dt=128, seed=0,
                weights="binary"):
    """f32 tables, idx [M, R, 3] whose starts keep every run inside its
    table (the TPU probe's run-safe draw), weights of one row all zero."""
    rng = np.random.default_rng(seed)
    clip = rng.standard_normal((Nc, Dc)).astype(np.float32)
    tr1 = rng.standard_normal((Nt, Dt)).astype(np.float32)
    tr2 = rng.standard_normal((Nt, Dt)).astype(np.float32)
    idx = np.stack([rng.integers(0, Nc - R, (M, R)),
                    rng.integers(0, Nt - R, (M, R)),
                    rng.integers(0, Nt - R, (M, R))], axis=-1).astype(np.int32)
    if weights == "binary":
        mask = (rng.random((M, R)) < 0.8).astype(np.float32)
    else:  # fractional, some rows summing below 1
        mask = (rng.random((M, R)) * 0.3).astype(np.float32)
    mask[3] = 0.0
    return (clip, tr1, tr2), idx, mask


def _jax_run_pool(tables, idx, mask, tile_m=8):
    """The TPU probe's run_dma_call (tools/probe_hbm_dma.py:86-128) around
    its _make_run_kernel, with interpret=True (run_dma_call has no such
    switch)."""
    mod = _load_tool("probe_hbm_dma")
    clip, tr1, tr2 = (jnp.asarray(t) for t in tables)
    idx, mask = jnp.asarray(idx), jnp.asarray(mask)
    M, R, _ = idx.shape
    d_clip, d_tr = clip.shape[1], tr1.shape[1]
    divider = jnp.maximum(mask.sum(axis=-1, keepdims=True), 1.0)
    packed_mask = jnp.concatenate([mask, 1.0 / divider], axis=1)
    idx_tiled = idx.reshape(M // tile_m, 1, tile_m * R * 3)
    mask_tiled = packed_mask.reshape(M // tile_m, 1, tile_m * (R + 1))
    sc, st = d_clip // 128, d_tr // 128
    out3 = pl.pallas_call(
        mod._make_run_kernel(R, d_clip, d_tr, tile_m),
        grid=(M // tile_m,),
        in_specs=[
            pl.BlockSpec((1, 1, tile_m * R * 3), lambda i: (i, 0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((1, 1, tile_m * (R + 1)), lambda i: (i, 0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((tile_m, sc + 2 * st, 128),
                               lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((M, sc + 2 * st, 128), clip.dtype),
        scratch_shapes=[
            pltpu.VMEM((tile_m * R, sc, 128), clip.dtype),
            pltpu.VMEM((tile_m * R, st, 128), tr1.dtype),
            pltpu.VMEM((tile_m * R, st, 128), tr2.dtype),
            pltpu.SemaphoreType.DMA((tile_m,)),
            pltpu.SemaphoreType.DMA((tile_m,)),
            pltpu.SemaphoreType.DMA((tile_m,)),
        ],
        interpret=True,
    )(idx_tiled, mask_tiled, clip.reshape(-1, sc, 128),
      tr1.reshape(-1, st, 128), tr2.reshape(-1, st, 128))
    return np.asarray(out3.reshape(M, d_clip + 2 * d_tr))


def _emb(tables):
    return EmbeddedTables(*(torch.from_numpy(t) for t in tables))


@pytest.mark.parametrize("weights", ["binary", "fractional"])
def test_run_pool_matches_jax_interpret(weights):
    """The port's run_pool on CPU tensors (its plain version) against the
    TPU probe's kernel in interpret mode: within rtol 2e-6 (f32 sums in
    another order). Fractional weights summing below 1 keep the divider
    max(sum, 1), which is not the zero guard of kernel 1."""
    tables, idx, mask = _run_inputs(weights=weights)
    got = probes.run_pool(_emb(tables), torch.from_numpy(idx),
                          torch.from_numpy(mask))
    want = _jax_run_pool(tables, idx, mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-7)
    assert np.all(got.numpy()[3] == 0.0)  # no weight: tanh(0), not NaN
    rec = dispatch.last_dispatch(probes.KERNEL_NAMES["run_pool"])
    assert rec["path"] == "reference" and rec["reason"] == "cpu tensors"
    if weights == "fractional":
        # max(sum, 1) is 1 where the weights sum below 1; kernel 1's zero
        # guard would divide by the sum instead
        guarded = fused_ctx_pool_reference(
            _emb(tables), _run_index_tensor(idx), torch.from_numpy(mask),
            True)
        assert not torch.allclose(got, guarded)


def _run_index_tensor(idx):
    from lirec_tpu_torch.tools.probe_hbm_dma import run_indices

    return run_indices(torch, torch.from_numpy(idx))


def test_run_pool_is_the_row_pool_on_the_run_indices():
    """With 0/1 weights the run pool is kernel 1's pool (zero guard) of
    the explicit rows idx[m, 0, k] + r: the plain versions agree within
    2 ulp (x * (1 / d) is within 1.5 ulp of x / d before the tanh)."""
    tables, idx, mask = _run_inputs(M=24, R=7, Dc=64, Dt=32, seed=5)
    run = _run_index_tensor(idx)
    assert run.dtype == torch.int32 and tuple(run.shape) == idx.shape
    np.testing.assert_array_equal(run[:, 0].numpy(), idx[:, 0])
    np.testing.assert_array_equal(run[:, 4].numpy(), idx[:, 0] + 4)
    got = probes.run_pool_reference(_emb(tables), torch.from_numpy(idx),
                                    torch.from_numpy(mask))
    want = fused_ctx_pool_reference(_emb(tables), run,
                                    torch.from_numpy(mask), True)
    np.testing.assert_array_max_ulp(got.numpy(), want.numpy(), maxulp=2)


def test_run_pool_checks_its_inputs():
    tables, idx, mask = _run_inputs(M=8, R=4, Dc=64, Dt=32)
    emb = _emb(tables)
    with pytest.raises(TypeError, match="float32"):
        probes.run_pool(EmbeddedTables(*(t.bfloat16() for t in emb)),
                        torch.from_numpy(idx), torch.from_numpy(mask))
    odd = EmbeddedTables(emb.clip[:, :62].contiguous(), emb.tr1, emb.tr2)
    with pytest.raises(ValueError, match="16 bytes"):
        probes.run_pool(odd, torch.from_numpy(idx), torch.from_numpy(mask))
    with pytest.raises(ValueError, match="mask"):
        probes.run_pool(emb, torch.from_numpy(idx),
                        torch.from_numpy(mask[:, :3].copy()))
    # a run that leaves its table gives NaN in its own segment only
    bad = idx.copy()
    bad[2, 0, 1] = tables[1].shape[0] - 1
    out = probes.run_pool_reference(emb, torch.from_numpy(bad),
                                    torch.from_numpy(mask)).numpy()
    assert np.isnan(out[2, 64:96]).all()
    assert not np.isnan(np.delete(out[2], np.s_[64:96])).any()
    assert not np.isnan(np.delete(out, 2, axis=0)).any()


# ------------------------------------ packed-bf16 gather-sum, kernel 10


def _packed_inputs(N=48, D=256, M=16, R=18, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((N, D)).astype(np.float32)
    idx = rng.integers(0, N, (M, R)).astype(np.int32)
    mask = (rng.random((M, R)) < 0.5).astype(np.float32)
    return table, idx, mask


def _bf16_probe():
    """The TPU probe module; its ``pack`` reads a module-global ``jax``
    that only its main() binds, so the test binds it."""
    mod = _load_tool("probe_bf16_pack")
    mod.jax = jax
    return mod


@pytest.mark.parametrize("shape", [(48, 256), (7, 6), (512, 1024)])
def test_pack_bf16_is_the_tpu_probes_pack(shape):
    """Bit for bit, including round-to-nearest-even ties, signed zeros and
    the extremes of the range; unpack_bf16 inverts it."""
    rng = np.random.default_rng(1)
    table = (rng.standard_normal(shape) * 10).astype(np.float32)
    flat = table.reshape(-1)
    flat[:6] = [0.0, -0.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 3e38, -1e-38]
    got = probes.pack_bf16(torch.from_numpy(table))
    want = np.asarray(_bf16_probe().pack(jnp.asarray(table)))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        probes.unpack_bf16(got).float().numpy(),
        torch.from_numpy(table).bfloat16().float().numpy())


def _jax_packed_gather_sum(packed, idx, mask):
    """The TPU probe's pallas_call (tools/probe_bf16_pack.py:69-86) with
    interpret=True."""
    mod = _bf16_probe()
    M, R = idx.shape
    d_half = packed.shape[1]
    out = pl.pallas_call(
        mod.make_kernel(R, d_half),
        grid=(M // 8,),
        in_specs=[
            pl.BlockSpec((1, 1, 8 * R), lambda i: (i, 0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((1, 1, 8 * R), lambda i: (i, 0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((8, 2 * d_half), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((M, 2 * d_half), jnp.float32),
        interpret=True,
    )(jnp.asarray(idx).reshape(M // 8, 1, 8 * R),
      jnp.asarray(mask).reshape(M // 8, 1, 8 * R), jnp.asarray(packed))
    return np.asarray(out)


@pytest.mark.parametrize("n,d,m", [(48, 256, 16), (512, 1024, 64)])
def test_packed_gather_sum_matches_jax_interpret(n, d, m):
    """The port's packed_gather_sum on CPU tensors against the TPU probe's
    kernel in interpret mode, on the same packed words: within 1e-5 (the
    probe's own bound, tools/probe_bf16_pack.py:93)."""
    table, idx, mask = _packed_inputs(n, d, m)
    packed = probes.pack_bf16(torch.from_numpy(table))
    got = probes.packed_gather_sum(packed, torch.from_numpy(idx),
                                   torch.from_numpy(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, d)
    want = _jax_packed_gather_sum(packed.numpy(), idx, mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    rec = dispatch.last_dispatch(probes.KERNEL_NAMES["packed_gather_sum"])
    assert rec["path"] == "reference" and rec["reason"] == "cpu tensors"


def test_packed_gather_sum_checks_its_inputs():
    table, idx, mask = _packed_inputs(M=8, R=4)
    packed = probes.pack_bf16(torch.from_numpy(table))
    i, w = torch.from_numpy(idx), torch.from_numpy(mask)
    with pytest.raises(ValueError, match="int32"):
        probes.packed_gather_sum(packed.float(), i, w)
    with pytest.raises(ValueError, match="idx"):
        probes.packed_gather_sum(packed, i.long(), w)
    with pytest.raises(ValueError, match="mask"):
        probes.packed_gather_sum(packed, i, w[:, :2].contiguous())
    with pytest.raises(ValueError, match="D even"):
        probes.pack_bf16(torch.zeros(3, 5))


# --------------------------------------------------------- the two tools


def test_probe_tools_run_on_the_cpu(monkeypatch):
    """Both probes at small shapes on the CPU: no times (there is no
    card), finite results, the packed check passed; main() takes only
    --device and runs the fixed shapes."""
    from lirec_tpu_torch.tools import probe_bf16_pack, probe_hbm_dma

    out = probe_hbm_dma.measure("cpu", n_clips=64, n_tracks=96, m=12)
    assert out["per_row_ms"] is None and out["per_run_ms"] is None
    assert out["shapes"]["idx"] == (12, 18, 3)
    out = probe_bf16_pack.measure(
        "cpu", {"probe": probe_bf16_pack.SHAPES["probe"]})
    assert out["probe"]["max_abs_err"] < 1e-5
    assert "packed_ms" not in out["probe"]
    for mod in (probe_hbm_dma, probe_bf16_pack):
        seen = []
        monkeypatch.setattr(mod, "measure", lambda device: seen.append(
            device) or {})
        mod.main(["--device", "cpu"])
        mod.main([])
        assert seen == ["cpu", "cuda"]
        with pytest.raises(SystemExit):
            mod.main(["--device", "cpu", "--m", "8"])
