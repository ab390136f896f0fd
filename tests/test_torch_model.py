"""The port's eval slice against the JAX package, module by module and whole.

Small widths (text 32, visual 64, joint 256: the JAX kernel's 128-multiple
gates hold in interpret mode), the int_rel_ch preset's geometry (T = 20
hypotheses, R = 18 context clips), weights made by the JAX package and
converted with params_from_jax, inputs from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lirec_tpu import config as config_lib
from lirec_tpu.models import layers as jax_layers
from lirec_tpu.models import tabular as jax_tabular
from lirec_tpu.models.factory import create_model as jax_create_model
from lirec_tpu.ops.gather_pool import pack_bf16_table
from lirec_tpu.utils.fake_batch import make_batch, make_tables
from lirec_tpu_torch.checkpoint import params_from_jax
from lirec_tpu_torch.models import layers, tabular
from lirec_tpu_torch.models.factory import create_model

N_CLIPS, N_TRACKS = 64, 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU tanh, run for the first time across several threads, has
    been seen to return values ~4e-5 off; one thread keeps the plain
    versions deterministic at these tolerances."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(preset="int_rel_ch", compute="float32", joint=256):
    cfg = config_lib.preset(preset)
    cfg = cfg.with_dims(text_dim=32, visual_dim=64, joint_dim=joint)
    return cfg.with_runtime(compute_dtype=compute)


def _pair(preset="int_rel_ch", compute="float32"):
    """(JAX bundle, port bundle) with the same weights."""
    cfg = _cfg(preset, compute)
    jb = jax_create_model(cfg, 9, n_rels=6)
    pb = create_model(cfg, 9, n_rels=6, device="cpu")
    pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                          jb.params)))
    return jb, pb


def _tables(spec, seed=1):
    np_tables = make_tables(spec, N_CLIPS, N_TRACKS, seed=seed)
    return ({k: jnp.asarray(v) for k, v in np_tables.items()},
            {k: torch.from_numpy(v) for k, v in np_tables.items()})


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_linear(compute):
    """f32: two f32 GEMMs, sums in another order (rtol 2e-6, atol 1e-6).
    bf16 compute: both round x and the weight to bf16 and keep an f32
    result; bf16 x bf16 products are exact in f32, so only the f32 sum
    order differs (same tolerance)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 96)).astype(np.float32)
    kernel = (rng.standard_normal((96, 40)) / 10).astype(np.float32)
    bias = rng.standard_normal(40).astype(np.float32)
    jcdt = jnp.bfloat16 if compute == "bfloat16" else None
    want = np.asarray(jax_layers.linear(
        {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)},
        jnp.asarray(x), jcdt))
    layer = torch.nn.Linear(96, 40)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(kernel.T.copy()))
        layer.bias.copy_(torch.from_numpy(bias))
    cdt = torch.bfloat16 if compute == "bfloat16" else None
    got = layers.linear(layer, torch.from_numpy(x), cdt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-6,
                               atol=1e-6)


def test_init_linear_is_seeded_uniform():
    a = layers.init_linear(50, 30, torch.Generator().manual_seed(3))
    b = layers.init_linear(50, 30, torch.Generator().manual_seed(3))
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    assert a.weight.shape == (30, 50)
    bound = 1 / np.sqrt(50)
    for p in (a.weight.detach(), a.bias.detach()):
        assert float(p.abs().max()) <= bound
        assert float(p.abs().max()) > 0.8 * bound  # not a degenerate draw


def test_create_model_names_follow_the_reference():
    """Every JAX parameter has its port counterpart under the reference
    checkpoint's name and [out, in] shape, and nothing else exists."""
    jb, pb = _pair()
    state = pb.model.state_dict()
    want = params_from_jax(jax.tree.map(np.asarray, jb.params))
    assert set(state) == set(want)
    assert "gates_ints.fc_out.weight" in state
    for k, v in want.items():
        assert state[k].shape == v.shape, k


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_embed_all(compute):
    """f32 compute: rtol 2e-6 / atol 1e-5 (f32 GEMM sum order). bf16
    compute: the second layer of each MLP rounds the first layer's f32
    output to bf16, and values one f32 ulp apart on the two sides can round
    to neighbouring bf16 values: atol 2e-3, as the bf16 slice below. The
    port stores the ctx tables themselves in bf16, which adds their own
    rounding (2^-8 relative)."""
    jb, pb = _pair(compute=compute)
    jt, pt = _tables(jb.spec)
    want = jax_tabular.embed_all(jb.params, jb.spec, jt)
    with torch.inference_mode():
        got = tabular.embed_all(pb.model, pb.spec, pt)
    assert set(got) == {"ints", "ctx"}
    bf16 = compute == "bfloat16"
    for branch in ("ints", "ctx"):
        dtype = torch.bfloat16 if bf16 and branch == "ctx" else torch.float32
        for g, w in zip(got[branch], want[branch]):
            assert g.dtype == dtype
            np.testing.assert_allclose(
                g.float().numpy(), np.asarray(w),
                rtol=2.0 ** -8 if dtype == torch.bfloat16 else 2e-6,
                atol=2e-3 if bf16 else 1e-5, err_msg=branch,
            )


@pytest.mark.parametrize("use_pallas", ["interpret", False])
def test_maxtracks_slice_f32(use_pallas):
    """The whole midfusion_maxtracks_tabular forward (f32 compute): JAX
    embeds inside apply_model and pools with its Pallas kernel (interpret)
    or its jnp path; the port pools with its plain version. rtol 2e-6 /
    atol 1e-5: f32 GEMMs and pools summed in another order."""
    jb, pb = _pair()
    jt, pt = _tables(jb.spec)
    batch = make_batch(jb.spec, 2, N_CLIPS, N_TRACKS, seed=2)
    mb = {k: batch[k] for k in ("feat_idx", "rels_mask")}
    want = jb.apply(jb.params, mb, tables=jt, use_pallas=use_pallas)
    with torch.inference_mode():
        got = pb.apply(pb.model, mb, tables=pt)
    for key in ("inters", "rels"):
        assert tuple(got[key].shape) == np.asarray(want[key]).shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=2e-6, atol=1e-5, err_msg=key)


def test_maxtracks_slice_bf16():
    """bf16 compute. The JAX side gets embedded ctx tables passed through
    pack_bf16_table (its TPU table layout) and pools them with its jnp path,
    which unpacks; the port embeds with its own embed_all (bf16 ctx tables).
    atol 2e-3: every GEMM rounds its inputs to bf16, and a value one f32 ulp
    apart on the two sides can round to neighbouring bf16 values."""
    jb, pb = _pair(compute="bfloat16")
    jt, pt = _tables(jb.spec)
    emb = jax_tabular.embed_all(jb.params, jb.spec, jt)
    emb["ctx"] = jax_tabular.EmbeddedTables(
        *(pack_bf16_table(t) for t in emb["ctx"]))
    batch = make_batch(jb.spec, 3, N_CLIPS, N_TRACKS, seed=3)
    mb = {k: batch[k] for k in ("feat_idx", "rels_mask")}
    want = jb.apply(jb.params, mb, tables=jt, embedded=emb, use_pallas=False)
    with torch.inference_mode():
        embedded = tabular.embed_all(pb.model, pb.spec, pt)
        got = pb.apply(pb.model, mb, embedded=embedded)
    for key in ("inters", "rels"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=2e-3, err_msg=key)


def test_midfusion_slice_unguarded_empty_context():
    """int_rels (MidFusionMultiClip): the same pool without the zero-divider
    guard, so a sample without context has NaN relationship logits in both
    packages. Tolerance as the f32 maxtracks slice."""
    jb, pb = _pair(preset="int_rels")
    jt, pt = _tables(jb.spec)
    batch = make_batch(jb.spec, 3, N_CLIPS, N_TRACKS, seed=4)
    mb = {"feat_idx": batch["feat_idx"][:, 0],
          "rels_mask": batch["rels_mask"][:, 0].copy()}
    mb["rels_mask"][1] = 0
    want = jb.apply(jb.params, mb, tables=jt, use_pallas=False)
    with torch.inference_mode():
        got = pb.apply(pb.model, mb, tables=pt)
    assert np.isnan(np.asarray(want["rels"][1])).all()
    for key in ("inters", "rels"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=2e-6, atol=1e-5, equal_nan=True,
                                   err_msg=key)


def test_apply_rejects_what_is_not_ported():
    """Dense `features` batches, refused before, now run through the dense
    forwards, for the mid-fusion and the Modalities models (parity with
    the JAX package: tests/test_torch_dense.py); a row of the wrong width
    is refused by the first layer."""
    _, pb = _pair()
    s = pb.spec
    width = s.text_dim + s.visual_dim + 2 * s.track_dim
    out = pb.apply(pb.model, {
        "features": np.zeros((2, 3, 5, width), np.float32),
        "rels_mask": np.ones((2, 3, 4), np.float32)})
    assert tuple(out["inters"].shape) == (2, 3, s.n_classes)
    assert tuple(out["rels"].shape) == (2, 3, s.n_rels)
    with pytest.raises(RuntimeError):
        pb.apply(pb.model, {"features": np.zeros((1, 4), np.float32)})
    mod = create_model(config_lib.preset("modalities"), 9, device="cpu")
    s = mod.spec
    width = s.text_dim + s.visual_dim + 2 * s.track_dim
    out = mod.apply(mod.model, {"features": np.zeros((2, 1, width),
                                                     np.float32)})
    assert tuple(out["inters"].shape) == (2, 9)
