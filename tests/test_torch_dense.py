"""The port's dense path (reference-layout ``features`` batches) against the
JAX package's: the dense forwards of models/midfusion.py and
models/modalities.py through apply_model, the dense host eval loop and a
dense train() run; and against the port's own packed forwards on the same
samples.

Small widths, weights made by the JAX package and converted with
params_from_jax, inputs from numpy seeds, torch on one thread. f32 at rtol
2e-6 of scale, bf16 at 4.1e-3 (ROADMAP.md queue 3's contract).
"""

import jax
import numpy as np
import pytest
import torch

from lirec_tpu import config as config_lib
from lirec_tpu.data import synthetic
from lirec_tpu.data.dataset import InteractionDataset
from lirec_tpu.models.factory import create_model as jax_create_model
from lirec_tpu.train.loop import train as jax_train
from lirec_tpu.utils.fake_batch import make_batch, make_tables
from lirec_tpu_torch import config as port_config
from lirec_tpu_torch.checkpoint import params_from_jax
from lirec_tpu_torch.data import synthetic as port_synthetic
from lirec_tpu_torch.data.dataset import InteractionDataset as PortDataset
from lirec_tpu_torch.data.pipeline import ASSEMBLY, BatchIterator
from lirec_tpu_torch.evaluation import packed as port_packed
from lirec_tpu_torch.models.blocks import FeatSlices, slices_from_dense
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.train.loop import train

N_CLIPS, N_TRACKS = 64, 96
PRESETS = ["int_rel_ch", "int_ch", "int_rels", "modalities"]
RTOL = {"float32": 2e-6, "bfloat16": 4.1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(preset, compute):
    cfg = config_lib.preset(preset)
    cfg = cfg.with_dims(text_dim=32, visual_dim=64, joint_dim=32)
    return cfg.with_runtime(compute_dtype=compute)


def _pair(preset, compute):
    cfg = _cfg(preset, compute)
    n_rels = 0 if preset == "modalities" else 6
    jb = jax_create_model(cfg, 9, n_rels=n_rels)
    pb = create_model(cfg, 9, n_rels=n_rels, device="cpu")
    pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                          jb.params)))
    return jb, pb


def _packed(spec, preset, B=3, seed=2):
    """A packed batch in the preset's layout: [B, T, 1+R, 3] (int_rel_ch),
    [B, T, 1, 3] (int_ch), [B, 1+R, 3] (int_rels), [B, 1, 3]
    (modalities)."""
    batch = make_batch(spec, B, N_CLIPS, N_TRACKS, seed=seed)
    out = {"feat_idx": batch["feat_idx"], "rels_mask": batch["rels_mask"]}
    if preset == "int_rels":
        out = {"feat_idx": batch["feat_idx"][:, 0],
               "rels_mask": batch["rels_mask"][:, 0][..., None]}
    elif preset == "int_ch":
        out = {"feat_idx": batch["feat_idx"][:, :, :1, :]}
    elif preset == "modalities":
        out = {"feat_idx": batch["feat_idx"][:, 0, :1, :]}
    return out


def _dense(packed, tables, preset):
    """The reference-layout rows of `packed`'s index triples (as
    InteractionDataset.to_dense gathers them); int_ch as [B, T, D], the
    dataset's ctx-off layout."""
    idx = packed["feat_idx"]
    feats = np.concatenate([tables["text"][idx[..., 0]],
                            tables["visual"][idx[..., 0]],
                            tables["track"][idx[..., 1]],
                            tables["track"][idx[..., 2]]], axis=-1)
    if preset == "int_ch":
        feats = feats[:, :, 0, :]
    out = {"features": feats}
    if "rels_mask" in packed:
        out["rels_mask"] = packed["rels_mask"]
    return out


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _assert_close_scaled(got, want, rel, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    assert not np.isnan(got).any(), name
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert (err <= rel * (np.abs(want) + scale)).all(), (
        "%s: worst |diff| %.3e (scale %.3e)" % (name, err.max(), scale))


def test_slices_from_dense_splits_any_leading_axes():
    spec = _pair("int_rel_ch", "float32")[1].spec
    D = spec.text_dim + spec.visual_dim + 2 * spec.track_dim
    x = torch.arange(2 * 3 * D, dtype=torch.float32).reshape(2, 3, D)
    s = slices_from_dense(x, spec)
    assert isinstance(s, FeatSlices)
    assert [a.shape[-1] for a in s] == [spec.text_dim, spec.visual_dim,
                                        spec.track_dim, spec.track_dim]
    assert torch.equal(torch.cat(list(s), dim=-1), x)
    assert torch.equal(s.index(slice(None), 0).text, x[:, 0, :spec.text_dim])


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", PRESETS)
def test_dense_forward_matches_jax(preset, compute):
    """apply_model's features branch on both sides (midfusion_forward,
    midfusion_maxtracks_forward with the ctx-off reshape, modalities_forward
    on the GT row), eval mode."""
    jb, pb = _pair(preset, compute)
    tables = make_tables(jb.spec, N_CLIPS, N_TRACKS, seed=1)
    dense = _dense(_packed(jb.spec, preset), tables, preset)
    want = jb.apply(jb.params, dense)
    with torch.no_grad():
        got = pb.apply(pb.model, _torch(dense))
    assert set(got) == set(want)
    for key, w in want.items():
        if w is None:
            assert got[key] is None, key
            continue
        _assert_close_scaled(got[key].numpy(), np.asarray(w), RTOL[compute],
                             "%s %s" % (preset, key))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", PRESETS)
def test_dense_forward_matches_the_packed_forward(preset, compute):
    """The port's dense forward and its packed eval forward (embed, then
    gather and pool; the plain pool on the CPU) on the same samples."""
    _, pb = _pair(preset, compute)
    tables = make_tables(pb.spec, N_CLIPS, N_TRACKS, seed=4)
    packed = _packed(pb.spec, preset, B=4, seed=5)
    dense = _dense(packed, tables, preset)
    with torch.no_grad():
        want = pb.apply(pb.model, _torch(packed), tables=_torch(tables))
        got = pb.apply(pb.model, _torch(dense))
    for key, w in want.items():
        if w is None:
            assert got[key] is None, key
            continue
        _assert_close_scaled(got[key].numpy(), w.numpy(), RTOL[compute],
                             "%s %s" % (preset, key))


def test_maxtracks_guards_an_empty_context_and_midfusion_does_not():
    """The reference's quirk: only the MaxTracks variant guards an empty
    context's divider (ref model.py:303)."""
    for preset, finite in (("int_rel_ch", True), ("int_rels", False)):
        _, pb = _pair(preset, "float32")
        tables = make_tables(pb.spec, N_CLIPS, N_TRACKS, seed=1)
        dense = _dense(_packed(pb.spec, preset), tables, preset)
        dense["rels_mask"] = np.zeros_like(dense["rels_mask"])
        with torch.no_grad():
            rels = pb.apply(pb.model, _torch(dense))["rels"]
        assert bool(torch.isfinite(rels).all()) == finite, preset


def test_dense_train_forward_draws_dropout():
    """deterministic=False with a generator draws the masks (the same
    generator seed, the same outputs; another seed, others)."""
    _, pb = _pair("int_rel_ch", "float32")
    tables = make_tables(pb.spec, N_CLIPS, N_TRACKS, seed=1)
    dense = _torch(_dense(_packed(pb.spec, "int_rel_ch"), tables,
                          "int_rel_ch"))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return pb.apply(pb.model, dense, deterministic=False,
                            rng=gen)["inters"]

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))


# ----------------------------------------------------- eval and train()


def _datasets(root, preset, mode, batch_size, dropout=None):
    out = []
    for lib, syn, dataset in ((config_lib, synthetic, InteractionDataset),
                              (port_config, port_synthetic, PortDataset)):
        base = syn.make_config(root)
        cfg = lib.preset(preset, data_root=root)
        cfg = cfg.replace(dims=base.dims, paths=base.paths).with_runtime(
            compute_dtype="float32").with_optim(batch_size=batch_size)
        if dropout is not None:
            cfg = cfg.with_optim(dropout=dropout, epochs=2, lr=1e-3,
                                 save_model=False)
        ds = dataset(cfg, mode=mode)
        ds.cache()
        if cfg.tasks.rels or cfg.tasks.rels_multitask:
            ds.init_relships()
        out.append((cfg, ds))
    return out


@pytest.mark.parametrize("preset,mode,batch_size", [
    ("int_rel_ch", "test", 8),
    ("int_ch", "test", 8),
    ("int_rels", "val", 5),
    ("modalities", "val", 8),
])
def test_dense_evaluate_matches_jax_and_the_packed_sweep(synth_root, preset,
                                                         mode, batch_size):
    """evaluate(dense=True) on both sides: the integer counters of the
    accumulators equal, the metric dict within rtol 2e-6; and the port's
    dense loop gives its packed sweep's metrics. The batches were dense
    (the dispatch record), and no tables were embedded."""
    from lirec_tpu.evaluation import runner as jax_runner
    from lirec_tpu_torch.evaluation import runner as port_runner

    (jc, jd), (pc, pd) = _datasets(synth_root, preset, mode, batch_size)
    n_rels = max(len(jd.rels_list) - 1, 0)
    jb = jax_create_model(jc, jd.n_classes, n_rels=n_rels)
    pb = create_model(pc, pd.n_classes, n_rels=n_rels, device="cpu")
    pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                          jb.params)))
    want = jax_runner.evaluate(jd, jb, jb.params, jc, mode=mode, dense=True,
                               verbose=False, return_details=True)
    got = port_runner.evaluate(pd, pb, pb.model, pc, mode=mode, dense=True,
                               verbose=False, return_details=True)
    assert dispatch.last_dispatch(ASSEMBLY)["path"] == "per-sample"
    assert dispatch.last_dispatch(ASSEMBLY)["reason"] == "dense"
    assert dispatch.last_dispatch("eval_loop")["shapes"]["dense"] is True
    keys = {k for k in want if k not in ("conf_mat", "accumulator",
                                         "rels_accumulator")}
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=2e-6, atol=1e-7,
                                   err_msg=key)
    np.testing.assert_array_equal(got["conf_mat"], want["conf_mat"])
    ints = {k: v for k, v in vars(want["accumulator"]).items()
            if isinstance(v, (int, np.integer))}
    assert ints and {k: vars(got["accumulator"])[k] for k in ints} == ints
    assert sum(v for k, v in ints.items() if k != "n_rels") > 0
    if "rels_accumulator" in want:
        assert dict(got["rels_accumulator"]._gt) == dict(
            want["rels_accumulator"]._gt)
    packed = port_packed.evaluate_packed(pd, pb, pb.model, pc, mode=mode,
                                         verbose=False)
    for key in packed:
        np.testing.assert_allclose(got[key], packed[key], rtol=2e-6,
                                   atol=1e-7, err_msg=key)


def test_dense_batches_are_the_packed_batches_gathered(synth_root):
    """BatchIterator(dense=True) gives the packed per-sample batches with
    feat_idx replaced by the gathered features, bitwise."""
    (_, _), (_, pd) = _datasets(synth_root, "int_rel_ch", "train", 5)
    dense = list(BatchIterator(pd, 5, shuffle=True, seed=1, dense=True))
    packed = list(BatchIterator(pd, 5, shuffle=True, seed=1,
                                fast_assembly=False))
    tb = pd.tables
    assert len(dense) == len(packed)
    for d, p in zip(dense, packed):
        idx = p.pop("feat_idx")
        feats = np.concatenate([tb.text[idx[..., 0]], tb.visual[idx[..., 0]],
                                tb.track[idx[..., 1]], tb.track[idx[..., 2]]],
                               axis=-1)
        np.testing.assert_array_equal(d.pop("features"), feats)
        assert sorted(d) == sorted(p)
        for k in p:
            np.testing.assert_array_equal(d[k], p[k], err_msg=k)


def test_dense_train_matches_jax(pinned_dense_root):
    """train(dense=True) on both sides, f32, dropout 0, 2 epochs at batch 8
    (the port pads the last batch of 6 with loss_weight 0; JAX runs it
    unpadded): per-epoch losses and final parameters within rtol 1e-5 of
    scale, as tests/test_torch_train.py holds the packed runs; the dense
    cadence (the host loop over dense batches) gives the same saver
    table on both sides."""
    (jc, jd), (pc, pd) = _datasets(pinned_dense_root, "int_rel_ch", "train",
                                   8, dropout=0.0)
    n_rels = max(len(jd.rels_list) - 1, 0)
    jb = jax_create_model(jc, jd.n_classes, n_rels=n_rels)
    want = jax_train(jc, jb, jd, val_dataset=jd, verbose=False, dense=True)
    pb = create_model(pc, pd.n_classes, n_rels=n_rels, device="cpu")
    pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                          jb.params)))
    got = train(pc, pb, pd, val_dataset=pd, verbose=False, dense=True)
    assert got["localized_tables"] is False
    assert dispatch.last_dispatch("eval_loop")["shapes"]["dense"] is True
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    final = params_from_jax(jax.tree.map(np.asarray, want["params"]))
    for name, p in got["model"].named_parameters():
        _assert_close_scaled(p.detach(), final[name], 1e-5, name)
    assert set(got["saver"].eval) == set(want["saver"].eval)
    for key, kept in want["saver"].eval.items():
        assert list(got["saver"].eval[key]) == list(kept), key
        np.testing.assert_allclose(list(got["saver"].eval[key].values()),
                                   list(kept.values()), rtol=2e-6,
                                   err_msg=key)


@pytest.fixture(scope="module")
def pinned_dense_root(tmp_path_factory):
    """The synthetic fixture under a fixed string-hash seed (see
    tests/test_torch_train.py's pinned_synth_root)."""
    import os
    import subprocess
    import sys

    root = str(tmp_path_factory.mktemp("mg_dense_pinned"))
    subprocess.run(
        [sys.executable, "-c", "import sys; from lirec_tpu.data import "
         "synthetic; synthetic.generate(sys.argv[1])", root],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        check=True, env=dict(os.environ, PYTHONHASHSEED="7"))
    return root
