"""The grounding configurations against the JAX package: int_ch (weak and
ground-truth track supervision, ``tr_correct``) and GT int_rel_ch, the
three published checkpoints besides the int_rel_ch, int_rels and
modalities models.

int_ch has no context branch, so it runs no pool and no scatter kernel;
the GT losses (``tr_correct=True``: ``margin`` and ``margin_track_rels``
supervised by the ground-truth track pair) are what the card must capture
in the epoch sweep's CUDA graph without a host sync. Here, on the CPU, at
small widths on the synthetic fixture (written under a fixed string-hash
seed), f32, dropout 0 against the JAX package, torch on one thread:
int_ch's /predict against the JAX engine, three training steps of each
configuration from the JAX package's initial weights, and the epoch
sweep's eager path against the port's own per-batch path. The card runs
them at published widths (chip_smoke.py phase 23; its graphs in
tests/test_torch_cuda.py).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lirec_tpu import config as config_lib
from lirec_tpu.cli.serve import InferenceEngine as JaxEngine
from lirec_tpu.data import synthetic
from lirec_tpu.data.dataset import InteractionDataset
from lirec_tpu.models.factory import create_model as jax_create_model
from lirec_tpu.train.loop import train as jax_train
from lirec_tpu.utils.fake_batch import make_batch, make_tables
from lirec_tpu_torch import config as port_config
from lirec_tpu_torch.checkpoint import params_from_jax
from lirec_tpu_torch.cli.serve import InferenceEngine
from lirec_tpu_torch.data import synthetic as port_synthetic
from lirec_tpu_torch.data.dataset import InteractionDataset as PortDataset
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.train.loop import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLIPS, N_TRACKS = 32, 48
# (preset, tr_correct): weak and GT int_ch, GT int_rel_ch
CONFIGS = [("int_ch", False), ("int_ch", True), ("int_rel_ch", True)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pinned_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mg_grounding"))
    subprocess.run(
        [sys.executable, "-c", "import sys; from lirec_tpu.data import "
         "synthetic; synthetic.generate(sys.argv[1])", root],
        cwd=ROOT, check=True, env=dict(os.environ, PYTHONHASHSEED="7"))
    return root


# ------------------------------------------------------------- /predict


@pytest.mark.parametrize("tr_correct", [False, True])
@pytest.mark.parametrize("B", [1, 7])
def test_int_ch_predict_matches_jax_engine(B, tr_correct):
    """int_ch's engine (no context: requests are [B, T, 1, 3], no rels
    mask) on the JAX package's weights: track scores within 1e-5 (both
    round to 6 decimals; the f32 logits agree to ~1e-6), the same best
    track and the same top interactions wherever no near-tie (1e-4) could
    flip them; no relationships and no kernel launch."""
    cfg = config_lib.preset("int_ch", data_root="/tmp/x",
                            tr_correct=tr_correct)
    cfg = cfg.with_dims(text_dim=16, visual_dim=32, joint_dim=16)
    cfg = cfg.with_runtime(compute_dtype="float32")
    jb = jax_create_model(cfg, 9, n_rels=6)
    pb = create_model(cfg, 9, n_rels=6, device="cpu")
    pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                          jb.params)))
    tables = make_tables(jb.spec, N_CLIPS, N_TRACKS, seed=1)
    engine = InferenceEngine(pb, tables, device="cpu", topk=3, max_batch=8)
    jax_engine = JaxEngine(jb, tables, topk=3, max_batch=8)
    assert (engine.n_hyps, engine.n_ctx) == (20, 1)
    batch = make_batch(jb.spec, B, N_CLIPS, N_TRACKS, seed=20 + B)
    feat_idx = np.ascontiguousarray(batch["feat_idx"][:, :, :1])
    rels_mask = np.zeros((B, 20, 0), np.int32)
    before = dispatch.launches()
    got = engine.predict(feat_idx, rels_mask)
    assert dispatch.launches() == before
    want = jax_engine.predict(feat_idx, rels_mask)
    assert len(got) == len(want) == B
    for p, j in zip(got, want):
        assert "relationships" not in p and "relationships" not in j
        assert all(0 <= x["score"] <= 1 for x in p["interactions"])
        np.testing.assert_allclose(p["track_scores"], j["track_scores"],
                                   rtol=0, atol=1e-5)
        top = np.sort(j["track_scores"])[::-1]
        if top[0] - top[1] > 1e-4:
            assert p["best_track"] == j["best_track"]
        if p["best_track"] == j["best_track"]:
            ws = [x["score"] for x in j["interactions"]]
            np.testing.assert_allclose([x["score"] for x in p[
                "interactions"]], ws, rtol=0, atol=1e-5)
            if min(np.diff(sorted(ws))) > 1e-4:
                assert ([x["label"] for x in p["interactions"]]
                        == [x["label"] for x in j["interactions"]])
    with pytest.raises(ValueError, match=r"\[B, 20, 1, 3\]"):
        engine.predict(np.ascontiguousarray(batch["feat_idx"]),
                       batch["rels_mask"])


# ------------------------------------------------------------- training


def _setup(root, preset, tr_correct, port, dropout=0.0, epochs=1):
    """(cfg, train dataset) of `preset` on the fixture at batch 8: 22
    samples, so an epoch is three steps (the last batch of 6)."""
    cfg_lib, synth, dataset = ((port_config, port_synthetic, PortDataset)
                               if port else
                               (config_lib, synthetic, InteractionDataset))
    base = synth.make_config(root)
    cfg = cfg_lib.preset(preset, data_root=root, tr_correct=tr_correct)
    cfg = cfg.replace(dims=base.dims, paths=base.paths).with_runtime(
        compute_dtype="float32").with_optim(
        batch_size=8, epochs=epochs, save_model=False, lr=1e-3,
        dropout=dropout)
    assert cfg.tasks.tr_correct == tr_correct
    ds = dataset(cfg, mode="train")
    ds.cache()
    if cfg.tasks.rels_multitask:
        ds.init_relships()
    return cfg, ds


def _assert_close_scaled(got, want, rel, name):
    """|got - want| <= rel * (|want| + max|want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max()) if want.size else 0.0
    bad = np.abs(got - want) > rel * (np.abs(want) + scale)
    assert not bad.any(), "%s: %d of %d beyond the bound; worst %.3e" % (
        name, bad.sum(), bad.size, float(np.abs(got - want).max()))


@pytest.mark.parametrize("preset,tr_correct", CONFIGS)
def test_three_training_steps_match_jax(pinned_root, preset, tr_correct):
    """One epoch at batch 8 (three Adam steps, the last batch of 6: padded
    with loss_weight 0 by the port, unpadded in JAX) through both
    packages' per-batch loops from the JAX package's initial weights,
    dropout 0, tr_cat_distr off: the epoch's mean loss within rtol 2e-6,
    and the parameters after the three steps within 1e-5 of each tensor's
    scale (Adam divides by the root of the second moment, so an f32
    difference of a near-zero gradient moves a weight by up to a step's
    share; tests/test_torch_train.py holds its trajectories so too)."""
    cfg, ds = _setup(pinned_root, preset, tr_correct, port=False)
    n_rels = max(len(ds.rels_list) - 1, 0)
    jb = jax_create_model(cfg, ds.n_classes, n_rels=n_rels)
    want = jax_train(cfg, jb, ds, verbose=False, epoch_sweep=False)
    pcfg, pds = _setup(pinned_root, preset, tr_correct, port=True)
    pb = create_model(pcfg, pds.n_classes, n_rels=n_rels, device="cpu")
    pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                          jb.params)))
    before = dispatch.launches()
    got = train(pcfg, pb, pds, verbose=False, epoch_sweep=False)
    assert dispatch.launches() == before
    assert len(got["losses"]) == len(want["losses"]) == 1
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-6)
    final = params_from_jax(jax.tree.map(np.asarray, want["params"]))
    for name, p in pb.model.named_parameters():
        _assert_close_scaled(p.detach(), final[name], 1e-5, name)


@pytest.mark.parametrize("preset,tr_correct", CONFIGS)
def test_epoch_sweep_is_the_per_batch_path_bit_for_bit(pinned_root, preset,
                                                      tr_correct):
    """The epoch sweep's eager path (the CPU sweep: the epoch's batches
    stacked, each step taken from the stack) against the per-batch path,
    dropout 0.3 and the same step generators, two epochs: the same losses
    and parameters bit for bit (the CPU's mean is a sum over the count, as
    the sweep's weighted mean is), with the sweep recorded as taken."""
    runs = {}
    for sweep in (False, True):
        cfg, ds = _setup(pinned_root, preset, tr_correct, port=True,
                         dropout=0.3, epochs=2)
        pb = create_model(cfg, ds.n_classes,
                          n_rels=max(len(ds.rels_list) - 1, 0),
                          device="cpu", seed=0)
        out = train(cfg, pb, ds, verbose=False, epoch_sweep=sweep)
        assert out["epoch_sweep_used"] == sweep
        runs[sweep] = out["losses"], pb.model.state_dict()
    assert runs[True][0] == runs[False][0]
    assert all(np.isfinite(runs[True][0]))
    for k, v in runs[False][1].items():
        assert torch.equal(runs[True][1][k], v), k
