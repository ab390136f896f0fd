"""The port's Modalities model (models/modalities.py, the tabular and hybrid
forwards, the factory, the ``modalities`` CLI and serving) against the JAX
package's, on the CPU.

Small widths (text 32, visual and track 48, joint 16), weights made by the
JAX package and converted with params_from_jax, inputs from numpy seeds,
torch on one thread. f32 is held at rtol 2e-6 of each tensor's scale (f32
sums in another order), bf16 compute at 4.1e-3, integer counters exactly.
"""

import jax
import numpy as np
import pytest
import torch

from lirec_tpu import config as config_lib
from lirec_tpu.cli.common import run_entry as jax_run_entry
from lirec_tpu.models.factory import create_model as jax_create_model
from lirec_tpu_torch.checkpoint import params_from_jax
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.models.modalities import Modalities
from lirec_tpu_torch.models.tabular import embed_all

N_CLIPS, N_TRACKS, N_CLASSES = 40, 60, 9
DIM_ARGS = ["--text-dim", "16", "--visual-dim", "32", "--text-layers", "4",
            "--joint-dim", "16", "--compute-dtype", "float32"]
LAYOUTS = [(m, tr) for m in "mtv" for tr in (True, False)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(modality="m", tracks=True, compute="float32"):
    cfg = config_lib.preset("modalities")
    cfg = cfg.with_dims(text_dim=32, visual_dim=48, joint_dim=16)
    cfg = cfg.with_tasks(modality=modality, tracks=tracks)
    return cfg.with_runtime(compute_dtype=compute)


def _pair(modality="m", tracks=True, compute="float32"):
    cfg = _cfg(modality, tracks, compute)
    jb = jax_create_model(cfg, N_CLASSES)
    pb = create_model(cfg, N_CLASSES, device="cpu")
    pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                          jb.params)))
    return jb, pb


def _inputs(B=6, seed=3):
    rng = np.random.default_rng(seed)
    tables = {
        "text": rng.standard_normal((N_CLIPS, 32)).astype(np.float32),
        "visual": rng.standard_normal((N_CLIPS, 48)).astype(np.float32),
        "track": rng.standard_normal((N_TRACKS, 48)).astype(np.float32),
    }
    feat_idx = np.stack([rng.integers(0, N_CLIPS, (B, 1)),
                         rng.integers(0, N_TRACKS, (B, 1)),
                         rng.integers(0, N_TRACKS, (B, 1))],
                        axis=-1).astype(np.int32)
    batch = {
        "feat_idx": feat_idx,
        "labels": rng.integers(0, N_CLASSES, B).astype(np.int32),
        "multilab_weights": (rng.random((B, N_CLASSES)) < 0.9).astype(
            np.float32),
    }
    return tables, batch


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _assert_close_scaled(got, want, rel, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert (err <= rel * (np.abs(want) + scale)).all(), (
        "%s: worst |diff| %.3e (scale %.3e)" % (name, err.max(), scale))


@pytest.mark.parametrize("modality,tracks", LAYOUTS)
def test_parameters_carry_the_reference_names(modality, tracks):
    """The port's state_dict has the reference's names and shapes
    (params_from_jax of the JAX tree loads strictly), and the head takes
    the JAX package's input width."""
    jb, pb = _pair(modality, tracks)
    assert isinstance(pb.model, Modalities)
    want = params_from_jax(jax.tree.map(np.asarray, jb.params))
    got = pb.model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    names = {k.split(".")[0] for k in got}
    expect = {"out_ints"}
    if modality in "mt":
        expect |= {"txt_ints", "txt2_ints"}
    if modality in "mv":
        expect |= {"vis_ints", "vis2_ints"}
    if tracks:
        expect |= {"tracks1_ints", "tracks2_ints", "tracks12_ints",
                   "tracks22_ints"}
    assert names == expect
    if tracks:  # j -> j / 2
        assert tuple(got["tracks12_ints.weight"].shape) == (8, 16)


@pytest.mark.parametrize("forward", ["tabular", "hybrid"])
@pytest.mark.parametrize("modality,tracks", LAYOUTS)
def test_forwards_match_jax(modality, tracks, forward):
    """modalities_tabular (eval) and modalities_hybrid (deterministic=True)
    against the JAX package's, f32 at rtol 2e-6. Under 't' / 'v' with
    tracks on, the head's input width counts the track branches that only
    'm' concatenates: both packages raise there (ROADMAP.md queue 3)."""
    jb, pb = _pair(modality, tracks)
    tables, batch = _inputs()
    mb = {"feat_idx": batch["feat_idx"]}
    use_tabular = forward == "tabular"

    def jax_forward():
        return jb.apply(jb.params, mb, tables=tables, deterministic=True,
                        use_tabular=use_tabular)

    def port_forward():
        with torch.no_grad():
            return pb.apply(pb.model, _torch(mb), tables=_torch(tables),
                            deterministic=True, use_tabular=use_tabular)

    if tracks and modality != "m":
        with pytest.raises(TypeError):
            jax_forward()
        with pytest.raises(RuntimeError):
            port_forward()
        return
    want, got = jax_forward(), port_forward()
    assert got["inters"].shape == (6, N_CLASSES)
    _assert_close_scaled(got["inters"].numpy(), want["inters"], 2e-6,
                         "inters")


@pytest.mark.parametrize("forward", ["tabular", "hybrid"])
def test_bf16_forwards_match_jax(forward):
    """bf16 compute (each GEMM rounds its operands to bf16, f32 results):
    the logits within 4.1e-3 of the tensor's scale."""
    jb, pb = _pair(compute="bfloat16")
    tables, batch = _inputs(seed=5)
    mb = {"feat_idx": batch["feat_idx"]}
    use_tabular = forward == "tabular"
    want = jb.apply(jb.params, mb, tables=tables, deterministic=True,
                    use_tabular=use_tabular)
    with torch.no_grad():
        got = pb.apply(pb.model, _torch(mb), tables=_torch(tables),
                       deterministic=True, use_tabular=use_tabular)
    _assert_close_scaled(got["inters"].numpy(), want["inters"], 4.1e-3,
                         "inters")


@pytest.mark.parametrize("modality,tracks", [("m", True), ("t", False),
                                             ("v", False)])
def test_embedded_branches_give_the_table_forward(modality, tracks):
    """The eval forward over embed_all's cached branch MLPs is bitwise the
    forward that runs them over the tables, and equals the hybrid forward
    without dropout (the same GEMMs, gathered before or after the second
    layer: rtol 2e-6)."""
    _, pb = _pair(modality, tracks)
    tables, batch = _inputs(seed=7)
    tt, mb = _torch(tables), {"feat_idx": torch.from_numpy(
        batch["feat_idx"])}
    with torch.no_grad():
        embedded = embed_all(pb.model, pb.spec, tt)
        assert set(embedded) == {"mod"}
        cached = pb.apply(pb.model, mb, embedded=embedded)["inters"]
        direct = pb.apply(pb.model, mb, tables=tt)["inters"]
        hybrid = pb.apply(pb.model, mb, tables=tt,
                          use_tabular=False)["inters"]
    assert torch.equal(cached, direct)
    _assert_close_scaled(hybrid.numpy(), direct.numpy(), 2e-6, "hybrid")


@pytest.mark.parametrize("compute,rel", [("float32", 2e-6),
                                         ("bfloat16", 4.1e-3)])
def test_loss_gradients_match_jax(compute, rel):
    """max_margin_ce_loss through the hybrid forward (deterministic=True):
    the loss and the gradient of every parameter against jax.grad."""
    jb, pb = _pair(compute=compute)
    tables, batch = _inputs(seed=11)
    mb = {"feat_idx": batch["feat_idx"]}

    def jloss(params):
        out = jb.apply(params, mb, tables=tables, deterministic=True,
                       use_tabular=False)
        return jb.loss(out, batch)

    want_loss, want_grads = jax.value_and_grad(jloss)(jb.params)
    out = pb.apply(pb.model, _torch(mb), tables=_torch(tables),
                   deterministic=True, use_tabular=False)
    loss = pb.loss(out, _torch(batch))
    loss.backward()
    _assert_close_scaled(loss.item(), want_loss, rel, "loss")
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    got = {n: p.grad for n, p in pb.model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        # bf16: a weight gradient ends in a bf16 rounding on both sides
        extra = np.abs(want[name].numpy()) * 2.0 ** -8 if \
            compute == "bfloat16" else 0.0
        err = np.abs(g.numpy() - want[name].numpy())
        scale = float(np.abs(want[name].numpy()).max())
        bound = rel * (np.abs(want[name].numpy()) + scale) + extra
        assert (err <= bound).all(), (name, float(err.max()), scale)


def test_dropout_draws_the_jax_call_order():
    """In training, with tracks on, every branch draws its mask (the track
    branches under 't' too, as in the JAX package): five masks under 'm',
    then a different draw per generator seed."""
    from lirec_tpu_torch.models import hybrid, layers

    _, pb = _pair()
    tables, batch = _inputs(seed=2)
    calls = []
    orig = layers.DropoutRng.__init__

    def spy(self, generator):
        orig(self, generator)
        calls.append(self)

    try:
        layers.DropoutRng.__init__ = spy
        gen = torch.Generator().manual_seed(1)
        out = hybrid.modalities_hybrid(
            pb.model, pb.spec, _torch(tables),
            torch.from_numpy(batch["feat_idx"]), deterministic=False,
            rng=gen)
    finally:
        layers.DropoutRng.__init__ = orig
    assert calls[-1].calls == 5
    again = hybrid.modalities_hybrid(
        pb.model, pb.spec, _torch(tables),
        torch.from_numpy(batch["feat_idx"]), deterministic=False,
        rng=torch.Generator().manual_seed(2))
    assert not torch.equal(out["inters"], again["inters"])


# ------------------------------------------------------------ the CLI


def test_cli_trains_and_evaluates_its_checkpoint_as_jax_does(synth_root,
                                                             tmp_path):
    """The modalities CLI with --train (2 epochs, finite losses, the
    nominal train split is val), then train -> 0.pth.tar -> eval of both
    splits, as tests/test_end_to_end.py does for the JAX package; the JAX
    package's eval of the same .pth.tar gives the same metrics."""
    from lirec_tpu_torch.cli import common, modalities

    assert common.TRAIN_SPLIT["modalities"] == "val"
    store = str(tmp_path / "st")
    base = ["--data-root", synth_root, "--store-root", store,
            "--batch-size", "8", "--quiet"] + DIM_ARGS
    out = modalities.main(base + ["--train", "--epochs", "2", "--device",
                                  "cpu"])
    losses = out["train"]["losses"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    ckpt = store + "/1.pth.tar"
    got = modalities.main(base + ["--resume-path", ckpt, "--device", "cpu"])
    host = modalities.main(base + ["--resume-path", ckpt, "--device", "cpu",
                                   "--host-eval"])
    want = jax_run_entry("modalities", base + ["--resume-path", ckpt])
    for split in ("val", "test"):
        assert set(got[split]) == set(want[split]) == {"total", "ints",
                                                       "loss"}
        for key, v in want[split].items():
            np.testing.assert_allclose(got[split][key], v, rtol=2e-6,
                                       atol=1e-7, err_msg=key)
            np.testing.assert_allclose(host[split][key], v, rtol=2e-6,
                                       atol=1e-7, err_msg=key)


def test_run_entry_trains_modalities(synth_root, tmp_path):
    """run_entry("modalities", --train ...), the JAX package's smoke test
    (tests/test_end_to_end.py:90) on the port."""
    from lirec_tpu_torch.cli.common import run_entry

    out = run_entry(
        "modalities",
        ["--data-root", synth_root, "--store-root", str(tmp_path / "s2"),
         "--train", "--epochs", "2", "--batch-size", "8", "--quiet",
         "--device", "cpu"] + DIM_ARGS)
    assert len(out["train"]["losses"]) == 2
    assert np.isfinite(out["train"]["losses"]).all()


def test_serve_answers_predict_for_modalities(synth_root):
    """serve --preset modalities on the CPU: the engine shapes feat_idx
    [B, 1, 3] (no context), answers /predict over HTTP, and its scores are
    the sigmoid of the JAX forward's logits on the same weights."""
    import json
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from lirec_tpu.data import synthetic
    from lirec_tpu.data.dataset import InteractionDataset
    from lirec_tpu_torch.cli.serve import (
        build_engine_from_args, make_handler, make_parser,
    )

    args = make_parser().parse_args(
        ["--data-root", synth_root, "--preset", "modalities", "--split",
         "val", "--device", "cpu", "--text-dim", "16", "--visual-dim", "32",
         "--text-layers", "4", "--joint-dim", "16"])
    engine = build_engine_from_args(args)
    assert (engine.n_hyps, engine.n_ctx) == (1, 1)
    engine.warm([1, 3])
    rng = np.random.default_rng(4)
    fi = np.stack([rng.integers(0, engine.n_clip_rows, 5),
                   rng.integers(0, engine.n_track_rows, 5),
                   rng.integers(0, engine.n_track_rows, 5)],
                  axis=-1).astype(np.int32)[:, None, :]
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            "http://127.0.0.1:%d/predict" % httpd.server_port,
            data=json.dumps({"samples": [{"feat_idx": f.tolist()}
                                         for f in fi]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            preds = json.loads(resp.read())["predictions"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert len(preds) == 5
    assert all("relationships" not in p and len(p["interactions"]) == 5
               for p in preds)

    base = synthetic.make_config(synth_root)
    cfg = config_lib.preset("modalities", data_root=synth_root).replace(
        dims=base.dims, paths=base.paths)
    ds = InteractionDataset(cfg, mode="val")
    ds.cache()
    jb = jax_create_model(cfg, ds.n_classes)
    engine.bundle.model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, jb.params)))
    engine.embedded = embed_all(engine.bundle.model, engine.bundle.spec,
                                _torch(ds.tables.as_dict()))
    logits = np.asarray(jb.apply(jb.params, {"feat_idx": fi},
                                 tables=ds.tables.as_dict())["inters"])
    got = engine.predict(fi, np.zeros((5, 0), np.int32))
    want = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    for p, w in zip(got, want):
        assert p["track_scores"][0] == pytest.approx(w.max(), abs=2e-6)
        assert [it["label"] for it in p["interactions"]] == \
            list(np.argsort(-w)[:5])
