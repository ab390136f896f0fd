"""The port's checkpoint writing (checkpoint/saver.py) against the JAX
package's best-n policy, and the training CLI (cli/train.py) on the CPU:
train with cadence evaluation and checkpoints, resume from the latest
train state, and evaluate the best kept checkpoint with the eval CLI."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from lirec_tpu.checkpoint.saver import BestNSaver as JaxSaver
from lirec_tpu_torch import config as port_config
from lirec_tpu_torch.checkpoint import load_torch_checkpoint
from lirec_tpu_torch.checkpoint.saver import (
    BestNSaver,
    load_train_state,
    save_train_state,
)
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.train.optim import make_optimizer

DIM_ARGS = ["--text-dim", "16", "--visual-dim", "32", "--text-layers", "4",
            "--joint-dim", "16", "--compute-dtype", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metric_stream(n_epochs=12, seed=0):
    """Metric dicts as the cadence hands them to the saver: a few keys,
    values on a coarse grid so that ties and repeats occur."""
    rng = np.random.default_rng(seed)
    for epoch in range(n_epochs):
        yield epoch, {k: float(rng.integers(0, 8)) / 8
                      for k in ("total", "ints", "rels", "tracks", "joint")}


def _stems(root):
    """{key: sorted file stems} of the kept checkpoints under root."""
    out = {}
    for key_dir in sorted(glob.glob(os.path.join(root, "*", ""))):
        names = os.listdir(key_dir)
        out[os.path.basename(os.path.dirname(key_dir))] = sorted(
            n.split(".pth.tar")[0].split(".ckpt")[0] for n in names)
    return out


def test_best_n_saver_matches_jax(tmp_path):
    """The same metric dicts through check / update / save (saving every
    third epoch, as save_model_often does every 30th): the same kept epochs
    and values per key, the same evictions, the same index.json and the
    same file stems; the port's files are .pth.tar."""
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    want, got = JaxSaver(path=jax_root, n=4), BestNSaver(path=port_root, n=4)
    weights = {"w": np.zeros((2, 3), np.float32)}
    n_updates = 0
    for epoch, val in _metric_stream():
        assert got.check(val) == want.check(val)
        if want.check(val):
            n_updates += 1
            want.update(val, {"params": weights, "epoch": epoch}, epoch)
            got.update(val, {"state_dict": {"w.weight": torch.zeros(2, 3)},
                             "epoch": epoch}, epoch)
        if epoch % 3 == 2:
            want.save()
            got.save()
        assert dict(got.eval) == dict(want.eval)
        assert dict(got.worst_idx) == dict(want.worst_idx)
    assert 4 < n_updates < 12  # some epochs were refused, some evicted
    want.save()
    got.save()
    with open(os.path.join(jax_root, "index.json")) as f:
        want_index = json.load(f)
    with open(os.path.join(port_root, "index.json")) as f:
        assert json.load(f) == want_index
    assert _stems(port_root) == _stems(jax_root)
    files = glob.glob(os.path.join(port_root, "*", "*"))
    assert files and all(f.endswith(".pth.tar") for f in files)


def _tiny_bundle():
    cfg = port_config.preset("int_rel_ch").with_dims(
        text_dim=16, visual_dim=32, text_layers=4, joint_dim=16)
    return create_model(cfg, 9, n_rels=6, device="cpu")


def _adam_step(model, opt, seed):
    g = torch.Generator().manual_seed(seed)
    opt.zero_grad()
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()


def test_saver_keeps_each_epochs_own_weights(tmp_path):
    """The parameters change in place under optimizer.step(): each kept
    checkpoint still holds the weights of its own epoch, reads back
    through load_torch_checkpoint (the eval CLIs' loader) into an equal
    state_dict, and differs from the final weights."""
    bundle = _tiny_bundle()
    model = bundle.model
    opt = make_optimizer(model.parameters(), 1e-2)
    saver = BestNSaver(path=str(tmp_path), n=4)
    snapshots = {}
    for epoch in range(3):
        _adam_step(model, opt, epoch)
        snapshots[epoch] = {k: v.clone() for k, v in
                            model.state_dict().items()}
        val = {"total": 1.0 + epoch}
        assert saver.check(val)
        saver.update(val, {"state_dict": model.state_dict(),
                           "optimizer": opt.state_dict(), "epoch": epoch},
                     epoch)
    _adam_step(model, opt, 99)
    saver.save()
    final = model.state_dict()
    for epoch, snap in snapshots.items():
        path = os.path.join(tmp_path, "total",
                            "v%.4f_ep%d.pth.tar" % (1.0 + epoch, epoch))
        state, meta = load_torch_checkpoint(path)
        assert meta["epoch"] == epoch and meta["has_optimizer"]
        assert set(state) == set(snap)
        for k, v in snap.items():
            assert torch.equal(state[k], v), k
        assert any(not torch.equal(state[k], final[k]) for k in state)


def test_train_state_round_trip_resumes_adam(tmp_path):
    """save_train_state / load_train_state carry weights, the Adam state
    and the epoch: a model and optimizer restored from the file take the
    next step exactly as the originals do."""
    bundle = _tiny_bundle()
    opt = make_optimizer(bundle.model.parameters(), 1e-2, 1e-3)
    for seed in range(2):
        _adam_step(bundle.model, opt, seed)
    path = str(tmp_path / "latest.pth.tar")
    save_train_state(path, bundle.model.state_dict(), opt.state_dict(), 1)
    other = _tiny_bundle()
    other_opt = make_optimizer(other.model.parameters(), 1e-2, 1e-3)
    state, opt_state, epoch = load_train_state(path)
    other.model.load_state_dict(state)
    other_opt.load_state_dict(opt_state)
    assert epoch == 1
    _adam_step(bundle.model, opt, 5)
    _adam_step(other.model, other_opt, 5)
    for (k, a), b in zip(bundle.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_train_cli_trains_resumes_and_evaluates_its_checkpoint(synth_root,
                                                               tmp_path):
    """lirec-tpu-torch-train on the CPU: 3 epochs with cadence evaluation
    (test_fr 2: epochs 0 and 2) and a train state every epoch write
    index.json, the best-n files, latest.pth.tar and 2.pth.tar with finite
    losses; --resume-train from latest.pth.tar runs the one epoch left of
    4; the eval CLI reads the best total/*.pth.tar; --host-eval trains
    through the host loop's cadence."""
    from lirec_tpu_torch.cli import int_rel_ch
    from lirec_tpu_torch.cli import train as train_cli

    from lirec_tpu_torch.ops import dispatch

    def eval_loops(before):
        now = dispatch.decisions("eval_loop")
        return {p: now.get(p, 0) - before.get(p, 0)
                for p in ("host", "packed")}

    store = str(tmp_path / "store")
    base = ["--data-root", synth_root, "--store-root", store,
            "--batch-size", "8", "--device", "cpu", "--quiet",
            "--sanity-check", "--lr", "1e-3"] + DIM_ARGS
    before = dispatch.decisions("eval_loop")
    out = train_cli.main(base + ["--epochs", "3", "--checkpoint-every", "1"])
    # two cadences (epochs 0 and 2), each over train, val and test
    assert eval_loops(before) == {"host": 0, "packed": 6}
    losses = out["train"]["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert out["train"]["start_epoch"] == 0
    assert out["train"]["final_path"] == os.path.join(store, "2.pth.tar")
    for name in ("index.json", "latest.pth.tar", "2.pth.tar"):
        assert os.path.exists(os.path.join(store, name)), name
    with open(os.path.join(store, "index.json")) as f:
        index = json.load(f)
    assert set(index["total"]) <= {"0", "2"} and index["total"]
    _, _, epoch = load_train_state(os.path.join(store, "latest.pth.tar"))
    assert epoch == 2

    resumed = train_cli.main(base + [
        "--epochs", "4", "--resume-train", "--resume-path",
        os.path.join(store, "latest.pth.tar")])
    assert resumed["train"]["start_epoch"] == 3
    assert len(resumed["train"]["losses"]) == 1
    assert np.isfinite(resumed["train"]["losses"][0])
    assert os.path.exists(os.path.join(store, "3.pth.tar"))

    best = max(glob.glob(os.path.join(store, "total", "*.pth.tar")))
    metrics = int_rel_ch.main(base + ["--resume-path", best])
    assert set(metrics) == {"val", "test"}
    assert all(np.isfinite(v) for m in metrics.values() for v in m.values())

    host_store = str(tmp_path / "host")
    before = dispatch.decisions("eval_loop")
    host = train_cli.main(
        [a if a != store else host_store for a in base]
        + ["--epochs", "1", "--host-eval"])
    # the epoch-0 cadence went through the host loop, not the packed sweep
    assert eval_loops(before) == {"host": 3, "packed": 0}
    assert np.isfinite(host["train"]["losses"][0])
    with open(os.path.join(host_store, "index.json")) as f:
        assert set(json.load(f)["total"]) == {"0"}
