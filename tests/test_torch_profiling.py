"""--profile on the port's CLIs (utils/profiling.py): a torch.profiler
Chrome trace of the training run and of each evaluation, one file per
data-parallel rank; and StepTimer, a copy of the JAX package's."""

import json
import os
import time

import numpy as np
import pytest
import torch

from lirec_tpu_torch.cli import common, int_rel_ch
from lirec_tpu_torch.cli import train as train_cli
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.utils.profiling import StepTimer, trace, trace_path

DIM_ARGS = ["--text-dim", "16", "--visual-dim", "32", "--text-layers", "4",
            "--joint-dim", "16", "--compute-dtype", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(path):
    with open(path) as f:
        doc = json.load(f)
    return {e.get("name", "") for e in doc["traceEvents"]}


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "prof")
    with trace(log_dir, device="cpu", name="block"):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    path = trace_path(log_dir, "block")
    assert path == os.path.join(log_dir, "block.json")
    assert "aten::mm" in _events(path)
    assert trace_path(log_dir, "train", 1).endswith("train.rank1.json")
    with trace("", name="nothing"):  # no directory: no trace
        pass
    assert sorted(os.listdir(log_dir)) == ["block.json"]


def test_profile_traces_train_and_eval(synth_root, tmp_path):
    """--profile DIR on the training CLI writes train.json (the train
    step's ops and the scatter's plain index_add_ on the CPU), and on the
    eval CLI val.json and test.json; the metrics are those of the run
    without it."""
    prof = str(tmp_path / "prof")
    base = ["--data-root", synth_root, "--batch-size", "8", "--device",
            "cpu", "--quiet", "--sanity-check", "--lr", "1e-3"] + DIM_ARGS
    out = train_cli.main(base + ["--store-root", str(tmp_path / "st"),
                                 "--epochs", "1", "--profile", prof])
    assert np.isfinite(out["train"]["losses"]).all()
    names = _events(os.path.join(prof, "train.json"))
    assert "aten::index_add_" in names and "Optimizer.step#Adam.step" in names

    ckpt = str(tmp_path / "weights.pth.tar")
    args = base + ["--resume-path", ckpt, "--store-root",
                   str(tmp_path / "st2")]
    cfg = common.config_from_args(
        "int_rel_ch", common.build_parser("int_rel_ch").parse_args(args))
    train_ds, _, _ = common.build_datasets(cfg, "int_rel_ch")
    model = create_model(cfg, train_ds.n_classes,
                         n_rels=max(len(train_ds.rels_list) - 1, 0),
                         seed=3, device="cpu").model
    torch.save({"state_dict": model.state_dict()}, ckpt)
    want = int_rel_ch.main(args)
    got = int_rel_ch.main(args + ["--profile", prof])
    assert got == want
    assert sorted(os.listdir(prof)) == ["test.json", "train.json",
                                        "val.json"]
    for split in ("val", "test"):
        assert "aten::tanh" in _events(os.path.join(prof, split + ".json"))


def test_profile_under_a_mesh_writes_one_trace_per_rank(synth_root,
                                                        tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(common, "SPAWN_TIMEOUT", 300)
    prof = str(tmp_path / "prof")
    train_cli.main(["--data-root", synth_root, "--store-root",
                    str(tmp_path / "st"), "--batch-size", "8", "--device",
                    "cpu", "--quiet", "--sanity-check", "--epochs", "1",
                    "--mesh", "2x1", "--profile", prof] + DIM_ARGS)
    assert sorted(os.listdir(prof)) == ["train.rank0.json",
                                        "train.rank1.json"]
    for name in os.listdir(prof):
        assert "aten::index_add_" in _events(os.path.join(prof, name))


def test_step_timer_aggregates_spans():
    timer = StepTimer()
    for _ in range(3):
        with timer.span("a"):
            time.sleep(0.002)
    with timer.span("b"):
        pass
    s = timer.summary()
    assert s["a"]["count"] == 3 and s["b"]["count"] == 1
    assert s["a"]["total_s"] >= 0.006
    assert s["a"]["mean_ms"] == pytest.approx(1000 * s["a"]["total_s"] / 3)
