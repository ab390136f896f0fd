"""The harness end to end on the CPU, in a toy checkout (tests/toy.py): the
result line of untraced and traced runs, a cell, a configuration, a mix
and a per-layer metric added as new files and entries only, and the
refusals (no card, no program, a malformed BENCHMARK.json)."""

import json
import os
import re
import subprocess
import sys

import pytest

import toy
from harness.cells import Spec

CELLS = ["toy.eval_sweep", "toy.train_epochs", "toych.eval_sweep",
         "toych.train_epochs"]
# a per-layer metric that the test adds: a reader of its own, found by name
TOY_METRIC = '''"""Toy per-layer metric: the batches or steps of the window."""
LAYER = "toy layer"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "eval_clips_per_s"
PATTERNS = ()


def read(view):
    return float(view.counts["batches"])
'''


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toyroot"))
    entry = json.dumps({"name": "toy_batches", "unit": "count",
                        "better": "higher", "source": "program_counter",
                        "layer": "toy layer", "moves": "eval_clips_per_s",
                        "workloads": ["toy.eval_sweep"]})
    toy.make(root, extra_metric=entry)
    with open(os.path.join(root, "benchmark", "metrics",
                           "toy_batches.py"), "w") as f:
        f.write(TOY_METRIC)
    return root


@pytest.mark.parametrize("cell", CELLS)
def test_an_untraced_run(checkout, cell, capsys):
    rc, line = toy.run(checkout, cell, seed=2 ** 31 + 7, capsys=capsys)
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    rate = "eval_clips_per_s" if "eval" in cell else "train_clips_per_s"
    assert set(line["metrics"]) == {"setup_s", rate}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["count"] == 1
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("cell", ["toy.eval_sweep", "toy.train_epochs"])
def test_a_traced_run_reads_the_per_layer_metrics(checkout, cell, capsys):
    rc, line = toy.run(checkout, cell, seed=13, trace=1, capsys=capsys)
    assert rc == 0 and line["correct"] is True
    dev = line["device"]
    assert dev["window_s"] > 0 and "busy_s" in dev
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    metrics = line["metrics"]
    kind = "eval" if "eval" in cell else "train"
    # on the CPU no kernel runs: the device metrics read 100% idle, and
    # the kernel readers read nothing (they say so, and are left out)
    assert metrics["device_idle." + kind]["value"] == pytest.approx(100.0)
    assert "mfu." + kind not in metrics
    if kind == "eval":
        assert metrics["toy_batches"] == {"value": 9.0, "unit": "count"}


def test_a_group_of_cells_reports_the_rate_under_its_own_name(tmp_path,
                                                               capsys):
    # <quantity>.<group>: the same rate, bounded for its cells apart
    root = toy.make(str(tmp_path))
    path = os.path.join(root, "BENCHMARK.json")
    doc = json.load(open(path))
    for m in doc["end_to_end"]:
        if m["name"] == "eval_clips_per_s":
            m["workloads"].remove("toych.eval_sweep")
            doc["end_to_end"].append(dict(m, name="eval_clips_per_s.toy",
                                          workloads=["toych.eval_sweep"]))
            break
    with open(path, "w") as f:
        json.dump(doc, f)
    rc, line = toy.run(root, "toych.eval_sweep", seed=2 ** 31 + 9,
                       capsys=capsys)
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "eval_clips_per_s.toy"}
    assert line["metrics"]["eval_clips_per_s.toy"]["value"] > 0


def test_a_cell_of_new_files_is_found_by_name(checkout):
    spec = Spec(checkout, os.path.join(checkout, "benchmark"))
    assert spec.config(spec.cell("toy.eval_sweep")["config"])["name"] == "toy"
    assert spec.mix("toy-eval_sweep")["kind"] == "eval_sweep"
    names = [m["name"] for m in spec.per_layer("toy.eval_sweep")]
    assert "toy_batches" in names and "graph_capture_ms" in names
    assert "toy_batches" not in [m["name"] for m in
                                 spec.per_layer("toy.train_epochs")]


def test_the_run_refuses_to_start_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, os.path.join(toy.BENCH, "run.py"), "--workload",
         "int_rel_ch.eval-split", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=toy.ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_the_run_fails_without_the_program(tmp_path):
    bare = tmp_path / "bare"
    bare.mkdir()
    toy.make(str(bare))
    code = ("import sys, time; sys.path.insert(0, %r); "
            "from harness.runner import main; "
            "sys.exit(main(['--workload', 'toy.eval_sweep', '--seed', '1', "
            "'--seconds', '1'], time.perf_counter(), root=%r, device='cpu', "
            "bench_dir=%r))" % (str(bare / "benchmark"), str(bare),
                                str(bare / "benchmark")))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(bare),
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "lirec_tpu_torch" in proc.stderr


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_its_form():
    doc = json.load(open(os.path.join(toy.ROOT, "BENCHMARK.json")))
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert doc["paths"] == ["benchmark"] and 1 <= doc["run_seconds"] <= 51
    configs = {c["name"] for c in doc["configs"]}
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert json.load(open(os.path.join(toy.ROOT, c["file"])))
    cells = {w["name"] for w in doc["workloads"]}
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert os.path.isfile(os.path.join(toy.BENCH, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(toy.BENCH, "limits",
                                           w["name"] + ".json"))
    e2e = {m["name"] for m in doc["end_to_end"]}
    assert "setup_s" in e2e
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in doc["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert os.path.isfile(os.path.join(toy.BENCH, "metrics",
                                           m["name"] + ".py"))
