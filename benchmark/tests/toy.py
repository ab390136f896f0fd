"""A toy checkout for the benchmark's CPU tests: a copy of the benchmark's
files with toy configurations, traffic mixes, cells and limits added as
new files and ``BENCHMARK.json`` entries (nothing of the benchmark is
edited), run on the CPU at sizes a test holds.

The toy configurations keep the published model's structure (the
presets' 20 hypotheses and 18 context clips) at tiny widths and tables.
"""

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

TOY_DIMS = dict(text_dim=16, visual_dim=24, track_dim=24, joint_dim=8,
                n_classes=7, n_rels=3, n_clips=96, n_tracks=192)
TOY_LOCALITY = {"clips_per_movie": 32, "neighborhood": 20,
                "pool_range": [4, 24], "names_range": [2, 6]}
# limits of the toy cells (70 samples on the CPU, bf16 compute): above the
# sound toy runs' readings, below the faults'
TOY_LIMITS = {
    "eval": {"loss_gap": 5e-3, "count_gap": 2.0, "out_gap": 0.02,
             "emb_gap": 0.02},
    "train": {"grad_gap": 0.1, "grad_dir_med": 5e-4, "head_dir_gap": 5e-4,
              "step_gap": 0.3},
}


def make(tmp: str, extra_metric: str = None) -> str:
    """A toy checkout under `tmp`: toy.* (int_rel_ch's model) and toych.*
    (int_ch's) cells of an eval and a train mix. Returns its root."""
    bench = os.path.join(tmp, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    doc = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for name, base in (("toy", "int_rel_ch"), ("toych", "int_ch")):
        cfg = json.load(open(os.path.join(BENCH, "configs", base + ".json")))
        cfg.update(TOY_DIMS, name=name)
        _dump(os.path.join(bench, "configs", name + ".json"), cfg)
        doc["configs"].append({"name": name, "source": "toy",
                               "file": "benchmark/configs/%s.json" % name,
                               "reduced": [], "why": "toy"})
    for kind, rate, key in (("eval_sweep", "eval_clips_per_s", "sweeps"),
                            ("train_epochs", "train_clips_per_s",
                             "epochs")):
        _dump(os.path.join(bench, "traffic", "toy-%s.json" % kind),
              {"kind": kind, "rate_metric": rate, "samples": 70,
               "batch_size": 8, "warm_seconds": 0, "trace_" + key: 1,
               "locality": TOY_LOCALITY})
    cells = []
    for cfg in ("toy", "toych"):
        for kind in ("eval_sweep", "train_epochs"):
            name = "%s.%s" % (cfg, kind)
            cells.append({"name": name, "config": cfg,
                          "traffic": "toy-" + kind, "chips": 1,
                          "why": "toy"})
            _dump(os.path.join(bench, "limits", name + ".json"),
                  {"limits": TOY_LIMITS[kind.split("_")[0]]})
    doc["workloads"] += cells
    for m in doc["end_to_end"] + doc["per_layer"]:
        # a metric of the eval (train) rate, or moving it, to the toy eval
        # (train) cells; set-up's to all; none of a group's own rate
        rate = m.get("moves", m["name"])
        if "workloads" in m and "." not in rate:
            m["workloads"] += [c["name"] for c in cells
                               if rate == "setup_s" or ("eval" in rate)
                               == ("eval" in c["name"])]
    if extra_metric:
        doc["per_layer"].append(json.loads(extra_metric))
    _dump(os.path.join(tmp, "BENCHMARK.json"), doc)
    return tmp


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def run(root: str, cell: str, seed: int = 7, trace: int = 0,
        seconds: float = 0.5, capsys=None):
    """One run of a toy cell on the CPU; (exit code, the result line)."""
    import time

    from harness.runner import main

    rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(trace)], time.perf_counter(),
              root=root, device="cpu",
              bench_dir=os.path.join(root, "benchmark"))
    line = None
    if capsys is not None:
        out = capsys.readouterr().out.strip().splitlines()
        line = json.loads(out[-1]) if out else None
    return rc, line
