"""A toy int_rels cell for the benchmark's CPU tests: tests/toy.py's toy
checkout with a toy int_rels configuration, mix, cell and limits added as
new files and ``BENCHMARK.json`` entries (nothing of the benchmark is
edited), run on the CPU at sizes a test holds.

The toy configuration keeps the published model's structure (the gate,
the 18 context clips) at toy.py's tiny widths and tables; its split has
3 movies of 32 clips and 4 hashes a movie, 12 hashes over 70 samples, and
pools of 4-24 clips (past 18 the loader's stride) from 24-clip
neighbourhoods.
"""

import json
import os

import toy

CELL = "toyrels.eval_rels_sweep"
MIX = {"kind": "eval_rels_sweep", "rate_metric": "eval_clips_per_s",
       "samples": 70, "batch_size": 8, "warm_seconds": 0, "trace_sweeps": 1,
       "locality": {"clips_per_movie": 32, "neighborhood": 24,
                    "pool_range": [4, 24]},
       "hashes": {"hashes_per_movie": 4, "none_every": 16}}
# limits of the toy cell (70 samples on the CPU, bf16 compute): above the
# sound toy runs' readings, below the faults'
LIMITS = {"loss_gap": 5e-3, "count_gap": 2.0, "rels_count_gap": 1.0,
          "out_gap": 0.02, "emb_gap": 0.02, "table_gap": 0.02}


def make(tmp: str) -> str:
    """toy.make's checkout under `tmp` with the toy int_rels cell added.
    Returns its root."""
    root = toy.make(tmp)
    bench = os.path.join(root, "benchmark")
    cfg = json.load(open(os.path.join(toy.BENCH, "configs", "int_rels.json")))
    cfg.update(toy.TOY_DIMS, name="toyrels")
    toy._dump(os.path.join(bench, "configs", "toyrels.json"), cfg)
    toy._dump(os.path.join(bench, "traffic", "toy-rels.json"), MIX)
    toy._dump(os.path.join(bench, "limits", CELL + ".json"),
              {"limits": LIMITS})
    path = os.path.join(root, "BENCHMARK.json")
    doc = json.load(open(path))
    doc["configs"].append({"name": "toyrels", "source": "toy",
                           "file": "benchmark/configs/toyrels.json",
                           "reduced": [], "why": "toy"})
    doc["workloads"].append({"name": CELL, "config": "toyrels",
                             "traffic": "toy-rels", "chips": 1,
                             "why": "toy"})
    # every metric of the int_rels cell (setup_s lists no cells)
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "int_rels.eval-split" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    toy._dump(path, doc)
    return root
