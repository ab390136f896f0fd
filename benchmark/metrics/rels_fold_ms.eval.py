"""Per-layer metric rels_fold_ms.eval: device milliseconds of the int_rels
sweep's fold of its per-hash score table (kernel 8's kernels, matched by
name as metrics/rels_fold_roofline.eval.py matches them) in the traced
window, per batch of the window (batches counted by the traffic's
generator). No such kernel in the window is a failure to read, not a 0."""

import os

from harness.cells import load_module

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOF = load_module(os.path.join(_HERE, "rels_fold_roofline.eval.py"),
                    "bench_metric_rels_fold_roofline.eval")

LAYER = "kernels"
UNIT = "ms/batch"
SOURCE = "device_trace"
MOVES = "eval_clips_per_s.no_ctx"
PATTERNS = _ROOF.PATTERNS


def read(view):
    return 1e3 * view.device_s(PATTERNS, "score table fold") \
        / view.counts["batches"]
