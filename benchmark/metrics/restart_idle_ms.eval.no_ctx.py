"""Per-layer metric restart_idle_ms.eval.no_ctx: restart_idle_ms.eval's
reading (metrics/restart_idle_ms.eval.py), in the cells whose rate is the
no-context configurations' own eval_clips_per_s.no_ctx."""

import os

from harness.cells import load_module

_HERE = os.path.dirname(os.path.abspath(__file__))
_BASE = load_module(os.path.join(_HERE, "restart_idle_ms.eval.py"),
                    "bench_metric_restart_idle_ms.eval")

LAYER = _BASE.LAYER
UNIT = _BASE.UNIT
SOURCE = _BASE.SOURCE
MOVES = "eval_clips_per_s.no_ctx"
PATTERNS = _BASE.PATTERNS
SPANS = _BASE.SPANS
read = _BASE.read
