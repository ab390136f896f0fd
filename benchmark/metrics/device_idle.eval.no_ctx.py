"""Per-layer metric device_idle.eval.no_ctx: device_idle.eval's reading
(metrics/device_idle.eval.py), in the cells whose rate is the no-context
configurations' own eval_clips_per_s.no_ctx."""

import os

from harness.cells import load_module

_HERE = os.path.dirname(os.path.abspath(__file__))
_BASE = load_module(os.path.join(_HERE, "device_idle.eval.py"),
                    "bench_metric_device_idle.eval")

LAYER = _BASE.LAYER
UNIT = _BASE.UNIT
SOURCE = _BASE.SOURCE
MOVES = "eval_clips_per_s.no_ctx"
PATTERNS = _BASE.PATTERNS
read = _BASE.read
