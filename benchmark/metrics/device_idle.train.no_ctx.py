"""Per-layer metric device_idle.train.no_ctx: device_idle.train's reading
(metrics/device_idle.train.py), in the cells whose rate is the no-context
configurations' own train_clips_per_s.no_ctx."""

import os

from harness.cells import load_module

_HERE = os.path.dirname(os.path.abspath(__file__))
_BASE = load_module(os.path.join(_HERE, "device_idle.train.py"),
                    "bench_metric_device_idle.train")

LAYER = _BASE.LAYER
UNIT = _BASE.UNIT
SOURCE = _BASE.SOURCE
MOVES = "train_clips_per_s.no_ctx"
PATTERNS = _BASE.PATTERNS
read = _BASE.read
