"""Per-layer metric staging_idle_ms.train.no_ctx: staging_idle_ms.train's
reading (metrics/staging_idle_ms.train.py), in the cells whose rate is the
no-context configurations' own train_clips_per_s.no_ctx."""

import os

from harness.cells import load_module

_HERE = os.path.dirname(os.path.abspath(__file__))
_BASE = load_module(os.path.join(_HERE, "staging_idle_ms.train.py"),
                    "bench_metric_staging_idle_ms.train")

LAYER = _BASE.LAYER
UNIT = _BASE.UNIT
SOURCE = _BASE.SOURCE
MOVES = "train_clips_per_s.no_ctx"
PATTERNS = _BASE.PATTERNS
SPANS = _BASE.SPANS
read = _BASE.read
