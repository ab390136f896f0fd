"""Per-layer metric pool_roofline.eval.no_ctx: pool_roofline.eval's reading
(metrics/pool_roofline.eval.py: the context pool against its roofline), in
the cells whose rate is eval_clips_per_s.no_ctx (int_rels: kernels 1-2 at
M = 64 rows a batch)."""

import os

from harness.cells import load_module

_HERE = os.path.dirname(os.path.abspath(__file__))
_BASE = load_module(os.path.join(_HERE, "pool_roofline.eval.py"),
                    "bench_metric_pool_roofline.eval")

LAYER = _BASE.LAYER
UNIT = _BASE.UNIT
SOURCE = _BASE.SOURCE
MOVES = "eval_clips_per_s.no_ctx"
PATTERNS = _BASE.PATTERNS
read = _BASE.read
