"""Per-layer metric mfu.eval: the whole step's share of the card's peak: the
model FLOPs of the work the traced window completed (harness/flops.py,
from the configuration's published shapes; counted by the traffic's
generator) over the window's seconds, over the card's dense bf16 peak
(harness/roofline.PEAKS). Nothing for a card not in that table."""

from harness.roofline import peak

LAYER = "whole step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "eval_clips_per_s"
PATTERNS = ()


def read(view):
    rates = peak(view.device_kind)
    if rates is None:
        return None
    return 100.0 * view.counts["flops"] / view.window_s / rates["bf16_flops"]
