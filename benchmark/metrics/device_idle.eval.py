"""Per-layer metric device_idle.eval: the share of the traced window in which
no operation ran on the card: 1 - (the union of every kernel, copy and
set span inside the window) / (the window's length), from the traced
run's own window. Read from the trace (harness/trace.TraceView)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "eval_clips_per_s"
PATTERNS = ()


def read(view):
    return 100.0 * (1.0 - view.busy_s / view.window_s)
