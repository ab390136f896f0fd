"""Per-layer metric graph_capture_ms: the host milliseconds that the
program's CUDA graph captures took during set-up (the sum of
``lirec_tpu_torch.utils.graphs.CAPTURE_SECONDS`` entries made in the run,
which the traffic's generator hands over). Nothing where no graph was
captured."""

LAYER = "CUDA graphs"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "setup_s"
PATTERNS = ()


def read(view):
    return 1e3 * view.capture_s if view.capture_s > 0 else None
