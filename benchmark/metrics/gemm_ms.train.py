"""Per-layer metric gemm_ms.train: device milliseconds of the matrix products
(cuBLAS and CUTLASS kernels, matched by name) in the traced window, per
step of the window (steps counted by the traffic's generator)."""

LAYER = "model forward and backward"
UNIT = "ms/step"
SOURCE = "device_trace"
MOVES = "train_clips_per_s"
# cuBLAS / cuBLASLt / CUTLASS kernel names: (s|h|d)gemm, gemv, the xmma
# and nvjet kernels, cutlass templates, cuBLASLt's split-K reduction
PATTERNS = (r"(?i)gemm", r"(?i)gemv", r"nvjet", r"xmma", r"cutlass",
            r"splitKreduce")


def read(view):
    return 1e3 * view.device_s(PATTERNS, "GEMM") / view.counts["steps"]
