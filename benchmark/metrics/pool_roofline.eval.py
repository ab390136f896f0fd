"""Per-layer metric pool_roofline.eval: the context pool's share of its
roofline: the least time the window's pools need (harness/roofline.
pool_need over each batch's indices: each referenced row of the embedded
tables read once, indices and mask read, pooled rows written; against the
card's memory and float32 rates), over the device time of the pool kernels
in the traced window. No pool kernel in the window is a failure to read,
not a 0."""

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "eval_clips_per_s"
# csrc/fused_ctx_pool.cu's and csrc/fused_ctx_pool_triple.cu's pools
PATTERNS = (r"\bfused_ctx_pool\w*_kernel", r"\bgather_lanes_kernel")


def read(view):
    busy = view.device_s(PATTERNS, "context pool")
    if "pool_bound_s" not in view.counts:
        return None
    return 100.0 * view.counts["pool_bound_s"] / busy
