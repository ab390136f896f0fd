"""Per-layer metric scatter_roofline.train: the training step's scatter
(the context gather's backward: its sort and its accumulation) against its
roofline: the least time the window's scatters need (harness/roofline.
scatter_need: ids in, the permutation and row offsets out, each update row
read once, each table row written once), over the device time of the
scatter's kernels in the traced window. No such kernel in the window is a
failure to read, not a 0."""

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_clips_per_s"
# csrc/scatter_accum.cu: the counting sort's and the accumulation's kernels
PATTERNS = (r"\bsort_(count|prefix|place|zero|digits|tile|bounds)_kernel",
            r"\bscatter_(hot|short|small)_kernel")


def read(view):
    busy = view.device_s(PATTERNS, "scatter")
    if "scatter_bound_s" not in view.counts:
        return None
    return 100.0 * view.counts["scatter_bound_s"] / busy
