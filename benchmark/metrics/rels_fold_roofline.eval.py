"""Per-layer metric rels_fold_roofline.eval: the int_rels sweep's fold of
its per-hash score table against its roofline: the least time the
window's folds need (harness/fold_roofline.fold_need over each batch's
hash ids and labels: the ids and the update rows read once, each distinct
table row the batch touches read and written once; against the card's
memory and float32 rates), over the device time of the fold's kernels in
the traced window (kernel 8, csrc/scatter_accum.cu: the one-launch
``scatter_small_kernel``, or past its threshold the counting sort's and
the sorted scatter's kernels). No such kernel in the window is a failure
to read, not a 0."""

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "eval_clips_per_s.no_ctx"
PATTERNS = (r"\bscatter_(small|hot|short)_kernel",
            r"\bsort_(count|prefix|place|zero|digits|tile|bounds)_kernel")


def read(view):
    busy = view.device_s(PATTERNS, "score table fold")
    if "fold_bound_s" not in view.counts:
        return None
    return 100.0 * view.counts["fold_bound_s"] / busy
