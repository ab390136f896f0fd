"""Per-layer metric staging_idle_ms.train: the milliseconds an epoch in
which the card sat idle while the host staged the epoch's batches: inside
the program's spans ``lirec.train.check``, ``.stack``, ``.pin`` and ``.h2d``
(each batch's index check, train/loop.check_batch; the stacking, the pinning
and the copies into the graph's stack, train/sweep.EpochSweep), over the
traced window's epochs (harness/spans.idle_in_spans_s). Nothing where the
program opens no such span (a program without these spans reads nothing, and
the line leaves the metric out)."""

from harness.spans import NoSpans, idle_in_spans_s

LAYER = "epoch sweep"
UNIT = "ms/epoch"
SOURCE = "program_span"
MOVES = "train_clips_per_s"
PATTERNS = ()
SPANS = ("lirec.train.check", "lirec.train.stack", "lirec.train.pin",
         "lirec.train.h2d")


def read(view):
    try:
        idle_s = idle_in_spans_s(view, SPANS)
    except NoSpans:
        return None
    return 1e3 * idle_s / view.counts["epochs"]
