"""Per-layer metric replay_idle_ms.train: the milliseconds an epoch in which
the card sat idle between replays while the host ran the epoch sweep's step
loop: inside the program's span ``lirec.train.replays`` (seeding the two
generators and one CUDA graph replay a step; train/sweep.EpochSweep), over
the traced window's epochs (harness/spans.idle_in_spans_s, which leaves out
the bubbles between the kernels of one replay). What the card waits for
here is the host's next launch (the seeding's kernels, the next replay) or
the card's own start of the next replay: what a graph of several steps
would take away. Nothing where the program opens no such span (a program
without these spans reads nothing, and the line leaves the metric out)."""

from harness.spans import NoSpans, idle_in_spans_s

LAYER = "epoch sweep"
UNIT = "ms/epoch"
SOURCE = "program_span"
MOVES = "train_clips_per_s"
PATTERNS = ()
SPANS = ("lirec.train.replays",)


def read(view):
    try:
        idle_s = idle_in_spans_s(view, SPANS)
    except NoSpans:
        return None
    return 1e3 * idle_s / view.counts["epochs"]
