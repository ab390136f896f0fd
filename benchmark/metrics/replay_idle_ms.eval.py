"""Per-layer metric replay_idle_ms.eval: the milliseconds a sweep in which
the card sat idle between replays while the host ran the eval sweep's loop
over its full batches: inside the program's span ``lirec.eval.replays``
(seeding and one CUDA graph replay a batch; evaluation/packed.sweep_carry),
over the traced window's sweeps (harness/spans.idle_in_spans_s, which
leaves out the bubbles between the kernels of one replay). What the card
waits for here is the host's next launch, or the card's own start of the
next replay: what a graph of several batches would take away. Nothing
where the program opens no such span (a program without these spans reads
nothing, and the line leaves the metric out)."""

from harness.spans import NoSpans, idle_in_spans_s

LAYER = "eval sweep"
UNIT = "ms/sweep"
SOURCE = "program_span"
MOVES = "eval_clips_per_s"
PATTERNS = ()
SPANS = ("lirec.eval.replays",)


def read(view):
    try:
        idle_s = idle_in_spans_s(view, SPANS)
    except NoSpans:
        return None
    return 1e3 * idle_s / view.counts["sweeps"]
