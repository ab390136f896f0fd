"""Per-layer metric restart_idle_ms.eval: the milliseconds a sweep in which
the card sat idle while the host restarted the eval sweep: inside the
program's spans ``lirec.eval.tables``, ``.embed``, ``.localize``, ``.stage``
and ``.zero`` (the tables made device tensors, ``embed_all``, the
localisation, the split's staging and the carry's zeroing;
evaluation/packed.sweep_carry), over the traced window's sweeps
(harness/spans.idle_in_spans_s). Nothing where the program opens no such
span (a program without these spans reads nothing, and the line leaves the
metric out)."""

from harness.spans import NoSpans, idle_in_spans_s

LAYER = "eval sweep"
UNIT = "ms/sweep"
SOURCE = "program_span"
MOVES = "eval_clips_per_s"
PATTERNS = ()
SPANS = ("lirec.eval.tables", "lirec.eval.embed", "lirec.eval.localize",
         "lirec.eval.stage", "lirec.eval.zero")


def read(view):
    try:
        idle_s = idle_in_spans_s(view, SPANS)
    except NoSpans:
        return None
    return 1e3 * idle_s / view.counts["sweeps"]
