"""Per-layer metric rels_finish_ms.eval: the milliseconds a sweep in which
the card sat idle while the host finished RelationshipsAcc: inside the
program's span ``lirec.eval.rels_finish`` (the per-hash fill of the
fetched score table and the per-hash argsort; evaluation/packed.
finish_from_carry), over the traced window's sweeps (harness/spans.
idle_in_spans_s). Nothing where the program opens no such span (a program
without it reads nothing, and the line leaves the metric out)."""

from harness.spans import NoSpans, idle_in_spans_s

LAYER = "eval sweep"
UNIT = "ms/sweep"
SOURCE = "program_span"
MOVES = "eval_clips_per_s.no_ctx"
PATTERNS = ()
SPANS = ("lirec.eval.rels_finish",)


def read(view):
    try:
        idle_s = idle_in_spans_s(view, SPANS)
    except NoSpans:
        return None
    return 1e3 * idle_s / view.counts["sweeps"]
