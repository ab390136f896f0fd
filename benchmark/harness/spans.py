"""The program's own host spans in the traced window: the port names its
phases with ``lirec.*`` spans (``lirec_tpu_torch.utils.profiling.span``),
which the profiler writes into the same trace as the card's operations,
on one clock. What a per-layer reader takes from them: how long the card
sat idle while the host was inside given phases.

An idle stretch between two operations of one CUDA graph replay is left
out: the card already held the rest of that replay, so no host phase kept
it waiting (those bubbles between a step's kernels go only with fewer
kernels a step). The trace read here links no operation to the launch that
made it, so a replay is found by its operations' names: the card runs the
program's launches in the order the host made them (one stream; a graph's
branches stay inside its replay), a kernel launch, a copy or a set makes
one operation and a graph launch an equal share of the rest, so the
host's launches say where the first replay's operations lie and where the
last's; every stretch of operations that repeats one of those whole is a
replay. A replay the trace lost an operation of (the profiler may drop a
few) is not found, and its bubbles count; a window in which fewer than
half the graph launches are found reads nothing."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from harness.trace import NothingToRead, TraceView, union_s

__all__ = ["NoSpans", "idle_in_spans_s", "gaps_between_launches"]

GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
COPIES = ("Memcpy", "Memset")
OP_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
               "cuMemcpy", "cuMemset")


class NoSpans(NothingToRead):
    """The window holds no span of the names asked for: a program that
    does not open them (a reader then reads None)."""


def _replay_of(view: TraceView, ops: Sequence[Tuple[str, float, float]]
               ) -> List[int]:
    """For each device operation of `ops` (in order of start), the number
    of the graph replay it belongs to, -1 for an operation of no replay."""
    calls = sorted((a, n) for n, a, _ in view.host
                   if view.lo <= a < view.hi
                   and (n in GRAPH_LAUNCHES or n.startswith(OP_LAUNCHES)))
    graphs = [k for k, (_, n) in enumerate(calls) if n in GRAPH_LAUNCHES]
    if not graphs:
        return [-1] * len(ops)
    # a copy's or a set's memory kinds may read "Unknown" in one replay
    ids: Dict[str, int] = {}
    names = [ids.setdefault(n.split(" (")[0] if n.startswith(COPIES) else n,
                            len(ids)) for n, _, _ in ops]
    size = round((len(ops) - len(calls) + len(graphs)) / len(graphs))
    # a replay's operations, where the host's launches put the first
    # replay and the last
    after = len(names) - (len(calls) - 1 - graphs[-1])
    found = max((_replays(names, t) for t in
                 (names[graphs[0]:graphs[0] + size],
                  names[max(after - size, 0):after])
                 if size > 0 and len(t) == size), key=len, default=[])
    if 2 * len(found) < len(graphs):
        raise NothingToRead(
            "the operations of only %d of the window's %d graph launches "
            "were found in its trace" % (len(found), len(graphs)))
    out = [-1] * len(ops)
    for k, i in enumerate(found):
        out[i:i + size] = [k] * size
    return out


def _replays(names: List[int], replay: List[int]) -> List[int]:
    """Where the operations `names` hold the sequence `replay` whole, left
    to right without overlap: the first operation of each."""
    out, i, size = [], 0, len(replay)
    while i + size <= len(names):
        if names[i] == replay[0] and names[i:i + size] == replay:
            out.append(i)
            i += size
        else:
            i += 1
    return out


def gaps_between_launches(view: TraceView) -> List[Tuple[float, float]]:
    """The [start, end) stretches of the window in which no operation ran
    on the device, less those between two operations of one graph
    replay."""
    ops = sorted(view.device, key=lambda e: e[1])
    replay = _replay_of(view, ops)
    out, t, last = [], view.lo, -1
    for i, (_, a, b) in enumerate(ops):
        if a > t and not (last >= 0 and replay[last] >= 0
                          and replay[last] == replay[i]):
            out.append((t, min(a, view.hi)))
        if b > t:
            t, last = b, i
    if t < view.hi:
        out.append((t, view.hi))
    return [(a, b) for a, b in out if b > a]


def idle_in_spans_s(view: TraceView, names: Sequence[str]) -> float:
    """Seconds of the window inside the union of the host spans named
    `names` in which no operation ran on the device, the bubbles inside a
    graph replay left out (``gaps_between_launches``); nested and
    overlapping spans count once. NoSpans where the window holds no span
    of those names; NothingToRead where its operations cannot be matched
    to its launches."""
    want = set(names)
    host = [(a, b) for n, a, b in view.host if n in want]
    if not union_s(host, view.lo, view.hi):
        raise NoSpans("no host span %s in the traced window"
                      % sorted(want))
    gaps = gaps_between_launches(view)
    return (union_s(host, view.lo, view.hi) + union_s(gaps, view.lo, view.hi)
            - union_s(host + gaps, view.lo, view.hi)) * 1e-6
