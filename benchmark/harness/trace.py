"""The traced window: ``torch.profiler`` over the window of a ``--trace 1``
run, written as a Chrome trace inside the checkout and read back here.

A trace is read as plain events (name, category, start, duration, in
microseconds on one clock): the device's operations (kernels, copies,
sets), the benchmark's own host spans (``bench.*`` annotations) and the
program's host operations. The window is the ``bench.window`` span. What
the per-layer readers take from it: the union of the device's spans
inside the window (busy seconds), the device time of kernels matched by
name, and the idle gaps, each named by the host span that was open.
"""

from __future__ import annotations

import contextlib
import json
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["NothingToRead", "TraceView", "load_events", "union_s",
           "profiled", "WINDOW_SPAN", "DEVICE_CATEGORIES"]

WINDOW_SPAN = "bench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("user_annotation", "cpu_op", "cuda_runtime",
                   "cuda_driver")


class NothingToRead(RuntimeError):
    """A reader found nothing of what it reads in the trace."""


def load_events(path: str) -> List[Tuple[str, str, float, float]]:
    """(name, category, start us, duration us) of every complete event of a
    Chrome trace file."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    out = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        out.append((str(e.get("name", "")), str(e.get("cat", "")),
                    float(e["ts"]), float(e["dur"])))
    return out


def union_s(spans: Iterable[Tuple[float, float]], lo: float,
            hi: float) -> float:
    """Length, in the spans' unit, of the union of [start, end) spans
    clipped to [lo, hi)."""
    total, cur_lo, cur_hi = 0.0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def _gaps(spans: List[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """The [start, end) stretches of [lo, hi) that no span covers."""
    out, t = [], lo
    for a, b in sorted(spans):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


class TraceView:
    """One traced window: its device spans and host spans, and the counts
    of the work that the run did inside it (``counts``, from the traffic's
    generator: batches, steps, FLOPs, the bytes' bound seconds...)."""

    def __init__(self, events: Sequence[Tuple[str, str, float, float]],
                 counts: Dict, device_kind: str, capture_s: float):
        windows = [(ts, ts + d) for n, c, ts, d in events
                   if n == WINDOW_SPAN]
        if not windows:
            raise NothingToRead("the trace holds no %s span" % WINDOW_SPAN)
        self.lo, self.hi = windows[0]
        self.device = [(n, ts, ts + d) for n, c, ts, d in events
                       if c in DEVICE_CATEGORIES and ts < self.hi
                       and ts + d > self.lo]
        self.host = [(n, ts, ts + d) for n, c, ts, d in events
                     if c in HOST_CATEGORIES and n != WINDOW_SPAN]
        self.counts = dict(counts)
        self.device_kind = device_kind
        self.capture_s = capture_s

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the
        device."""
        return union_s(((a, b) for _, a, b in self.device), self.lo,
                       self.hi) * 1e-6

    def matching(self, patterns: Sequence[str]) -> List[Tuple[str, float,
                                                               float]]:
        rx = [re.compile(p) for p in patterns]
        return [e for e in self.device if any(r.search(e[0]) for r in rx)]

    def device_s(self, patterns: Sequence[str], what: str) -> float:
        """Device seconds, inside the window, of the kernels whose names
        match any of `patterns`; NothingToRead where none does."""
        hits = self.matching(patterns)
        if not hits:
            raise NothingToRead("no %s kernel in the traced window (names "
                                "matched against %s)" % (what,
                                                         list(patterns)))
        return sum(min(b, self.hi) - max(a, self.lo)
                   for _, a, b in hits) * 1e-6

    def top_ops(self, n: int = 10) -> List[List]:
        """The `n` device operations that took the most time, [name,
        seconds]."""
        per: Dict[str, float] = {}
        for name, a, b in self.device:
            per[name] = per.get(name, 0.0) + (min(b, self.hi)
                                              - max(a, self.lo)) * 1e-6
        top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], s] for name, s in top]

    def _host_at(self, t: float) -> str:
        """The innermost benchmark span and the innermost program operation
        open at time t (a gap's middle), "bench.x > op"."""
        bench = [(a, n) for n, a, b in self.host
                 if n.startswith("bench.") and a <= t < b]
        ops = [(a, n) for n, a, b in self.host
               if not n.startswith("bench.") and a <= t < b]
        name = max(bench)[1] if bench else "(no benchmark span)"
        if ops:
            name += " > " + max(ops)[1][:80]
        return name

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The `n` longest idle stretches of the window, [what the host was
        doing, seconds]."""
        gaps = _gaps([(a, b) for _, a, b in self.device], self.lo, self.hi)
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at((a + b) / 2), (b - a) * 1e-6]
                for a, b in gaps[:n]]


@contextlib.contextmanager
def profiled(path: Optional[str], on: bool):
    """A profiler of the host and the card around the block where `on`,
    its Chrome trace written to `path` at the end; nothing otherwise."""
    if not on:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if card else []))
    prof.start()
    try:
        yield
        if card:
            torch.cuda.synchronize()
    finally:
        prof.stop()
    prof.export_chrome_trace(path)
