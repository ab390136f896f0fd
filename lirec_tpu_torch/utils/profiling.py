"""Tracing and profiling (counterpart of lirec_tpu/utils/profiling.py).

``trace(log_dir)`` wraps a block in a ``torch.profiler`` trace (host
activity, and the card's kernels and copies when the work runs on one)
and writes it as one Chrome trace JSON (``chrome://tracing``, Perfetto);
``StepTimer`` aggregates named wall-clock spans.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

__all__ = ["trace", "trace_path", "StepTimer"]


def trace_path(log_dir: str, name: str, rank: Optional[int] = None) -> str:
    """``<log_dir>/<name>.json``, or ``<name>.rank<r>.json`` for a rank of
    a data-parallel group."""
    tag = name if rank is None else "%s.rank%d" % (name, rank)
    return os.path.join(log_dir, tag + ".json")


@contextlib.contextmanager
def trace(log_dir: Optional[str], device="cpu", name: str = "trace",
          rank: Optional[int] = None) -> Iterator[None]:
    """A torch.profiler trace of the block, written to ``trace_path(log_dir,
    name, rank)`` when it ends, with the card's activity when `device` is
    a CUDA device; a no-op when `log_dir` is empty."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(trace_path(log_dir, name, rank))


class StepTimer:
    """Named wall-clock spans with running stats."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        start = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - start
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }
