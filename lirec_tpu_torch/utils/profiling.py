"""Tracing and profiling (counterpart of lirec_tpu/utils/profiling.py).

``trace(log_dir)`` wraps a block in a ``torch.profiler`` trace (host
activity, and the card's kernels and copies when the work runs on one)
and writes it as one Chrome trace JSON (``chrome://tracing``, Perfetto);
``span(name)`` names a stretch of the program's host work in that trace:
a ``torch.profiler.record_function`` while a profiler runs (the span lands
beside the card's kernels and copies, on the profiler's clock), one shared
no-op context otherwise, so that a span costs a flag test when nothing
traces. The port's spans are named ``lirec.<layer>.<phase>``
(PERF.md §3 lists them with the metrics that read them); none is opened
inside a captured CUDA graph step, since a replay records no host span.
"""

from __future__ import annotations

import contextlib
import os
from typing import ContextManager, Iterator, Optional

import torch

__all__ = ["trace", "trace_path", "span"]

_OFF = contextlib.nullcontext()  # the span while no profiler runs


def span(name: str) -> ContextManager:
    """A host span `name` in the running profiler's trace
    (``torch.profiler.record_function``); the shared no-op when no profiler
    runs (``record_function`` costs over ten microseconds of host time a
    span even then, the guard well under one)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


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
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(trace_path(log_dir, name, rank))
