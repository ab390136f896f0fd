"""Telemetry + small utilities (ref `utils/util_functions.py:23-50,242-318`)."""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Callable, Optional

import numpy as np

__all__ = ["Averaging", "RunningPrecision", "timed", "ensure_dir",
           "stack_join", "MetricsLogger"]


class Averaging:
    """Running average meter (ref util_functions.py:23-38)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class RunningPrecision:
    """Simple hit-rate meter (ref util_functions.py:41-50)."""

    def __init__(self):
        self.true_prediction = 0
        self.total = 0
        self.avg = 0.0

    def update(self, true_pr: int, total: int):
        self.true_prediction += true_pr
        self.total += total
        self.avg = self.true_prediction / self.total


def timed(fn: Callable) -> Callable:
    """Wall-clock decorator (ref util_functions.py:294-305)."""

    @functools.wraps(fn)
    def wrap(*args, **kwargs):
        start = time.time()
        out = fn(*args, **kwargs)
        dt = time.time() - start
        print("%s took %.3f s" % (getattr(fn, "__name__", fn), dt))
        return out

    return wrap


def ensure_dir(path: str) -> None:
    """mkdir -p (ref util_functions.py:308-318)."""
    if path:
        os.makedirs(path, exist_ok=True)


def stack_join(data1, data2, f=np.vstack):
    """Stack helper tolerant of None/tuple inputs
    (ref util_functions.py:242-263)."""
    if isinstance(data2, tuple):
        data2 = f(data2)
    if data2 is None:
        return data1
    if data1 is None:
        return data2
    return f((data1, data2))


class MetricsLogger:
    """Append-only JSONL metrics log — the observability surface the
    reference lacks (print-only; SURVEY.md §5.5)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            ensure_dir(os.path.dirname(os.path.abspath(path)))

    def log(self, record: dict) -> None:
        if not self.path:
            return
        record = dict(record, ts=time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
