"""Kernel-dispatch observability and launch counts.

Every wrapper records which path it took (the hand-written CUDA kernel for
CUDA tensors, the plain PyTorch version for CPU tensors) and, where it
launches its kernel, adds one to that kernel's launch count. A run can then
show that its main path really went through the kernels instead of
inferring it from timings (lirec_tpu/ops/dispatch.py gives the history).
"""

from __future__ import annotations

import logging

__all__ = ["record", "last_dispatch", "count_launch", "launches",
           "reset_launches"]

_logger = logging.getLogger("lirec_tpu_torch.ops")
_DISPATCH: dict = {}
_LOGGED: set = set()
_LAUNCHES: dict = {}


def record(kernel: str, path: str, reason: str, shapes) -> None:
    """Record (and log once per distinct decision) a dispatch choice."""
    _DISPATCH[kernel] = {"path": path, "reason": reason, "shapes": shapes}
    key = (kernel, path, reason, str(shapes))
    if key not in _LOGGED:
        _LOGGED.add(key)
        _logger.info(
            "kernel dispatch: %s -> %s (%s) shapes=%s",
            kernel, path, reason, shapes,
        )


def last_dispatch(kernel: str):
    """Most recent decision for `kernel`, or None."""
    return _DISPATCH.get(kernel)


def count_launch(kernel: str) -> None:
    """Called by a wrapper right after it launched `kernel`, and nowhere
    else."""
    _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + 1


def launches(kernel: str = None):
    """Launch count of one kernel, or a copy of all counts."""
    if kernel is None:
        return dict(_LAUNCHES)
    return _LAUNCHES.get(kernel, 0)


def reset_launches() -> None:
    _LAUNCHES.clear()
