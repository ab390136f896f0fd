"""Kernel-dispatch observability and launch counts.

Every wrapper records which path it took (the hand-written CUDA kernel for
CUDA tensors, the plain PyTorch version for CPU tensors) and, where it
launches its kernel, adds one to that kernel's launch count. A run can then
show that its main path really went through the kernels instead of
inferring it from timings (lirec_tpu/ops/dispatch.py gives the history).

A CUDA graph's capture runs the wrappers without launching anything: its
launches are recorded for the graph (``recording_launches``) and added to
the counts at every replay (``count_replay``), so that a replayed step
counts what the same eager step counts.
"""

from __future__ import annotations

import contextlib
import logging

__all__ = ["record", "last_dispatch", "decisions", "route", "launch",
           "count_launch", "launches", "reset_launches",
           "recording_launches", "count_replay"]

_logger = logging.getLogger("lirec_tpu_torch.ops")
_DISPATCH: dict = {}
_LOGGED: set = set()
_LAUNCHES: dict = {}
_DECISIONS: dict = {}
_RECORDING: list = []  # the launch counts of the captures under way


def record(kernel: str, path: str, reason: str, shapes) -> None:
    """Record (and log once per distinct decision) a dispatch choice."""
    _DISPATCH[kernel] = {"path": path, "reason": reason, "shapes": shapes}
    _DECISIONS[(kernel, path)] = _DECISIONS.get((kernel, path), 0) + 1
    key = (kernel, path, reason, shapes)
    try:
        fresh = key not in _LOGGED
    except TypeError:  # shapes of lists or dicts
        key = (kernel, path, reason, str(shapes))
        fresh = key not in _LOGGED
    if fresh:
        _LOGGED.add(key)
        _logger.info(
            "kernel dispatch: %s -> %s (%s) shapes=%s",
            kernel, path, reason, shapes,
        )


def last_dispatch(kernel: str):
    """Most recent decision for `kernel`, or None."""
    return _DISPATCH.get(kernel)


def decisions(kernel: str) -> dict:
    """{path: how many times `kernel` took it} since the process began."""
    return {p: n for (k, p), n in _DECISIONS.items() if k == kernel}


def route(kernel: str, op: str, device, shapes) -> bool:
    """True where `kernel` runs (CUDA tensors); False for CPU tensors,
    which take `op`'s plain version. Any other device raises."""
    if device.type == "cpu":
        record(kernel, "reference", "cpu tensors", shapes)
        return False
    if device.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (op, device))
    record(kernel, "cuda", "cuda tensors", shapes)
    return True


def launch(kernel: str, fn, device, args) -> None:
    """Call the C launcher `fn` with `args` and the current stream of
    `device`, raise on a refused launch (its cudaError_t), count it."""
    import torch

    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("%s launch failed: cudaError %d" % (kernel, err))
    count_launch(kernel)


def count_launch(kernel: str) -> None:
    """Called by a wrapper right after it launched `kernel`, and nowhere
    else. Under ``recording_launches`` the launch goes to the capture's
    counts instead."""
    counts = _RECORDING[-1] if _RECORDING else _LAUNCHES
    counts[kernel] = counts.get(kernel, 0) + 1


@contextlib.contextmanager
def recording_launches():
    """Within: the wrappers' launches are counted into the yielded dict
    and not into the process's counts (a CUDA graph's capture, which
    launches nothing)."""
    counts: dict = {}
    _RECORDING.append(counts)
    try:
        yield counts
    finally:
        _RECORDING.pop()


def count_replay(counts: dict) -> None:
    """A replay of a CUDA graph whose capture recorded `counts`."""
    for kernel, n in counts.items():
        _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + n


def launches(kernel: str = None):
    """Launch count of one kernel, or a copy of all counts."""
    if kernel is None:
        return dict(_LAUNCHES)
    return _LAUNCHES.get(kernel, 0)


def reset_launches() -> None:
    _LAUNCHES.clear()
