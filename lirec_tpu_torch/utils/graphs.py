"""One step captured as a CUDA graph: the PyTorch form of the JAX package's
one-dispatch sweeps (a ``lax.fori_loop`` over staged batches).

The epoch sweep (train/sweep.py) and the eval sweep
(evaluation/packed.sweep_carry) stage their batches on the card as one
``[S, B, ...]`` stack and step over it with a function of static tensors:
the stack, a device-side step index the step reads its batch with and
advances, and the state it updates in place (the model, its gradients and
Adam's moments, or the sweep's carry). ``StepGraph`` runs that function
once eagerly on its capture stream (the warm-up, which is a real step:
Adam's moments, the gradients and the scatter kernel's side stream come
into being outside the graph), captures it on the same stream, and then
replays it once per further step: one launch per step where the eager step
makes about 150.

The capture launches nothing: the wrappers' launches during it are
counted for the graph (ops/dispatch.recording_launches) and added to the
process's counts at every replay. The ``torch.Generator``s the step draws
from are registered with the graph; the caller seeds them before each
replay, and the replay then draws what the eager step draws from the same
seeds. A capture that fails raises: nothing falls back to eager steps.
``CAPTURE_SECONDS`` keeps the host seconds of the latest captures. A
capture is the host span ``lirec.graph.capture`` of a trace
(utils/profiling.span); the step inside opens none. A replay opens no span
of its own: the trace marks each with its ``cudaGraphLaunch``, and the
callers' ``lirec.<layer>.replays`` spans hold their loops of replays.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Sequence

import torch

from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.utils.profiling import span

__all__ = ["StepGraph", "capturing", "take", "CAPTURE_SECONDS"]

_STREAMS: dict = {}  # device index -> the capture stream
CAPTURE_SECONDS = collections.deque(maxlen=64)  # the latest at [-1]


def capturing() -> bool:
    """True inside a CUDA graph's capture on this thread's current stream
    (False on a build of torch without CUDA)."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def take(stack: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """stack[index] for a one-element int64 device `index`, without the host
    read a tensor subscript makes (which a capture refuses)."""
    return stack.index_select(0, index)[0]


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    stream = _STREAMS.get(index)
    if stream is None:
        stream = _STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


class StepGraph:
    """`step()` warmed up (one eager call: the caller's first step) and
    captured on `device`; ``replay()`` runs it again. `generators`: the
    ``torch.Generator``s it draws from, registered with the graph.
    ``capture_s``: the host seconds of the capture, warm-up excluded;
    ``launches``: the kernel launches one replay counts."""

    def __init__(self, step: Callable[[], None], device,
                 generators: Sequence[torch.Generator] = ()):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device; got %s"
                             % device)
        stream = _capture_stream(device)
        ambient = torch.cuda.current_stream(device)
        stream.wait_stream(ambient)
        with torch.cuda.stream(stream):
            step()
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        t0 = time.perf_counter()
        with span("lirec.graph.capture"), torch.cuda.stream(stream), \
                dispatch.recording_launches() as launches:
            self.graph.capture_begin()
            try:
                step()
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass  # the capture was invalidated: report its cause
                raise
            self.graph.capture_end()
        ambient.wait_stream(stream)
        self.capture_s = time.perf_counter() - t0
        CAPTURE_SECONDS.append(self.capture_s)
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        dispatch.count_replay(self.launches)
