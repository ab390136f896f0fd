"""The one-dispatch epoch sweep (counterpart of lirec_tpu/train/loop.
make_epoch_sweep, ``_stack_epoch_batches`` and the chunked dispatch of its
``train()``), the default training path of train/loop.train.

An epoch's host batches (collected and localized together, as the
per-batch path collects them) are staged in the layout in which the JAX
package stacks them (``stack_epoch_batches``: ``[S, B, ...]`` arrays; a
ragged batch padded to the full batch size with ``loss_weight`` 0, and
when any batch is ragged every batch carries a ``loss_weight``, so that
the keys are uniform). Each chunk of at most ``sweep_max_steps`` steps is
staged and stepped a slab of ``SLAB_STEPS`` steps at a time: the slab's
batches are written row by row into a persistent host stack (pinned on a
card; span ``lirec.train.stack``), the slab's rows are copied into the
same rows of the device stack on the steps' own stream (``non_blocking``;
span ``lirec.train.h2d``), and the slab's steps are enqueued (span
``lirec.train.replays``); the host then fills the next slab while the
card runs this one, so that the card waits for the first slab alone. The
two stacks are made with the state they serve (span ``lirec.train.pin``)
and kept until the batches' shapes change; an event a slab keeps a later
call from writing rows whose copy has not left them. Nothing staged is
kept for a later call: each call stages the batches it is given.
``dispatch.decisions("train_staging")`` counts the chunks staged so
(path "slabs"), the last record giving the chunk's steps, the slab and
the number of slabs. Step i of the chunk at c0 draws from
``step_generators(seed, epoch * 100003 + c0 + i)``, the seeds the
per-batch path gives that step, so both paths take the same trajectory.
The losses stay on the device until ``fetch``.

On a card, each step is one replay of a CUDA graph of the whole step
(forward, loss, backward and Adam; utils/graphs.StepGraph), captured once
per key of batch shapes and curriculum flag (the full shapes: the
Localizer's caps grow across epochs). The graph reads batch i of a static
``[S, B, ...]`` stack (this rank's rows under a mesh) through a
device-side step index that it advances; each chunk's slabs are copied
into that stack. The gradients are static buffers,
zeroed inside the graph; Adam is capturable (train/optim.py); the two step
generators are registered with the graph and seeded before each replay. A
new graph's warm-up is the chunk's first step, run eagerly.

Under a mesh (parallel/step.make_dp_train_step) the step's collectives
(the gradient all-reduce over the data group, the loss's counts, the
model axis's activations) are plain NCCL calls on the current stream, and
the same graph holds them where the process group is NCCL: the warm-up
step makes every communicator the step uses before the capture begins.
A gloo group runs on the host and cannot be captured: there, and on the
CPU, the same structure runs eager steps. ``dispatch.decisions
("train_loop")`` counts which ran, once per chunk: "graph" (reason "cuda:
one graph per batch shape", or "cuda: nccl mesh"), or "eager" (reason
"cpu tensors", "data mesh", or "model mesh" under a model axis above 1).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from lirec_tpu_torch.data.pipeline import BATCH_LEVEL_KEYS
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.utils.profiling import span

__all__ = ["EpochSweep", "stack_epoch_batches", "SEED_STRIDE", "SLAB_STEPS"]

SEED_STRIDE = 100003  # step offsets of one epoch: epoch * SEED_STRIDE + i
# steps a slab: its rows are filled, copied to the card and stepped
# together, and the card waits for the first slab alone (a slab's fill is
# a small share of its steps' card time)
SLAB_STEPS = 8


def stack_epoch_batches(batches: List[Dict], full_batch: int) -> Dict:
    """An epoch's (or a chunk's) host batches as ``[S, B, ...]`` arrays;
    ragged batches go through ``_pad_batch``, and when any is padded every
    batch carries a ``loss_weight``. The layout the sweep stages its
    chunks in, a slab at a time (``EpochSweep``)."""
    from lirec_tpu_torch.train.loop import _pad_batch

    any_ragged = any(len(b["labels"]) != full_batch for b in batches)
    padded = []
    for b in batches:
        if len(b["labels"]) != full_batch:
            b = _pad_batch(b, full_batch)
        elif any_ragged:
            b = dict(b, loss_weight=np.ones(full_batch, np.float32))
        padded.append(b)
    return {k: np.stack([np.asarray(b[k]) for b in padded])
            for k in padded[0]}


def _layout(batches: List[Dict], full_batch: int
            ) -> Dict[str, Tuple[tuple, np.dtype]]:
    """Each key's shape and dtype of one step in ``stack_epoch_batches``'
    layout, from the batches' own shapes: the first batch's keys, a ragged
    batch's at the full batch size, and a ``loss_weight`` when any batch
    is ragged."""
    out = {}
    for k, v in batches[0].items():
        v = np.asarray(v)
        out[k] = (v.shape if k in BATCH_LEVEL_KEYS
                  else (full_batch,) + v.shape[1:], v.dtype)
    if any(len(b["labels"]) != full_batch for b in batches):
        out["loss_weight"] = ((full_batch,), np.dtype(np.float32))
    return out


def _fill(dst: Dict[str, np.ndarray], i: int, batch: Dict, full_batch: int,
          rows: slice) -> None:
    """Row i of the host stack `dst` from one host batch: padded as
    ``_pad_batch`` pads it where it is ragged, a ``loss_weight`` of ones
    where the stack carries one and the batch does not, `rows` of its
    samples (this rank's under a mesh)."""
    from lirec_tpu_torch.train.loop import _pad_batch

    if len(batch["labels"]) != full_batch:
        batch = _pad_batch(batch, full_batch)
    for k, d in dst.items():
        if k == "loss_weight" and k not in batch:
            d[i] = 1.0
        elif k in BATCH_LEVEL_KEYS:
            d[i] = np.asarray(batch[k])
        else:
            d[i] = np.asarray(batch[k])[rows]


class _Captured:
    """The static state of one chunk layout: the host stack (pinned on a
    card) and the device stack of a chunk's batches, ``[capacity, ...]``
    a key; one event a slab, recorded after its rows' copies (on a card);
    the step index, the losses, the two generators, the graph, and the
    gradient buffers it writes (``grads``: kept alive, so that the graph
    stays whole if an eager step of the same model sets them to None)."""

    def __init__(self, layout: Dict[str, Tuple[tuple, np.dtype]],
                 steps: int, device):
        pinned = device.type == "cuda"
        with span("lirec.train.pin"):
            self.host = {k: torch.from_numpy(np.empty(0, dtype)).new_empty(
                (steps,) + shape, pin_memory=pinned)
                for k, (shape, dtype) in layout.items()}
        self.rows = {k: v.numpy() for k, v in self.host.items()}
        self.stack = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                      for k, v in self.host.items()}
        self.copied = ([torch.cuda.Event()
                        for _ in range(-(-steps // SLAB_STEPS))]
                       if pinned else None)
        self.index = torch.zeros(1, dtype=torch.int64, device=device)
        self.losses = torch.zeros(steps, dtype=torch.float32, device=device)
        self.generators = (torch.Generator(device=device),
                           torch.Generator(device=device))
        self.graph = None
        self.grads = []

    @property
    def capacity(self) -> int:
        return len(self.losses)


def _backend(mesh) -> Optional[str]:
    """The backend of `mesh`'s data group ("nccl", "gloo"), or None where
    no process group is initialised."""
    from lirec_tpu_torch.parallel import dist

    td = dist._group()
    return None if td is None else td.get_backend(mesh.data_group)


class EpochSweep:
    """The epoch sweep of `bundle.model` with `optimizer` over the device
    `tables`: ``run(batches, epoch, flag)`` steps an epoch's host batches
    and returns its losses on the device, ``fetch`` reads them.

    Each step is a CUDA graph's replay on a card (under a mesh, over an
    NCCL group), an eager step otherwise; require_graph=True raises where
    a graph cannot serve (for checks that must not run eager steps).
    `mesh`: a parallel/mesh.Mesh2D, under which every rank passes the same
    global batches and steps its own rows (with its slices of the model,
    under a model axis).
    ``capture_s``: the capture seconds of each graph made, in order."""

    def __init__(self, bundle, optimizer, tables: Optional[Dict], seed: int,
                 batch_size: int, mesh=None, sweep_max_steps: int = 512,
                 require_graph: bool = False):
        from lirec_tpu_torch.train.loop import make_train_step

        self.device = next(bundle.model.parameters()).device
        on_card = self.device.type == "cuda"
        backend = None if mesh is None else _backend(mesh)
        if require_graph and backend == "gloo":
            raise ValueError("the mesh step is captured as a CUDA graph over "
                             "NCCL only; this process group's backend is "
                             "gloo, which runs on the host")
        if require_graph and not on_card:
            raise ValueError("the epoch sweep's CUDA graph needs the model "
                             "on a card; it is on %s" % self.device)
        graph = self.graph = on_card and backend != "gloo"
        self.reason = ("cuda: %s mesh" % backend if graph and backend
                       else "cuda: one graph per batch shape" if graph
                       else "cpu tensors" if mesh is None
                       else "model mesh" if mesh.model > 1
                       else "data mesh")
        if mesh is None:
            self.step = make_train_step(bundle, optimizer,
                                        static_grads=graph)
            self.rows = slice(None)
        else:
            from lirec_tpu_torch.parallel.mesh import process_local_slice
            from lirec_tpu_torch.parallel.step import make_dp_train_step

            self.step = make_dp_train_step(bundle, optimizer, mesh,
                                           batch_size)
            self.rows = process_local_slice(mesh, batch_size)
        self.params = list(bundle.model.parameters())
        self.tables = tables
        self.seed = seed
        self.batch_size = batch_size
        self.chunk = max(int(sweep_max_steps), 1)
        self.capture_s: List[float] = []
        self._captured: Dict = {}

    def run(self, batches: List[Dict], epoch: int,
            tr_sum_max_flag: bool = True) -> List[torch.Tensor]:
        """Step the epoch's host batches (checked, unpadded, in order);
        returns one device tensor of losses per chunk."""
        flag = bool(tr_sum_max_flag)
        out = []
        for c0 in range(0, len(batches), self.chunk):
            chunk = batches[c0:c0 + self.chunk]
            layout = _layout(chunk, self.batch_size)
            dispatch.record("train_loop", "graph" if self.graph else "eager",
                            self.reason, {k: (len(chunk),) + shape
                                          for k, (shape, _) in layout.items()})
            cap = self._state(layout, len(chunk), flag)
            run = self._run_graph if self.graph else self._run_eager
            out.append(run(cap, chunk, epoch * SEED_STRIDE + c0, flag))
        return out

    @staticmethod
    def fetch(losses: List[torch.Tensor]) -> List[float]:
        """The host values of ``run``'s losses (one read per chunk)."""
        with span("lirec.train.fetch"):
            return [float(x) for part in losses for x in part.cpu().numpy()]

    def _state(self, layout, steps: int, flag: bool) -> _Captured:
        """The static state of the chunk's layout and flag, made anew
        (stacks, and a graph to capture) where none holds `steps` steps."""
        key = (tuple(sorted((k, shape, dtype.str)
                            for k, (shape, dtype) in layout.items())), flag)
        cap = self._captured.get(key)
        if cap is None or cap.capacity < steps:
            # the Localizer's caps only grow and the flag flips once: the
            # older graphs (and their memory) are not needed again
            self._captured.clear()
            n = len(range(self.batch_size)[self.rows])
            local = {k: (shape if k in BATCH_LEVEL_KEYS
                         else (n,) + shape[1:], dtype)
                     for k, (shape, dtype) in layout.items()}
            cap = self._captured[key] = _Captured(local, steps, self.device)
        return cap

    def _slabs(self, cap: _Captured, batches: List[Dict]
               ) -> Iterator[Tuple[int, int]]:
        """The chunk's slabs as (first step, end step), each yielded once
        its rows are in the host stack and their copies into the device
        stack are enqueued on the current stream, the one the caller
        enqueues the slab's steps on."""
        steps = len(batches)
        slabs = range(0, steps, SLAB_STEPS)
        dispatch.record("train_staging", "slabs", "host stack" if
                        cap.copied is None else "pinned host stack",
                        {"steps": steps, "slab": SLAB_STEPS,
                         "slabs": len(slabs)})
        for j, s0 in enumerate(slabs):
            s1 = min(s0 + SLAB_STEPS, steps)
            with span("lirec.train.stack"):
                if cap.copied is not None:  # an earlier copy of the rows
                    cap.copied[j].synchronize()
                for i in range(s0, s1):
                    _fill(cap.rows, i, batches[i], self.batch_size,
                          self.rows)
            with span("lirec.train.h2d"):
                for k, v in cap.host.items():
                    cap.stack[k][s0:s1].copy_(v[s0:s1], non_blocking=True)
                if cap.copied is not None:
                    cap.copied[j].record()
            yield s0, s1

    def _run_eager(self, cap, batches, offset, flag):
        from lirec_tpu_torch.train.loop import step_generators

        losses = torch.empty(len(batches), dtype=torch.float32,
                             device=self.device)
        for s0, s1 in self._slabs(cap, batches):
            with span("lirec.train.replays"):
                for i in range(s0, s1):
                    losses[i] = self.step(
                        {k: v[i] for k, v in cap.stack.items()},
                        self.tables,
                        step_generators(self.seed, offset + i, self.device),
                        tr_sum_max_flag=flag)
        return losses

    def _run_graph(self, cap, batches, offset, flag):
        from lirec_tpu_torch.train.loop import step_seeds
        from lirec_tpu_torch.utils.graphs import StepGraph, take

        cap.index.zero_()

        def step():
            batch = {k: take(v, cap.index) for k, v in cap.stack.items()}
            loss = self.step(batch, self.tables, cap.generators,
                             tr_sum_max_flag=flag)
            cap.losses.index_copy_(0, cap.index, loss.reshape(1).float())
            cap.index.add_(1)

        for s0, s1 in self._slabs(cap, batches):
            with span("lirec.train.replays"):
                for i in range(s0, s1):
                    for gen, s in zip(cap.generators,
                                      step_seeds(self.seed, offset + i)):
                        gen.manual_seed(s)
                    if cap.graph is None:  # its warm-up is this step
                        cap.graph = StepGraph(step, self.device,
                                              cap.generators)
                        cap.grads = [p.grad for p in self.params]
                        self.capture_s.append(cap.graph.capture_s)
                    else:
                        cap.graph.replay()
        return cap.losses[:len(batches)].clone()
