"""The one-dispatch epoch sweep (counterpart of lirec_tpu/train/loop.
make_epoch_sweep, ``_stack_epoch_batches`` and the chunked dispatch of its
``train()``), the default training path of train/loop.train.

An epoch's host batches (collected and localized together, as the
per-batch path collects them) are padded and stacked into ``[S, B, ...]``
arrays as the JAX package stacks them: a ragged batch is padded to the
full batch size with ``loss_weight`` 0, and when any batch is ragged every
batch carries a ``loss_weight``, so that the stacked keys are uniform.
Each chunk of at most ``sweep_max_steps`` steps is staged on the device at
once (from pinned memory on a card), and its steps run in order: step i of
the chunk at c0 draws from ``step_generators(seed, epoch * 100003 + c0 +
i)``, the seeds the per-batch path gives that step, so both paths take
the same trajectory. The losses stay on the device until ``fetch``.

On a card, each step is one replay of a CUDA graph of the whole step
(forward, loss, backward and Adam; utils/graphs.StepGraph), captured once
per key of batch shapes and curriculum flag (the full shapes: the
Localizer's caps grow across epochs). The graph reads batch i of a static
``[S, B, ...]`` stack through a device-side step index that it advances;
each chunk is copied into that stack. The gradients are static buffers,
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

from typing import Dict, List, Optional

import numpy as np
import torch

from lirec_tpu_torch.data.pipeline import BATCH_LEVEL_KEYS
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.utils.profiling import span

__all__ = ["EpochSweep", "stack_epoch_batches", "SEED_STRIDE"]

SEED_STRIDE = 100003  # step offsets of one epoch: epoch * SEED_STRIDE + i


def stack_epoch_batches(batches: List[Dict], full_batch: int) -> Dict:
    """An epoch's (or a chunk's) host batches as ``[S, B, ...]`` arrays;
    ragged batches go through ``_pad_batch``, and when any is padded every
    batch carries a ``loss_weight``."""
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


class _Captured:
    """The static state of one graph: the stack of a chunk's batches, the
    step index, the losses, the two generators, the graph, and the
    gradient buffers it writes (``grads``: kept alive, so that the graph
    stays whole if an eager step of the same model sets them to None)."""

    def __init__(self, host: Dict[str, torch.Tensor], device):
        steps = len(host["labels"])
        self.stack = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                      for k, v in host.items()}
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
        else:
            from lirec_tpu_torch.parallel.step import make_dp_train_step

            self.step = make_dp_train_step(bundle, optimizer, mesh,
                                           batch_size)
        self.params = list(bundle.model.parameters())
        self.tables = tables
        self.seed = seed
        self.batch_size = batch_size
        self.mesh = mesh
        self.chunk = max(int(sweep_max_steps), 1)
        self.capture_s: List[float] = []
        self._captured: Dict = {}

    def run(self, batches: List[Dict], epoch: int,
            tr_sum_max_flag: bool = True) -> List[torch.Tensor]:
        """Step the epoch's host batches (checked, unpadded, in order);
        returns one device tensor of losses per chunk."""
        out = []
        for c0 in range(0, len(batches), self.chunk):
            with span("lirec.train.stack"):
                stacked = stack_epoch_batches(batches[c0:c0 + self.chunk],
                                              self.batch_size)
            offset = epoch * SEED_STRIDE + c0
            shapes = {k: tuple(v.shape) for k, v in stacked.items()}
            dispatch.record("train_loop", "graph" if self.graph else "eager",
                            self.reason, shapes)
            run = self._run_graph if self.graph else self._run_eager
            out.append(run(stacked, offset, bool(tr_sum_max_flag)))
        return out

    @staticmethod
    def fetch(losses: List[torch.Tensor]) -> List[float]:
        """The host values of ``run``'s losses (one read per chunk)."""
        with span("lirec.train.fetch"):
            return [float(x) for part in losses for x in part.cpu().numpy()]

    def _host(self, stacked: Dict) -> Dict[str, torch.Tensor]:
        """The stacked arrays as host tensors (this rank's rows under a
        mesh), pinned where they go to a card."""
        rows = slice(None)
        if self.mesh is not None:
            from lirec_tpu_torch.parallel.mesh import process_local_slice

            rows = process_local_slice(self.mesh, self.batch_size)
        out = {}
        with span("lirec.train.pin"):
            for k, v in stacked.items():
                t = torch.from_numpy(v if k in BATCH_LEVEL_KEYS
                                     else np.ascontiguousarray(v[:, rows]))
                out[k] = t.pin_memory() if self.device.type == "cuda" else t
        return out

    def _run_eager(self, stacked, offset, flag):
        from lirec_tpu_torch.train.loop import step_generators

        host = self._host(stacked)
        with span("lirec.train.h2d"):
            staged = {k: v.to(self.device, non_blocking=True)
                      for k, v in host.items()}
        losses = torch.empty(len(stacked["labels"]), dtype=torch.float32,
                             device=self.device)
        with span("lirec.train.replays"):
            for i in range(len(losses)):
                losses[i] = self.step(
                    {k: v[i] for k, v in staged.items()}, self.tables,
                    step_generators(self.seed, offset + i, self.device),
                    tr_sum_max_flag=flag)
        return losses

    def _run_graph(self, stacked, offset, flag):
        from lirec_tpu_torch.train.loop import step_seeds
        from lirec_tpu_torch.utils.graphs import StepGraph, take

        steps = len(stacked["labels"])
        key = (tuple(sorted((k, v.shape[1:], v.dtype.str)
                            for k, v in stacked.items())), flag)
        host = self._host(stacked)  # this rank's rows under a mesh
        cap = self._captured.get(key)
        if cap is None or cap.capacity < steps:
            # the Localizer's caps only grow and the flag flips once: the
            # older graphs (and their memory) are not needed again
            self._captured.clear()
            cap = self._captured[key] = _Captured(host, self.device)
        with span("lirec.train.h2d"):
            for k, v in host.items():
                cap.stack[k][:steps].copy_(v, non_blocking=True)
        cap.index.zero_()

        def step():
            batch = {k: take(v, cap.index) for k, v in cap.stack.items()}
            loss = self.step(batch, self.tables, cap.generators,
                             tr_sum_max_flag=flag)
            cap.losses.index_copy_(0, cap.index, loss.reshape(1).float())
            cap.index.add_(1)

        with span("lirec.train.replays"):
            for i in range(steps):
                for gen, s in zip(cap.generators, step_seeds(self.seed,
                                                             offset + i)):
                    gen.manual_seed(s)
                if cap.graph is None:  # its warm-up is this step
                    cap.graph = StepGraph(step, self.device, cap.generators)
                    cap.grads = [p.grad for p in self.params]
                    self.capture_s.append(cap.graph.capture_s)
                else:
                    cap.graph.replay()
        return cap.losses[:steps].clone()
