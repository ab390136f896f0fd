"""The mesh train step (counterpart of lirec_tpu/parallel/step.py).

Every process of the group holds the same global batch. The step pads a
ragged one to the full batch size (train/loop._pad_batch, loss_weight 0 on
the padded rows), keeps this rank's contiguous block of rows
(data/pipeline.local_batch; the batch-level ``uniq_*`` ids stay whole),
and runs the forward, the loss and the backward on them. The loss divides
by the global batch's counts (models/losses.py under
parallel/dist.sharded_batch), so the ranks' losses add up to the global
batch's loss and their gradients to the global batch's gradient, as the
JAX package's one program over the mesh computes it. After the backward,
one ``all_reduce(SUM)`` per dtype of the flat gradient buffer over the
data group (below) gives every rank that sum, and Adam then runs on every
rank on the same gradient. Dropout masks and the loss's samples are drawn
at the global batch's shape from the step's generators
(train/loop.step_generators), so the run is the single-process run up to
the order of the gradient sum. In a world of one no collective runs in
the loss, the all-reduce over one process returns its input, and the step
is the single-process step bit for bit.

The gradients are views into one static flat buffer per dtype, zeroed in
place at the start of every step (train/loop.make_train_step's
``static_grads``): the all-reduce is one call per buffer, and the buffers
stay the same tensors across steps, so that the epoch sweep can capture
the whole step, collectives included, as a CUDA graph over an NCCL group
(train/sweep.py). Every collective of the step is a plain call on the
current stream; no hook runs outside it. A parameter that gets no
gradient contributes zeros (every preset's loss reaches every parameter:
tests/test_torch_dist_train.py).

At construction the parameters and buffers of the data group's first
process are broadcast over the data group, so that every rank starts from
the same state.

Under a model axis (parallel/mesh.py, M > 1) the model holds this
process's slices of the tensor-parallel layers (shard_model) and its
forward and backward exchange activations over the model group
(models/layers.linear); the gradient all-reduce and the broadcast then
run over the data group alone (the processes of this column, which hold
the same slices), and the counts the loss divides by are summed over it
too. The parameters replicated across a model group stay bitwise equal
without any collective over it: its processes put the same inputs
through the same kernels and get the same all-reduced activations.

The returned loss is the global batch's: the ranks' losses summed over
the data group.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from lirec_tpu_torch.data.pipeline import local_batch
from lirec_tpu_torch.parallel import dist

__all__ = ["make_dp_train_step"]


class _FlatGrads:
    """The gradients of `params` as views into one flat buffer per dtype:
    ``zero()`` puts each view back as its parameter's ``.grad`` (where
    something set another, or None) and zeroes the buffers in place;
    ``all_reduce(group)`` sums each buffer over `group`."""

    def __init__(self, params):
        self.pairs: List = []
        self.buffers: Dict[torch.dtype, torch.Tensor] = {}
        params = [p for p in params if p.requires_grad]
        for dtype in dict.fromkeys(p.dtype for p in params):
            group = [p for p in params if p.dtype == dtype]
            flat = torch.zeros(sum(p.numel() for p in group), dtype=dtype,
                               device=group[0].device)
            offset = 0
            for p in group:
                self.pairs.append((p, flat[offset:offset + p.numel()]
                                   .view_as(p)))
                offset += p.numel()
            self.buffers[dtype] = flat

    def zero(self) -> None:
        for p, view in self.pairs:
            if p.grad is not view:
                p.grad = view
        for flat in self.buffers.values():
            flat.zero_()

    def all_reduce(self, group) -> None:
        td = dist._group()
        if td is None:
            return
        for flat in self.buffers.values():
            td.all_reduce(flat, group=group)


def _broadcast_state(model: torch.nn.Module, mesh: dist.Mesh2D) -> None:
    """The parameters and buffers of the data group's first process (the
    process at (0, m): global rank m) copied to every process of the
    group, in place. A data axis of 1 (or no process group) changes
    nothing."""
    td = dist._group()
    if td is None or mesh.size == 1:
        return
    for t in list(model.parameters()) + list(model.buffers()):
        td.broadcast(t.detach(), src=mesh.model_rank, group=mesh.data_group)


def make_dp_train_step(bundle, optimizer, mesh: dist.Mesh2D,
                       batch_size: int, deterministic: bool = False):
    """step(batch, tables, generators, tr_sum_max_flag=True) -> the global
    batch's loss: train/loop.make_train_step over the mesh `mesh` (a
    model axis above 1 needs ``bundle.model`` sharded by
    parallel/mesh.shard_model).
    `batch` is the global host batch (every rank passes the same one; a
    ragged one is padded here to `batch_size`, which must divide by the
    data axis), or this rank's rows of the padded global batch as
    data/pipeline.prefetch_to_device or the epoch sweep staged them;
    `tables` this rank's device tables (None for dense batches).
    deterministic=True turns dropout off. Every process of the data group
    must build the step (the broadcast)."""
    from lirec_tpu_torch.train.loop import (
        _pad_batch, _to_device, check_batch, staged, train_loss,
    )

    if batch_size % mesh.size:
        raise ValueError(
            "the batch size %d does not divide by the data axis of %d: "
            "each rank takes an equal block of every batch, as the JAX "
            "package's sharding does" % (batch_size, mesh.size))
    model = bundle.model
    device = next(model.parameters()).device
    _broadcast_state(model, mesh)
    grads = _FlatGrads(model.parameters())

    def step(batch, tables, generators, tr_sum_max_flag=True):
        if not staged(batch, device):
            check_batch(batch, tables)
            if len(batch["labels"]) != batch_size:
                batch = _pad_batch(batch, batch_size)
            batch = _to_device(local_batch(batch, mesh), device)
        grads.zero()
        with dist.sharded_batch(mesh):
            loss = train_loss(bundle, batch, tables, generators,
                              tr_sum_max_flag, deterministic)
            loss.backward()
            total = dist.batch_total(loss.detach())
        grads.all_reduce(mesh.data_group)
        optimizer.step()
        return total

    return step
