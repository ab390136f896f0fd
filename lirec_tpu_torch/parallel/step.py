"""The data-parallel train step (counterpart of lirec_tpu/parallel/step.py,
its data axis).

Every process of the group holds the same global batch. The step pads a
ragged one to the full batch size (train/loop._pad_batch, loss_weight 0 on
the padded rows), keeps this rank's contiguous block of rows
(data/pipeline.local_batch; the batch-level ``uniq_*`` ids stay whole),
and runs the forward and the loss on them inside
``DistributedDataParallel``. The loss divides by the global batch's
counts (models/losses.py under parallel/dist.sharded_batch), so the
ranks' losses add up to the global batch's loss; scaled by the world size
before DDP's mean over ranks, their gradients add up to the global batch's
gradient, as the JAX package's one program over the mesh computes it. Adam
then runs on every rank on the same gradient. Dropout masks and the loss's
samples are drawn at the global batch's shape from the step's generators
(train/loop.step_generators), so the run is the single-process run up to
the order of the gradient sum. In a world of one no collective runs in the
loss and the step is the single-process step bit for bit (DDP's mean over
one rank divides by 1).

Every preset's loss reaches every parameter (int_rel_ch, int_ch, int_rels
and modalities, each run through two ranks: tests/test_torch_dist_train.py),
so DDP runs without its per-step search for unused parameters.

The returned loss is the global batch's: the ranks' losses summed over
the group.
"""

from __future__ import annotations

import torch

from lirec_tpu_torch.data.pipeline import local_batch
from lirec_tpu_torch.parallel import dist

__all__ = ["make_dp_train_step"]


class _TrainForward(torch.nn.Module):
    """train/loop.train_loss as a module, so that DDP sees the whole graph
    the gradient flows through."""

    def __init__(self, bundle):
        super().__init__()
        self.model = bundle.model
        self.bundle = bundle

    def forward(self, batch, tables, generators, tr_sum_max_flag,
                deterministic):
        from lirec_tpu_torch.train.loop import train_loss

        return train_loss(self.bundle, batch, tables, generators,
                          tr_sum_max_flag, deterministic)


def make_dp_train_step(bundle, optimizer, mesh: dist.DataMesh,
                       batch_size: int, deterministic: bool = False):
    """step(batch, tables, generators, tr_sum_max_flag=True) -> the global
    batch's loss: train/loop.make_train_step over the data axis `mesh`.
    `batch` is the global host batch (every rank passes the same one; a
    ragged one is padded here to `batch_size`, which must divide by the
    data axis), `tables` this rank's device tables. deterministic=True
    turns dropout off."""
    from lirec_tpu_torch.train.loop import (
        _pad_batch, _to_device, check_indices,
    )

    if batch_size % mesh.size:
        raise ValueError(
            "the batch size %d does not divide by the data axis of %d: "
            "each rank takes an equal block of every batch, as the JAX "
            "package's sharding does" % (batch_size, mesh.size))
    model = bundle.model
    device = next(model.parameters()).device
    ddp = torch.nn.parallel.DistributedDataParallel(
        _TrainForward(bundle),
        device_ids=[device.index] if device.type == "cuda" else None)

    def step(batch, tables, generators, tr_sum_max_flag=True):
        check_indices(batch, tables["text"].shape[0],
                      tables["track"].shape[0])
        if len(batch["labels"]) != batch_size:
            batch = _pad_batch(batch, batch_size)
        batch = _to_device(local_batch(batch, mesh), device)
        optimizer.zero_grad(set_to_none=True)
        with dist.sharded_batch(mesh):
            loss = ddp(batch, tables, generators, tr_sum_max_flag,
                       deterministic)
            scaled = loss * mesh.size if mesh.size > 1 else loss
            scaled.backward()
            total = dist.batch_total(loss.detach())
        optimizer.step()
        return total

    return step
