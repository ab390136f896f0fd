"""Training loop (ref `mlp/train.py:21-107`; counterpart of
lirec_tpu/train/loop.py), eager, one step per batch.

Per epoch: the shuffled batches of data/pipeline.EpochIterator (size-1
batches skipped, ref :55-56), localized together to batch-local tables
(data/localize.Localizer), a ragged last batch padded to the full batch
size with ``loss_weight`` 0 (one batch shape per epoch; padded rows drop
out of every loss mean), then one forward + loss + backward + Adam step
each. Step i of epoch e draws its dropout masks and its loss sampling from
two ``torch.Generator``s seeded from (seed, e * 100003 + i), as the JAX
package folds its key. The ``tr_sum_max`` curriculum flips at epoch 20
(ref :49-51).

Not in this slice, and raised rather than skipped: cadence evaluation on
``val_dataset``/``test_dataset`` (eval-sweep slice), a device mesh
(multi-GPU slice), dense batches, and checkpoint writing. The one-dispatch
epoch sweep of the JAX package is not ported.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from lirec_tpu.utils.meters import Averaging, MetricsLogger
from lirec_tpu_torch.data.localize import Localizer
from lirec_tpu_torch.data.pipeline import EpochIterator
from lirec_tpu_torch.train.optim import make_optimizer

__all__ = ["train", "make_train_step", "step_generators"]

MODEL_KEYS = ("feat_idx", "rels_mask", "uniq_clip", "uniq_track")


def step_generators(seed: int, offset: int, device):
    """(dropout generator, loss generator) on `device` for one step: two
    independent streams from the seed sequence (seed, offset)."""
    s_drop, s_loss = np.random.SeedSequence([seed, offset]).generate_state(
        2, np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(int(s))
                 for s in (s_drop, s_loss))


def check_indices(batch: Dict, n_clips: int, n_tracks: int) -> None:
    """Raise on row ids outside the tables (the gathers and the scatter
    kernel do not check them): feat_idx against the batch-local tables
    when the batch has them, and those against the full tables."""
    fi = np.asarray(batch["feat_idx"])
    n_c, n_t = n_clips, n_tracks
    if "uniq_clip" in batch:
        for key, n in (("uniq_clip", n_clips), ("uniq_track", n_tracks)):
            ids = np.asarray(batch[key])
            if ids.size and (ids.min() < 0 or ids.max() >= n):
                raise ValueError("%s out of range [0, %d)" % (key, n))
        n_c, n_t = len(batch["uniq_clip"]), len(batch["uniq_track"])
    for name, ids, n in (("clip", fi[..., 0], n_c),
                         ("track", fi[..., 1:], n_t)):
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise ValueError("%s index out of range [0, %d)" % (name, n))


def _to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def make_train_step(bundle, optimizer):
    """step(batch, tables, generators, tr_sum_max_flag=True) -> loss: one
    forward (dropout on) + loss + backward + optimizer step of
    ``bundle.model`` on a host batch (checked, then moved to the model's
    device). `tables`: the feature tables as tensors on that device;
    `generators`: (dropout, loss) from ``step_generators``."""
    model = bundle.model
    device = next(model.parameters()).device

    def step(batch, tables, generators, tr_sum_max_flag=True):
        check_indices(batch, tables["text"].shape[0],
                      tables["track"].shape[0])
        batch = _to_device(batch, device)
        gen_drop, gen_loss = generators
        model_batch = {k: batch[k] for k in MODEL_KEYS if k in batch}
        optimizer.zero_grad(set_to_none=True)
        outputs = bundle.apply(model, model_batch, tables=tables,
                               deterministic=False, rng=gen_drop)
        loss = bundle.loss(outputs, batch, rng=gen_loss,
                           tr_sum_max_flag=tr_sum_max_flag)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _pad_batch(batch: Dict, full_batch: int) -> Dict:
    """Pad a ragged batch to the full batch size by repeating row 0 with
    ``loss_weight`` 0; batch-level keys (uniq_*) are not padded."""
    n = np.asarray(batch["labels"]).shape[0]
    pad = full_batch - n
    out = {}
    for k, v in batch.items():
        if k in ("uniq_clip", "uniq_track"):
            out[k] = v
            continue
        v = np.asarray(v)
        fill = np.broadcast_to(v[:1], (pad,) + v.shape[1:])
        out[k] = np.concatenate([v, fill.astype(v.dtype)], axis=0)
    out["loss_weight"] = np.concatenate(
        [np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return out


def _collect_batches(iterator):
    """One epoch of host batches, size-1 batches skipped (ref
    mlp/train.py:55-56)."""
    return [
        b for b in iterator
        if (b["labels"].shape[0] if b["labels"].ndim else 1) > 1
    ]


def train(
    cfg,
    bundle,
    train_dataset,
    val_dataset=None,
    test_dataset=None,
    tables: Optional[Dict] = None,
    optimizer: Optional[torch.optim.Optimizer] = None,
    verbose: bool = True,
    dense: bool = False,
    metrics_log_path: Optional[str] = None,
    start_epoch: int = 0,
    checkpoint_every: int = 0,
    drop_last: bool = False,
    mesh=None,
    localize_tables: Optional[bool] = None,
) -> Dict:
    """Run the epoch loop on ``bundle.model``'s device; returns {'model',
    'optimizer', 'losses' (mean per epoch), 'localized_tables'}.

    `tables` default to the dataset's (``train_dataset.tables``); they are
    moved to the device once. `optimizer` defaults to ``make_optimizer``
    over the model's parameters (pass one to resume, e.g. with a state from
    checkpoint.opt_state_from_jax)."""
    o, t = cfg.optim, cfg.tasks
    later = []
    if val_dataset is not None or test_dataset is not None:
        later.append("cadence evaluation on val/test datasets (eval-sweep "
                     "slice)")
    if mesh is not None:
        later.append("a device mesh (multi-GPU slice)")
    if dense:
        later.append("dense batches")
    if cfg.paths.store_root and (o.save_model or checkpoint_every):
        later.append("checkpoint writing (save_model / checkpoint_every "
                     "with a store_root)")
    if later:
        raise NotImplementedError("lirec_tpu_torch.train does not port "
                                  "yet: " + "; ".join(later))
    model = bundle.model
    device = next(model.parameters()).device
    if tables is None:
        tables = train_dataset.tables.as_dict()
    tables = {k: torch.as_tensor(np.asarray(tables[k], np.float32),
                                 device=device)
              for k in ("text", "visual", "track")}
    if optimizer is None:
        optimizer = make_optimizer(model.parameters(), o.lr, o.weight_decay)
    localizer = None
    if localize_tables is not False:
        localizer = Localizer(bundle.spec,
                              n_clips=tables["text"].shape[0],
                              n_tracks=tables["track"].shape[0],
                              force=localize_tables)
    step = make_train_step(bundle, optimizer)
    iterator = EpochIterator(train_dataset, o.batch_size, seed=o.seed,
                             drop_last=drop_last)
    tr_sum_max_flag = t.tr_sum_max_flag
    metrics_log = MetricsLogger(metrics_log_path)

    losses = []
    for epoch in range(start_epoch, o.epochs):
        if t.tr_sum_max and epoch >= 20:
            tr_sum_max_flag = True  # curriculum flip (ref :49-51)
        batch_time, data_time, loss_meter = (Averaging(), Averaging(),
                                             Averaging())
        start = end = time.time()
        batches = _collect_batches(iterator)
        if localizer is not None:
            batches = localizer.maybe_localize(batches)
        data_time.update(time.time() - end)
        epoch_losses = []
        for i, batch in enumerate(batches):
            n = batch["labels"].shape[0]
            if n != o.batch_size:
                batch = _pad_batch(batch, o.batch_size)
            loss = step(batch, tables,
                        step_generators(o.seed, epoch * 100003 + i, device),
                        tr_sum_max_flag=tr_sum_max_flag)
            loss = float(loss)
            epoch_losses.append(loss)
            loss_meter.update(loss, n)
            batch_time.update(time.time() - end)
            end = time.time()
            if verbose and i and i % 10 == 0:
                print("Epoch: [%d][%d/%d]\tTime %.3f (%.3f)\tLoss %.4f "
                      "(%.4f)" % (epoch, i, len(batches), batch_time.val,
                                  batch_time.avg, loss_meter.val,
                                  loss_meter.avg))
        losses.append(float(np.mean(epoch_losses)) if epoch_losses else 0.0)
        if verbose:
            print("epoch %d loss: %f (%.2fs)"
                  % (epoch, losses[-1], time.time() - start))
        metrics_log.log({"epoch": epoch, "loss": losses[-1],
                         "batch_time_avg": batch_time.avg,
                         "data_time_avg": data_time.avg})
    return {
        "model": model,
        "optimizer": optimizer,
        "losses": losses,
        "localized_tables": bool(localizer and localizer.applied),
    }
