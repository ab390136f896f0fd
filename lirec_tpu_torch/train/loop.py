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

Every ``test_fr`` epochs, with a ``val_dataset``, the cadence evaluation
(ref :75-91) runs the packed sweep (evaluation/packed.evaluate_packed;
``host_eval``: the per-batch host loop, evaluation/runner.evaluate) on the
train split (with the training tables) and on val; a val result that
improves some metric goes to the ``BestNSaver`` (checkpoint/saver.py,
loss dropped) and triggers the test split's evaluation. Each split is
materialized once per run. Checkpoints go under ``cfg.paths.store_root``:
the best-n files and ``index.json`` (``save_model``; every 30 epochs too
with ``save_model_often``), ``latest.pth.tar`` every ``checkpoint_every``
epochs, and ``<epochs-1>.pth.tar`` at the end, each a ``torch.save`` of
``{'epoch', 'state_dict', 'optimizer'}``; with ``checkpoint_backend=
"msgpack"`` the JAX package's files instead (``latest.ckpt``,
``<epochs-1>.ckpt``, best-n ``v%.4f_ep%d.ckpt`` params files).

With a data ``mesh`` (parallel/dist.py: one process per card, every
process runs train() on the same datasets), every process builds the same
shuffled global batches and steps its own rows of each
(parallel/step.make_dp_train_step; the batch size must divide by the data
axis); the cadence runs the sharded sweep, whose all-reduced metrics give
every process the same best-n decisions; only process 0 prints, logs and
writes checkpoints, between barriers.

As in the JAX package, the epoch iterator starts at epoch 0 whatever
``start_epoch`` is: a resumed run replays the shuffle order of epoch 0
onwards while its step generators follow the true epoch (ROADMAP.md queue
3). Not ported, and raised rather than skipped: a mesh with a ``model``
axis, and dense batches. The one-dispatch epoch sweep of the JAX package
is not ported.
"""

from __future__ import annotations

import os.path as ops
import time
from typing import Dict, Optional

import numpy as np
import torch

from lirec_tpu_torch.checkpoint.saver import (
    BACKENDS, BestNSaver, save_train_state_any,
)
from lirec_tpu_torch.data.localize import Localizer
from lirec_tpu_torch.data.pipeline import EpochIterator
from lirec_tpu_torch.evaluation.packed import evaluate_packed
from lirec_tpu_torch.evaluation.runner import MESH_HOST_EVAL, evaluate
from lirec_tpu_torch.parallel import dist
from lirec_tpu_torch.train.optim import make_optimizer
from lirec_tpu_torch.utils.meters import Averaging, MetricsLogger

__all__ = ["train", "make_train_step", "train_loss", "step_generators"]

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


def train_loss(bundle, batch, tables, generators, tr_sum_max_flag=True,
               deterministic: bool = False):
    """The training forward (the hybrid one; dropout on unless
    deterministic) and the loss of a batch of device tensors.
    `generators`: (dropout, loss) from ``step_generators``."""
    gen_drop, gen_loss = generators
    outputs = bundle.apply(
        bundle.model, {k: batch[k] for k in MODEL_KEYS if k in batch},
        tables=tables, deterministic=deterministic, rng=gen_drop,
        use_tabular=False)
    return bundle.loss(outputs, batch, rng=gen_loss,
                       tr_sum_max_flag=tr_sum_max_flag)


def make_train_step(bundle, optimizer, deterministic: bool = False):
    """step(batch, tables, generators, tr_sum_max_flag=True) -> loss: one
    forward (dropout on unless deterministic) + loss + backward +
    optimizer step of ``bundle.model`` on a host batch (checked, then
    moved to the model's device). `tables`: the feature tables as tensors
    on that device; `generators`: (dropout, loss) from
    ``step_generators``. parallel/step.make_dp_train_step is its
    data-parallel form."""
    device = next(bundle.model.parameters()).device

    def step(batch, tables, generators, tr_sum_max_flag=True):
        check_indices(batch, tables["text"].shape[0],
                      tables["track"].shape[0])
        batch = _to_device(batch, device)
        optimizer.zero_grad(set_to_none=True)
        loss = train_loss(bundle, batch, tables, generators,
                          tr_sum_max_flag, deterministic)
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
    host_eval: bool = False,
    localize_tables: Optional[bool] = None,
    eval_localize=None,
    checkpoint_backend: str = "torch",
) -> Dict:
    """Run the epoch loop on ``bundle.model``'s device; returns {'model',
    'optimizer', 'saver', 'losses' (mean per epoch), 'final_path',
    'localized_tables'}.

    `tables` default to the dataset's (``train_dataset.tables``); they are
    moved to the device once. `optimizer` defaults to ``make_optimizer``
    over the model's parameters (pass one to resume, with its state from a
    train checkpoint or checkpoint.opt_state_from_jax). `eval_localize` is
    the cadence sweep's ``localize_ctx``. `mesh`: a parallel/dist.DataMesh
    or a (data, model) shape over this process group. `checkpoint_backend`:
    'torch' (.pth.tar) or 'msgpack' (the JAX package's .ckpt files)."""
    o, t = cfg.optim, cfg.tasks
    if dense:
        raise NotImplementedError("lirec_tpu_torch.train does not port "
                                  "yet: dense batches")
    if mesh is not None:
        mesh = dist.make_mesh(mesh)
        if host_eval:
            raise ValueError(MESH_HOST_EVAL)
    lead = mesh is None or mesh.rank == 0  # the process that writes
    verbose = verbose and lead
    suffix = BACKENDS[checkpoint_backend]
    model = bundle.model
    device = next(model.parameters()).device
    if tables is None:
        tables = train_dataset.tables.as_dict()
    tables = {k: torch.as_tensor(tables[k], dtype=torch.float32,
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
    if mesh is None:
        step = make_train_step(bundle, optimizer)
    else:
        from lirec_tpu_torch.parallel.step import make_dp_train_step

        step = make_dp_train_step(bundle, optimizer, mesh, o.batch_size)
    iterator = EpochIterator(train_dataset, o.batch_size, seed=o.seed,
                             drop_last=drop_last)
    tr_sum_max_flag = t.tr_sum_max_flag
    metrics_log = MetricsLogger(metrics_log_path if lead else None)
    store = cfg.paths.store_root
    saver = BestNSaver(path=store, n=o.keep_best_n,
                       backend=checkpoint_backend)
    eval_data: Dict[int, Dict] = {}

    def cadence_eval(ds, mode, tables=None):
        # datasets without the packed interface keep the host loop
        if host_eval or not hasattr(ds, "materialize"):
            return evaluate(ds, bundle, model, cfg, mode=mode, tables=tables,
                            verbose=verbose, mesh=mesh)
        # each split materialized once for the whole run (the train split's
        # eval-time context draws are frozen with it)
        data = eval_data.get(id(ds))
        if data is None:
            data = eval_data[id(ds)] = ds.materialize()
        return evaluate_packed(ds, bundle, model, cfg, mode=mode,
                               tables=tables, verbose=verbose, data=data,
                               localize_ctx=eval_localize, mesh=mesh)

    def train_state():
        return {"state_dict": model.state_dict(),
                "optimizer": optimizer.state_dict()}

    def write(fn, *args):
        """fn(*args) on process 0 only, the others waiting at barriers
        before and after (the JAX package's process-0 writes)."""
        dist.barrier("before a checkpoint")
        if lead:
            fn(*args)
        dist.barrier("after a checkpoint")

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

        if epoch % o.test_fr == 0 and val_dataset is not None:
            # each dataset evaluates with its own tables; only the train
            # split reuses the training ones (ref :75-91)
            cadence_eval(train_dataset, "train", tables=tables)
            check_val = {k: v for k, v in cadence_eval(
                val_dataset, "val").items() if k != "loss"}
            if saver.check(check_val):
                saver.update(check_val, dict(train_state(), epoch=epoch),
                             epoch)
                if test_dataset is not None:
                    cadence_eval(test_dataset, "test")
        if o.save_model and o.save_model_often and epoch % 30 == 0:
            write(saver.save)
        if checkpoint_every and store and (epoch + 1) % checkpoint_every == 0:
            # a resumable state (the reference has no failure recovery,
            # SURVEY.md 5.3); --auto-resume picks it up
            write(save_train_state_any, ops.join(store, "latest" + suffix),
                  model, optimizer, epoch, checkpoint_backend)

    final_path = ""
    if o.save_model and store:
        final_path = ops.join(store, "%d%s" % (o.epochs - 1, suffix))

        def final():
            save_train_state_any(final_path, model, optimizer, o.epochs - 1,
                                 checkpoint_backend)
            saver.save()

        write(final)
    return {
        "model": model,
        "optimizer": optimizer,
        "saver": saver,
        "losses": losses,
        "final_path": final_path,
        "localized_tables": bool(localizer and localizer.applied),
    }
