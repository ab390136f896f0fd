"""Training loop (ref `mlp/train.py:21-107`; counterpart of
lirec_tpu/train/loop.py): the one-dispatch epoch sweep by default, or one
step per batch.

Per epoch: the shuffled batches of data/pipeline.EpochIterator (size-1
batches skipped, ref :55-56; ``assembly_workers`` > 0 assembles them in
an AssemblyPool of worker processes, bitwise the same batches), localized
together to batch-local tables (data/localize.Localizer). Then, by
default (``epoch_sweep=None``: on unless ``dense``), the epoch sweep
(train/sweep.EpochSweep): the batches padded and stacked as the JAX
package stacks them, in chunks of at most ``sweep_max_steps`` steps,
staged on the device a slab of steps at a time while the card runs the
previous slab, each step one replay of a CUDA graph of the
whole step on a card, under a mesh over an NCCL group too (eager steps
on the CPU and over gloo); the next epoch's batches are assembled while
the card runs this one, and the losses are read once per epoch. With ``epoch_sweep=False``
(``--per-batch-train``) or ``dense=True``, the per-batch path: a ragged
last batch padded to the full batch size with ``loss_weight`` 0 (one
batch shape per epoch; padded rows drop out of every loss mean), the
batches staged on the device ahead of their steps
(data/pipeline.prefetch_to_device: pinned memory and a side copy stream
on a card), one eager forward + loss + backward + Adam step each, and its
loss read after each step. ``dense=True`` trains on dense batches (the
reference layout, the JAX package's parity oracle): no tables, no
Localizer, batches streamed rather than collected per epoch, and the
cadence runs the host loop over dense batches. Step i of epoch e draws
its dropout masks and its loss sampling from two ``torch.Generator``s
seeded from (seed, e * 100003 + i), as the JAX package folds its key, on
both paths, so they take the same trajectory, bit for bit where every
batch is full. When one is ragged the sweep gives every batch a
``loss_weight`` of ones, and a weighted mean (a sum over the weight sum)
equals the plain mean only where the plain mean is a sum divided by the
count: on the CPU, and on a card at power-of-two batch sizes. The
``tr_sum_max`` curriculum flips at epoch 20 (ref :49-51).

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
``<epochs-1>.ckpt``, best-n ``v%.4f_ep%d.ckpt`` params files), and with
``"orbax"`` ``latest.ckpt`` and ``<epochs-1>.ckpt`` as the JAX package's
Orbax directories (the best-n files msgpack, as the JAX package writes
them).

With a ``mesh`` (parallel/mesh.py: a D x M grid of processes, one per
card, every process running train() on the same datasets), every process
builds the same shuffled global batches and steps its own rows of each,
by its data index, and their gradients are summed over the data axis
by one all-reduce a step (parallel/step.make_dp_train_step; the batch
size must divide by D). Under a model axis (M > 1) the model and the optimizer's
moments are cut to this process's slices first (parallel/mesh.shard_model;
the eval and the checkpoints then read a full replica that
parallel/mesh.gather_state fills in place, so that the eval sweep's kept
CUDA graph stays valid, and the returned model and optimizer are that
replica's). The cadence runs the sweep split over the data axis, whose
all-reduced metrics give every process the same best-n decisions; only
process 0 prints, logs and writes checkpoints, between barriers.

As in the JAX package, the epoch iterator starts at epoch 0 whatever
``start_epoch`` is: a resumed run replays the shuffle order of epoch 0
onwards while its step generators follow the true epoch (ROADMAP.md queue
3).
"""

from __future__ import annotations

import collections
import copy
import os.path as ops
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from lirec_tpu_torch.checkpoint.saver import (
    BACKENDS, BestNSaver, save_train_state_any,
)
from lirec_tpu_torch.data.localize import Localizer
from lirec_tpu_torch.data.pipeline import (
    EpochIterator, local_batch, prefetch_to_device,
)
from lirec_tpu_torch.evaluation.packed import evaluate_packed
from lirec_tpu_torch.evaluation.runner import MESH_HOST_EVAL, evaluate
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.parallel import dist
from lirec_tpu_torch.parallel.mesh import (
    Mesh2D, check_model_axis, gather_state, shard_model,
)
from lirec_tpu_torch.train.optim import file_state, load_state, make_optimizer
from lirec_tpu_torch.train.sweep import SEED_STRIDE, EpochSweep
from lirec_tpu_torch.utils.meters import Averaging, MetricsLogger
from lirec_tpu_torch.utils.profiling import span

__all__ = ["train", "make_train_step", "train_loss", "step_generators",
           "step_seeds"]

MODEL_KEYS = ("features", "feat_idx", "rels_mask", "uniq_clip",
              "uniq_track")


def step_seeds(seed: int, offset: int):
    """(dropout seed, loss seed) of one step: two independent streams from
    the seed sequence (seed, offset)."""
    return tuple(int(s) for s in np.random.SeedSequence(
        [seed, offset]).generate_state(2, np.uint64))


def step_generators(seed: int, offset: int, device):
    """(dropout generator, loss generator) on `device` for one step, seeded
    with ``step_seeds``."""
    return tuple(torch.Generator(device=device).manual_seed(s)
                 for s in step_seeds(seed, offset))


def check_indices(batch: Dict, n_clips: int, n_tracks: int) -> None:
    """Raise on row ids outside the tables (the gathers and the scatter
    kernel do not check them): feat_idx against the batch-local tables
    when the batch has them, and those against the full tables. Each
    array is read once (``_column_max``)."""
    n_c, n_t = n_clips, n_tracks
    if "uniq_clip" in batch:
        for key, n in (("uniq_clip", n_clips), ("uniq_track", n_tracks)):
            top = _column_max(batch[key], 1)
            if top and top[0] >= n:
                raise ValueError("%s out of range [0, %d)" % (key, n))
        n_c, n_t = len(batch["uniq_clip"]), len(batch["uniq_track"])
    fi = np.asarray(batch["feat_idx"])
    top = _column_max(fi, fi.shape[-1])
    for name, cols, n in (("clip", slice(0, 1), n_c),
                          ("track", slice(1, None), n_t)):
        if top[cols] and max(top[cols]) >= n:
            raise ValueError("%s index out of range [0, %d)" % (name, n))


def _column_max(ids, width: int) -> List[int]:
    """The greatest id of each of the `width` columns (the last axis) of
    the integer array `ids`, its ids read as unsigned, so that a negative
    id reads past every table: one pass over the array, the first axis
    reduced in blocks of the rest (contiguous) before the columns are;
    [] for no ids."""
    ids = np.asarray(ids)
    if ids.dtype.kind not in "iu":
        raise TypeError("row ids must be integers, not %s" % ids.dtype)
    if not ids.size:
        return []
    ids = ids.view(np.dtype("u%d" % ids.itemsize))
    if ids.ndim == 1:
        return [int(ids.max())]
    return ids.reshape(len(ids), -1).max(axis=0).reshape(
        -1, width).max(axis=0).tolist()


def check_batch(batch: Dict, tables: Optional[Dict]) -> None:
    """check_indices of a packed host batch against `tables`; a dense
    batch has no row ids."""
    if tables is not None and "feat_idx" in batch:
        with span("lirec.train.check"):
            check_indices(batch, tables["text"].shape[0],
                          tables["track"].shape[0])


def staged(batch: Dict, device) -> bool:
    """True for a batch of tensors on `device`'s type (as
    data/pipeline.prefetch_to_device stages them, checked before), False
    for a host batch."""
    return all(isinstance(v, torch.Tensor) and v.device.type == device.type
               for v in batch.values())


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


def make_train_step(bundle, optimizer, deterministic: bool = False,
                    static_grads: bool = False):
    """step(batch, tables, generators, tr_sum_max_flag=True) -> loss: one
    forward (dropout on unless deterministic) + loss + backward +
    optimizer step of ``bundle.model`` on a host batch (checked, then
    moved to the model's device) or on one that
    data/pipeline.prefetch_to_device staged there. `tables`: the feature
    tables as tensors on that device (None for dense batches);
    `generators`: (dropout, loss) from ``step_generators``.
    static_grads=True zeroes the gradients in place instead of dropping
    them, so that they stay the same buffers (a CUDA graph's step).
    parallel/step.make_dp_train_step is its data-parallel form."""
    device = next(bundle.model.parameters()).device

    def step(batch, tables, generators, tr_sum_max_flag=True):
        if not staged(batch, device):
            check_batch(batch, tables)
            batch = _to_device(batch, device)
        optimizer.zero_grad(set_to_none=not static_grads)
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
    assembly_workers: int = 0,
    epoch_sweep: Optional[bool] = None,
    sweep_max_steps: int = 512,
) -> Dict:
    """Run the epoch loop on ``bundle.model``'s device; returns {'model',
    'optimizer', 'saver', 'losses' (mean per epoch), 'final_path',
    'epoch_sweep_used', 'localized_tables'}.

    `tables` default to the dataset's (``train_dataset.tables``); they are
    moved to the device once. `optimizer` defaults to ``make_optimizer``
    over the model's parameters (pass one to resume, with its state from a
    train checkpoint or checkpoint.opt_state_from_jax). `eval_localize` is
    the cadence sweep's ``localize_ctx``. `mesh`: a parallel/mesh.Mesh2D
    or a (data, model) shape over this process group (a model axis above
    1 shards ``bundle.model`` and `optimizer` in place). `checkpoint_backend`:
    'torch' (.pth.tar), 'msgpack' (the JAX package's .ckpt files) or
    'orbax' (its Orbax .ckpt directories).
    `assembly_workers`: the epoch iterator's worker processes (0: in this
    process); `dense`: train on dense batches, without tables.
    `epoch_sweep`: the epoch sweep (None: unless `dense`; False: one step
    per batch, --per-batch-train), in chunks of at most `sweep_max_steps`
    steps."""
    o, t = cfg.optim, cfg.tasks
    if mesh is not None:
        if host_eval:
            raise ValueError(MESH_HOST_EVAL)
        if not isinstance(mesh, Mesh2D) and mesh[1] > 1:
            check_model_axis(bundle.spec, mesh[1])
        mesh = dist.make_mesh(mesh)
    lead = mesh is None or mesh.lead  # the process that writes
    verbose = verbose and lead
    suffix = BACKENDS[checkpoint_backend]
    model = bundle.model
    device = next(model.parameters()).device
    if optimizer is None:
        optimizer = make_optimizer(model.parameters(), o.lr, o.weight_decay)
    # the model the eval and the checkpoints read: the trained one, or
    # under a model axis a full replica of it (made before the cut)
    full_model, full_optimizer = model, optimizer
    if mesh is not None and mesh.model > 1:
        full_model = copy.deepcopy(model)
        full_optimizer = make_optimizer(full_model.parameters(), o.lr,
                                        o.weight_decay)
        shard_model(model, mesh, bundle.spec, optimizer)
    if tables is None and not dense:
        tables = train_dataset.tables.as_dict()
    if tables is not None:
        tables = {k: torch.as_tensor(tables[k], dtype=torch.float32,
                                     device=device)
                  for k in ("text", "visual", "track")}
    localizer = None
    if localize_tables is not False and tables is not None and not dense:
        localizer = Localizer(bundle.spec,
                              n_clips=tables["text"].shape[0],
                              n_tracks=tables["track"].shape[0],
                              force=localize_tables)
    if epoch_sweep is None:
        epoch_sweep = not dense
    use_sweep = bool(epoch_sweep) and not dense
    if use_sweep:
        sweep = EpochSweep(bundle, optimizer, tables, o.seed, o.batch_size,
                           mesh=mesh, sweep_max_steps=sweep_max_steps)
    elif mesh is None:
        step = make_train_step(bundle, optimizer)
    else:
        from lirec_tpu_torch.parallel.step import make_dp_train_step

        step = make_dp_train_step(bundle, optimizer, mesh, o.batch_size)
    iterator = EpochIterator(train_dataset, o.batch_size, seed=o.seed,
                             drop_last=drop_last, dense=dense,
                             workers=assembly_workers)
    tr_sum_max_flag = t.tr_sum_max_flag
    metrics_log = MetricsLogger(metrics_log_path if lead else None)
    store = cfg.paths.store_root
    saver = BestNSaver(path=store, n=o.keep_best_n,
                       backend=checkpoint_backend)
    eval_data: Dict[int, Dict] = {}

    def gathered(with_optimizer=False):
        """The full model (and optimizer): under a model axis the replica,
        filled in place from every process's slices (all of them call
        this)."""
        if full_model is not model:
            state, opt_state = gather_state(
                model, mesh, optimizer if with_optimizer else None)
            full_model.load_state_dict(state)
            if opt_state is not None:
                load_state(full_optimizer, opt_state)
        return full_model, full_optimizer

    def cadence_eval(ds, mode, tables=None):
        # datasets without the packed interface, and dense runs, keep the
        # host loop
        if host_eval or dense or not hasattr(ds, "materialize"):
            return evaluate(ds, bundle, full_model, cfg, mode=mode,
                            tables=tables, verbose=verbose, mesh=mesh,
                            dense=dense)
        # each split materialized once for the whole run (the train split's
        # eval-time context draws are frozen with it)
        data = eval_data.get(id(ds))
        if data is None:
            data = eval_data[id(ds)] = ds.materialize()
        return evaluate_packed(ds, bundle, full_model, cfg, mode=mode,
                               tables=tables, verbose=verbose, data=data,
                               localize_ctx=eval_localize, mesh=mesh)

    def train_state():
        full, full_opt = gathered(with_optimizer=True)
        return {"state_dict": full.state_dict(),
                "optimizer": file_state(full_opt)}

    def write(fn, *args):
        """fn(*args) on process 0 only, the others waiting at barriers
        before and after (the JAX package's process-0 writes)."""
        dist.barrier("before a checkpoint")
        if lead:
            fn(*args)
        dist.barrier("after a checkpoint")

    def host_batches(batches, sizes):
        """Each batch padded, checked and (under a mesh) cut to this
        rank's rows, its unpadded size appended to `sizes`."""
        for batch in batches:
            n = batch["labels"].shape[0]
            if n != o.batch_size:
                batch = _pad_batch(batch, o.batch_size)
            check_batch(batch, tables)
            if mesh is not None:
                batch = local_batch(batch, mesh)
            sizes.append(n)
            yield batch

    def collect():
        batches = _collect_batches(iterator)
        return localizer.maybe_localize(batches) if localizer else batches

    def sweep_epoch(epoch, batches, loss_meter):
        """The epoch's losses: its sweep dispatched, the next epoch's
        batches assembled while the card runs it (returned), then the
        losses read."""
        for batch in batches:
            check_batch(batch, tables)
        dispatched = sweep.run(batches, epoch, tr_sum_max_flag)
        pending = collect() if epoch + 1 < o.epochs else None
        epoch_losses = sweep.fetch(dispatched)
        for loss, batch in zip(epoch_losses, batches):
            loss_meter.update(loss, len(batch["labels"]))
        return epoch_losses, pending

    def batch_epoch(epoch, batches, batch_time, data_time, loss_meter, end):
        """The epoch's losses, one step per batch, each read after its
        step."""
        sizes = collections.deque()
        epoch_losses = []
        for i, batch in enumerate(prefetch_to_device(
                host_batches(batches, sizes), device)):
            data_time.update(time.time() - end)
            n = sizes.popleft()
            loss = step(batch, tables, step_generators(
                o.seed, epoch * SEED_STRIDE + i, device),
                tr_sum_max_flag=tr_sum_max_flag)
            loss = float(loss)
            epoch_losses.append(loss)
            loss_meter.update(loss, n)
            batch_time.update(time.time() - end)
            end = time.time()
            if verbose and i and i % 10 == 0:
                print("Epoch: [%d][%d/%d]\tTime %.3f (%.3f)\tData %.3f "
                      "(%.3f)\tLoss %.4f (%.4f)"
                      % (epoch, i, len(iterator), batch_time.val,
                         batch_time.avg, data_time.val, data_time.avg,
                         loss_meter.val, loss_meter.avg))
        return epoch_losses

    losses = []
    pending = None  # the next epoch's batches, assembled during a sweep
    try:
        for epoch in range(start_epoch, o.epochs):
            if t.tr_sum_max and epoch >= 20:
                tr_sum_max_flag = True  # curriculum flip (ref :49-51)
            batch_time, data_time, loss_meter = (Averaging(), Averaging(),
                                                 Averaging())
            start = end = time.time()
            if use_sweep:
                batches = pending if pending is not None else collect()
                data_time.update(time.time() - end)
                epoch_losses, pending = sweep_epoch(epoch, batches,
                                                    loss_meter)
                if batches:
                    batch_time.update((time.time() - end) / len(batches))
            else:
                if localizer is not None:
                    # the Localizer sizes its tables over the whole epoch
                    batches = collect()
                else:
                    # streamed: a dense epoch does not fit in host memory
                    batches = (b for b in iterator
                               if (b["labels"].shape[0] if b["labels"].ndim
                                   else 1) > 1)
                dispatch.record("train_loop", "per_batch",
                                "dense batches" if dense
                                else "epoch_sweep off", {})
                epoch_losses = batch_epoch(epoch, batches, batch_time,
                                           data_time, loss_meter, end)
            losses.append(float(np.mean(epoch_losses)) if epoch_losses
                          else 0.0)
            if verbose:
                print("epoch %d loss: %f (%.2fs)"
                      % (epoch, losses[-1], time.time() - start))
            metrics_log.log({"epoch": epoch, "loss": losses[-1],
                             "batch_time_avg": batch_time.avg,
                             "data_time_avg": data_time.avg})

            if epoch % o.test_fr == 0 and val_dataset is not None:
                # each dataset evaluates with its own tables; only the
                # train split reuses the training ones (ref :75-91)
                gathered()
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
            if (checkpoint_every and store
                    and (epoch + 1) % checkpoint_every == 0):
                # a resumable state (the reference has no failure
                # recovery, SURVEY.md 5.3); --auto-resume picks it up
                write(save_train_state_any,
                      ops.join(store, "latest" + suffix),
                      *gathered(with_optimizer=True), epoch,
                      checkpoint_backend)
    finally:
        iterator.close()  # stop the assembly workers

    final_path = ""
    full, full_opt = gathered(with_optimizer=True)
    if o.save_model and store:
        final_path = ops.join(store, "%d%s" % (o.epochs - 1, suffix))

        def final():
            save_train_state_any(final_path, full, full_opt, o.epochs - 1,
                                 checkpoint_backend)
            saver.save()

        write(final)
    return {
        "model": full,
        "optimizer": full_opt,
        "saver": saver,
        "losses": losses,
        "final_path": final_path,
        "epoch_sweep_used": use_sweep,
        "localized_tables": bool(localizer and localizer.applied),
    }
