"""Batch collation, iteration, assembly workers and device prefetch
(counterparts of ``collate``, ``BatchIterator``, ``AssemblyPool`` and
``prefetch_to_device`` of lirec_tpu/data/pipeline.py).

``BatchIterator`` yields bitwise the batches of the JAX package's
``BatchIterator`` at any worker count: eval-mode splits are sliced from the
materialized split, other datasets go through the assembly plan
(``dataset.assembly_plan()``, disk-cached by data/plan_cache.py), else
through an ``AssemblyPool`` of worker processes, else per sample; every
per-sample path draws from ``default_rng((seed, epoch, i))`` streams, so
the pool, its in-process fallback and ``workers=0`` give the same batches.
``dense=True`` gathers each sample into the reference layout
(``dataset.to_dense``). Each epoch records the path it took under
``dispatch`` name ``ASSEMBLY``. ``EpochIterator`` is the shuffled train
form. ``prefetch_to_device`` stages host batches on the card ahead of the
step that takes them. ``local_batch`` cuts a data-parallel rank's rows out
of a global batch (counterpart of ``global_batch_from_local`` of
lirec_tpu/parallel/mesh.py, seen from the rank's side).
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Iterator, List

import numpy as np

__all__ = ["collate", "BatchIterator", "EpochIterator", "AssemblyPool",
           "prefetch_to_device", "local_batch", "ASSEMBLY"]

# batch-level keys: the localized tables' unique-row ids, no sample axis
BATCH_LEVEL_KEYS = ("uniq_clip", "uniq_track")
# the dispatch name of BatchIterator's per-epoch path: "materialized",
# "plan", "pool", "fallback" (the pool's in-process stand-in) or
# "per-sample"
ASSEMBLY = "batch_assembly"

_POOL_DATASET = None


def _pool_init(dataset):
    global _POOL_DATASET
    _POOL_DATASET = dataset


def _pool_probe(_):
    return _POOL_DATASET is not None


def _probe_target():
    return None


def _pool_assemble_batch(args):
    return _assemble_batch_with(_POOL_DATASET, args)


def _assemble_batch_with(dataset, args):
    """One collated batch from per-sample PRNG streams ((seed, epoch, i)):
    independent of execution order and of the process that runs it."""
    idxs, seed, epoch = args
    return collate([
        dataset.__getitem__(int(i), np.random.default_rng((seed, epoch,
                                                           int(i))))
        for i in idxs
    ])


class AssemblyPool:
    """Worker processes for per-sample batch assembly (the reference ran
    its DataLoader with ``num_workers=4``, ref mlp/train.py:33-37).

    The 'spawn' context (fork is unsafe beside a live CUDA context). The
    workers only run numpy: the card is hidden from them
    (``CUDA_VISIBLE_DEVICES`` empty while they start, then restored), and
    the dataset they unpickle imports nothing of jax. A bare ``Process``
    probes the bootstrap first: with a launching script that cannot be
    re-imported, a child dies at once with no respawn machinery, where a
    ``Pool`` would respawn it forever."""

    def __init__(self, dataset, workers: int, probe_timeout: float = 120.0):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        self._pool = None
        try:
            probe = ctx.Process(target=_probe_target, daemon=True)
            probe.start()
            probe.join(probe_timeout)
            if probe.is_alive():
                probe.kill()
                probe.join(5)
                raise RuntimeError("spawn probe timed out")
            if probe.exitcode != 0:
                raise RuntimeError(
                    "worker bootstrap failed (exit %s): is the launching "
                    "script importable and main-guarded?" % probe.exitcode)
            self._pool = ctx.Pool(workers, initializer=_pool_init,
                                  initargs=(dataset,))
            self._pool.map_async(_pool_probe, [0]).get(timeout=probe_timeout)
        except BaseException:
            if self._pool is not None:
                self._pool.terminate()
            raise
        finally:
            if saved is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved

    def assemble_batches(self, tasks, timeout: float = 600.0):
        """tasks: [(idx_list, seed, epoch)] -> the collated batches, in
        order, as the workers finish them. Each result waits at most
        `timeout` seconds: a worker killed mid-task loses its result, and
        a plain imap would wait forever."""
        it = self._pool.imap(_pool_assemble_batch, tasks)
        for _ in range(len(tasks)):
            yield it.next(timeout)

    def close(self) -> None:
        self._pool.terminate()
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _host_tensor(v):
    import torch

    return torch.as_tensor(np.asarray(v))


def prefetch_to_device(iterator, device, size: int = 2):
    """Yield the host batches (dicts of arrays) of `iterator` as tensors on
    `device`, staged `size` batches ahead of the one yielded. On a card
    each array is copied into pinned memory and then to the card with a
    non-blocking copy on a side stream; the consuming stream waits on the
    copy's event, and ``record_stream`` keeps the caching allocator from
    handing the buffers to the copy stream again before that stream's
    work on them is done. On the CPU the arrays only become tensors."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: _host_tensor(v) for k, v in batch.items()}
        return
    copy_stream = torch.cuda.Stream(device)

    def stage(batch):
        with torch.cuda.stream(copy_stream):
            staged = {k: _host_tensor(v).pin_memory().to(device,
                                                         non_blocking=True)
                      for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(copy_stream)
        return staged, event

    queue = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue.append(stage(batch))
        if len(queue) >= size:
            break
    while queue:
        staged, event = queue.popleft()
        compute = torch.cuda.current_stream(device)
        compute.wait_event(event)
        for t in staged.values():
            t.record_stream(compute)
        batch = next(it, None)
        if batch is not None:
            queue.append(stage(batch))
        yield staged


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into batch arrays (default-collate style)."""
    out: Dict[str, np.ndarray] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = np.asarray(vals[0])
        if first.dtype == bool:
            out[key] = np.asarray(vals, dtype=bool)
        elif first.dtype.kind in "iu":
            out[key] = np.stack([np.asarray(v) for v in vals]).astype(np.int32)
        else:
            out[key] = np.stack([np.asarray(v) for v in vals]).astype(np.float32)
    return out


class BatchIterator:
    """Batches of a dataset, one epoch per ``iter()`` (counterpart of
    lirec_tpu/data/pipeline.BatchIterator, with its precedence).

    Eval modes (``shuffle=False``, not dense, on a dataset whose mode is
    not ``"train"``) slice the materialized split; otherwise batches come
    from the assembly plan (``fast_assembly``, unless ``LIREC_TPU_NO_PLAN``
    is set or the dataset is in ``test_rels_multi_clip`` mode), else from
    an ``AssemblyPool`` of `workers` processes, else per sample, with
    ``to_dense`` per sample when `dense`. A pool that cannot start falls
    back to in-process assembly with a warning and the same batches, as in
    the JAX package, except inside a data-parallel rank, where it raises.
    The order is shuffled with ``default_rng((seed, epoch))`` when asked.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, dense: bool = False,
                 workers: int = 0, fast_assembly: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.dense = dense
        self.workers = workers
        self.fast_assembly = fast_assembly and not os.environ.get(
            "LIREC_TPU_NO_PLAN")
        self._pool = None  # None: not started; False: fell back
        self._fallback = "pool marked unavailable"  # why it fell back
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def plan(self):
        """The dataset's assembly plan; None where BatchIterator does not
        assemble through one."""
        ds = self.dataset
        if (self.dense or not self.fast_assembly
                or os.environ.get("LIREC_TPU_NO_PLAN")
                or getattr(ds, "test_rels_multi_clip", False)
                or not hasattr(ds, "assembly_plan")):
            return None
        return ds.assembly_plan()

    def _materialized(self, order):
        """The materialized split of an eval-mode dataset, else None."""
        ds = self.dataset
        if (len(order) and not self.shuffle and not self.dense
                and getattr(ds, "mode", "train") != "train"
                and hasattr(ds, "materialize")
                and not getattr(ds, "test_rels_multi_clip", False)):
            return ds.materialize()
        return None

    def _record(self, path: str, reason: str) -> None:
        from lirec_tpu_torch.ops import dispatch

        dispatch.record(ASSEMBLY, path, reason,
                        {"samples": len(self.dataset),
                         "batch_size": self.batch_size,
                         "workers": self.workers})

    def _pooled(self, order):
        """The epoch's batches from the worker pool, started at first use;
        in-process with the same per-sample streams where it cannot
        start."""
        tasks = [([int(i) for i in order[s: s + self.batch_size]],
                  self.seed, self.epoch)
                 for s in range(0, len(order), self.batch_size)]
        if self._pool is None:
            try:
                self._pool = AssemblyPool(self.dataset, self.workers)
            except Exception as err:
                from lirec_tpu_torch.parallel.dist import in_rank

                if in_rank():
                    raise RuntimeError(
                        "assembly worker pool unavailable in a "
                        "data-parallel rank (%s: %s)"
                        % (type(err).__name__, err)) from err
                import warnings

                warnings.warn(
                    "assembly worker pool unavailable (%s: %s); assembling "
                    "in-process: identical batches, no parallel speedup"
                    % (type(err).__name__, err))
                self._pool = False
                self._fallback = "%s: %s" % (type(err).__name__, err)
        if self._pool:
            self._record("pool", "%d workers" % self.workers)
            return self._pool.assemble_batches(tasks)
        self._record("fallback", self._fallback)
        return (_assemble_batch_with(self.dataset, t) for t in tasks)

    def close(self) -> None:
        """Stop the worker pool, if one runs."""
        if self._pool:
            self._pool.close()
        self._pool = None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        if self.drop_last:
            order = order[: (len(order) // self.batch_size) * self.batch_size]
        materialized = self._materialized(order)
        plan = self.plan() if len(order) and materialized is None else None
        if materialized is not None:
            self._record("materialized", "eval-mode split")
            for start in range(0, len(order), self.batch_size):
                chunk = order[start: start + self.batch_size]
                yield {k: v[chunk] for k, v in materialized.items()}
        elif plan is not None:
            self._record("plan", "assembly plan")
            epoch_data = plan.assemble(order, self.seed, self.epoch)
            for start in range(0, len(order), self.batch_size):
                yield {k: v[start: start + self.batch_size]
                       for k, v in epoch_data.items()}
        elif self.workers and not self.dense:
            yield from self._pooled(order)
        else:
            self._record("per-sample", "dense" if self.dense
                         else "in-process")
            for start in range(0, len(order), self.batch_size):
                samples = [
                    self.dataset.__getitem__(
                        int(i),
                        np.random.default_rng((self.seed, self.epoch, int(i))))
                    for i in order[start: start + self.batch_size]
                ]
                if self.dense:
                    samples = [self.dataset.to_dense(s) for s in samples]
                yield collate(samples)
        self.epoch += 1


class EpochIterator(BatchIterator):
    """Shuffled train batches, one epoch per ``iter()``: bitwise the
    batches of ``BatchIterator(dataset, batch_size, shuffle=True,
    seed=seed, ...)`` of the JAX package."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 drop_last: bool = False, dense: bool = False,
                 workers: int = 0):
        super().__init__(dataset, batch_size, shuffle=True,
                         drop_last=drop_last, seed=seed, dense=dense,
                         workers=workers)


def local_batch(batch: Dict, mesh) -> Dict:
    """This rank's rows of a global host batch over the data axis of
    `mesh` (parallel/mesh.Mesh2D, by its data index): its contiguous block
    of every per-sample array (parallel/mesh.process_local_slice); the
    batch-level ``uniq_*`` ids stay whole, as the JAX package replicates
    them."""
    from lirec_tpu_torch.parallel.dist import process_local_slice

    rows = process_local_slice(mesh, len(batch["labels"]))
    return {k: v if k in BATCH_LEVEL_KEYS else v[rows]
            for k, v in batch.items()}
