"""Batch collation and iteration (counterparts of ``collate`` and
``BatchIterator`` of lirec_tpu/data/pipeline.py).

``BatchIterator`` yields bitwise the batches of the JAX package's
``BatchIterator`` with no workers: eval-mode splits are sliced from the
materialized split, other datasets go through the assembly plan (built in
memory with ``data/plan.build_plan``; the JAX package's disk cache is not
ported) or, where there is none, per sample from ``default_rng((seed,
epoch, i))`` streams. ``EpochIterator`` is its shuffled train form. The
``AssemblyPool`` worker processes and the dense layout are not ported.
``local_batch`` cuts a data-parallel rank's rows out of a global batch
(counterpart of ``global_batch_from_local`` of lirec_tpu/parallel/mesh.py,
seen from the rank's side).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List

import numpy as np

__all__ = ["collate", "BatchIterator", "EpochIterator", "local_batch"]

# batch-level keys: the localized tables' unique-row ids, no sample axis
BATCH_LEVEL_KEYS = ("uniq_clip", "uniq_track")


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
    lirec_tpu/data/pipeline.BatchIterator without the worker pool and the
    dense layout).

    Eval modes (``shuffle=False`` on a dataset whose mode is not
    ``"train"``) slice the materialized split; otherwise batches come from
    the assembly plan or, where there is none, per sample, every sample
    drawing from its own ``default_rng((seed, epoch, i))`` stream. The
    order is shuffled with ``default_rng((seed, epoch))`` when asked.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self._plan = None  # (label chooser it was built for, plan or None)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def plan(self):
        """The dataset's assembly plan, built once per label chooser; None
        where BatchIterator would assemble per sample."""
        from lirec_tpu_torch.data.plan import build_plan

        ds = self.dataset
        if (os.environ.get("LIREC_TPU_NO_PLAN")
                or getattr(ds, "test_rels_multi_clip", False)
                or not hasattr(ds, "assembly_plan")):
            return None
        chooser = getattr(ds, "label_chooser", None)
        if self._plan is None or self._plan[0] is not chooser:
            self._plan = (chooser, build_plan(ds))
        return self._plan[1]

    def _materialized(self, order):
        """The materialized split of an eval-mode dataset, else None."""
        ds = self.dataset
        if (len(order) and not self.shuffle
                and getattr(ds, "mode", "train") != "train"
                and hasattr(ds, "materialize")
                and not getattr(ds, "test_rels_multi_clip", False)):
            return ds.materialize()
        return None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        if self.drop_last:
            order = order[: (len(order) // self.batch_size) * self.batch_size]
        materialized = self._materialized(order)
        plan = self.plan() if len(order) and materialized is None else None
        if materialized is not None:
            for start in range(0, len(order), self.batch_size):
                chunk = order[start: start + self.batch_size]
                yield {k: v[chunk] for k, v in materialized.items()}
        elif plan is not None:
            epoch_data = plan.assemble(order, self.seed, self.epoch)
            for start in range(0, len(order), self.batch_size):
                yield {k: v[start: start + self.batch_size]
                       for k, v in epoch_data.items()}
        else:
            for start in range(0, len(order), self.batch_size):
                yield collate([
                    self.dataset.__getitem__(
                        int(i),
                        np.random.default_rng((self.seed, self.epoch, int(i))))
                    for i in order[start: start + self.batch_size]
                ])
        self.epoch += 1


class EpochIterator(BatchIterator):
    """Shuffled train batches, one epoch per ``iter()``: bitwise the
    batches of ``BatchIterator(dataset, batch_size, shuffle=True,
    seed=seed)`` of the JAX package."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 drop_last: bool = False):
        super().__init__(dataset, batch_size, shuffle=True,
                         drop_last=drop_last, seed=seed)


def local_batch(batch: Dict, mesh) -> Dict:
    """This rank's rows of a global host batch over the data axis `mesh`
    (parallel/dist.DataMesh): its contiguous block of every per-sample
    array (parallel/dist.process_local_slice); the batch-level ``uniq_*``
    ids stay whole, as the JAX package replicates them."""
    from lirec_tpu_torch.parallel.dist import process_local_slice

    rows = process_local_slice(mesh, len(batch["labels"]))
    return {k: v if k in BATCH_LEVEL_KEYS else v[rows]
            for k, v in batch.items()}
