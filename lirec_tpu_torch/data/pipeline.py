"""Batch collation and the train-mode epoch iterator (counterparts of
``collate`` and of the train path of lirec_tpu/data/pipeline.BatchIterator).

``EpochIterator`` builds the assembly plan in memory with
``data/plan.build_plan`` (the JAX package's disk cache is not ported) and
yields bitwise the batches of ``BatchIterator(dataset, batch_size,
shuffle=True, seed=seed)``: the order is shuffled with
``default_rng((seed, epoch))``, and where there is no plan every sample is
assembled from its own ``default_rng((seed, epoch, i))`` stream, as
``BatchIterator`` does with no workers.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List

import numpy as np

__all__ = ["collate", "EpochIterator"]


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


class EpochIterator:
    """Shuffled train batches, one epoch per ``iter()``."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
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

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        if self.drop_last:
            order = order[: (len(order) // self.batch_size) * self.batch_size]
        plan = self.plan() if len(order) else None
        if plan is not None:
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
