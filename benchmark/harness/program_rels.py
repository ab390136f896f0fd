"""What the int_rels sweep needs of the program beyond harness/program.py:
a stand-in dataset that carries the split's relationship hashes (the sweep
folds its per-hash score table only where the dataset has them), and a
record of the sweep's host finish (the carry it fetched, and the
RelationshipsAcc it filled), which the comparison reads."""

from __future__ import annotations

import contextlib
import types
from typing import Dict

__all__ = ["stand_in", "recording_finish"]


def stand_in(cfg: Dict, n_hashes: int):
    """What the int_rels eval sweep reads of a dataset: the interaction
    classes, the relationship labels ('None' counted) and the split's
    ``n_hashes`` (pair, relationship) hashes."""
    return types.SimpleNamespace(n_classes=cfg["n_classes"],
                                 n_rels=cfg["n_rels"] + 1,
                                 hashidx_rels=range(n_hashes))


@contextlib.contextmanager
def recording_finish(store: Dict):
    """Inside the block, each call of the program's
    ``evaluation/packed.finish_from_carry`` (once a sweep) leaves the host
    carry it was given in ``store["carry"]`` and the RelationshipsAcc it
    filled in ``store["rels_acc"]``, the latest call's only."""
    from lirec_tpu_torch.evaluation import packed

    inner_finish, inner_acc = packed.finish_from_carry, packed.RelationshipsAcc

    class RelationshipsAcc(inner_acc):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            store["rels_acc"] = self

    def finish_from_carry(carry, *args, **kw):
        store["carry"] = carry
        return inner_finish(carry, *args, **kw)

    packed.finish_from_carry = finish_from_carry
    packed.RelationshipsAcc = RelationshipsAcc
    try:
        yield store
    finally:
        packed.finish_from_carry = inner_finish
        packed.RelationshipsAcc = inner_acc
