"""Faults planted in the int_rels sweep's fold of its per-hash score table,
for the check that the comparison catches them (the benchmark's tests on
the CPU, ``calibrate.py`` on the card). The sweep folds each batch into
the table with ``ops/scatter_accum.scatter_accum1`` over the table's rows
(ids 0 .. n_rows - 1, the running table) followed by the batch's update
rows (their hash ids); each fault swaps that function for a broken one,
which the sweep builds its step with, and puts it back on exit:

- next_hash: the batch's first update is added to the next hash's row;
- table_zeroed: the table is zeroed every batch instead of carried (each
  batch's fold starts from zeros, so the table holds the last batch's);
- half_updates: the updates of the last half of every batch are dropped.

Each is a few device operations on the fold's inputs, so a CUDA graph
captures it with the step.
"""

from __future__ import annotations

import contextlib

__all__ = ["RELS", "planted"]


@contextlib.contextmanager
def _fold(change):
    """scatter_accum1 with its (ids, updates) replaced by change(ids,
    updates, n_rows)."""
    from lirec_tpu_torch.ops import scatter_accum

    real = scatter_accum.scatter_accum1

    def broken(idx, g, n_rows, *args, **kw):
        idx, g = change(idx, g, int(n_rows))
        return real(idx.contiguous(), g.contiguous(), n_rows, *args, **kw)

    scatter_accum.scatter_accum1 = broken
    try:
        yield
    finally:
        scatter_accum.scatter_accum1 = real


def next_hash():
    import torch

    def change(idx, g, n_rows):
        first = idx[n_rows:n_rows + 1]
        hashes = n_rows - 1  # the last row is the sweep's dump row
        moved = torch.where(first < hashes, (first + 1) % hashes, first)
        return torch.cat([idx[:n_rows], moved, idx[n_rows + 1:]]), g
    return _fold(change)


def table_zeroed():
    import torch

    def change(idx, g, n_rows):
        return idx, torch.cat([torch.zeros_like(g[:n_rows]), g[n_rows:]])
    return _fold(change)


def half_updates():
    import torch

    def change(idx, g, n_rows):
        keep = n_rows + (len(idx) - n_rows) // 2
        return idx, torch.cat([g[:keep], torch.zeros_like(g[keep:])])
    return _fold(change)


RELS = {"next_hash": next_hash, "table_zeroed": table_zeroed,
        "half_updates": half_updates}


def planted(name: str):
    """The fault `name` of the fold."""
    return RELS[name]()
