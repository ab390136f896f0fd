"""The bytes and operations that the int_rels sweep's fold of its per-hash
score table needs, from a batch's host arrays (no device time), for the
fold's roofline (harness/roofline.bound_s: the larger of the bytes over
the memory rate and the float32 operations over the float32 rate).

Per batch: the batch's B hash ids read (int32) and its B update rows read
(float32, one per sample: its sigmoid scores, or zeros for a sample the
table does not count), and each distinct table row that the batch touches
read once and written once (float32; the rows of samples the table does
not count go to its dump row, one more row); an add per update element.
That is the same work whatever implements the fold: a fold that reads and
writes the whole table every batch does more than it needs, and that
excess is not counted as needed.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fold_need"]


def fold_need(hashes: np.ndarray, labels: np.ndarray, n_hashes: int,
              n_rels: int, width: int):
    """(bytes, float32 operations) of one batch's fold: hashes [B] (-1:
    none), labels [B] (n_rels: 'None'), a table of n_hashes + 1 rows of
    `width` float32."""
    hashes = np.asarray(hashes).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    rows = np.where((labels != n_rels) & (hashes >= 0), hashes, n_hashes)
    B = rows.size
    moved = B * 4 + B * width * 4 + 2 * np.unique(rows).size * width * 4
    return int(moved), B * width
