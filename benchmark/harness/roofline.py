"""The yardstick's rates and the bytes that kernels' inputs need.

``bound``, ``nbytes`` and ``gathered_bytes`` are frozen copies of
``chip_smoke.py``'s arithmetic: the least time the card could take is the
larger of the bytes over the memory rate and the float32 operations over
the float32 rate, counting each referenced input row read once and each
output written once, whatever a kernel reads again. The counts here work
from host arrays (the batches' indices), so they cost no device time and
count the same whatever implements the work.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["PEAKS", "peak", "device_peak", "bound_s", "gathered_bytes",
           "pool_need", "scatter_need"]

# NVIDIA's data sheet, H100 SXM, dense rates, at its 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "f32_flops": 67e12,
                              "hbm_bytes": 3.35e12},
}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def peak(device_kind: str) -> Optional[Dict[str, float]]:
    """The card's published peaks, or None for a card not in the table."""
    return PEAKS.get(device_kind)


def device_peak(device: str) -> Optional[Dict[str, float]]:
    """The peaks of the card a run is on (None off a card)."""
    if not device.startswith("cuda"):
        return None
    import torch

    return peak(torch.cuda.get_device_name(0))


def bound_s(n_bytes: float, flops: float, rates: Dict[str, float]) -> float:
    """Seconds the card needs at least: bytes over the memory rate or
    float32 operations over the float32 rate, whichever is larger."""
    return max(n_bytes / rates["hbm_bytes"], flops / rates["f32_flops"])


def gathered_bytes(ids: np.ndarray, width: int, element_bytes: int) -> int:
    """Bytes of the table rows `ids` reference, each read once."""
    return int(np.unique(ids).size) * width * element_bytes


def pool_need(feat_idx: np.ndarray, widths, table_dtype: str):
    """(bytes, float32 operations) of the context pool of one batch:
    feat_idx [B, T, 1 + R, 3] (the context at slots 1..R), `widths` the
    embedded clip, track1 and track2 rows. Each referenced row of the
    three tables read once, the indices (int32) and the mask (float32)
    read, the pooled rows (float32) written; a multiply-add per gathered
    element."""
    ctx = feat_idx[:, :, 1:, :]
    M = ctx.shape[0] * ctx.shape[1]
    R = ctx.shape[2]
    el = ELEMENT_BYTES[table_dtype]
    moved = sum(gathered_bytes(ctx[..., k], w, el)
                for k, w in enumerate(widths))
    moved += M * R * 3 * 4 + M * R * 4 + M * sum(widths) * 4
    return moved, 2 * M * R * sum(widths)


def scatter_need(n_updates: int, rows, widths, dtype: str):
    """(bytes, float32 operations) of the training step's scatter of the
    context gather's gradients into its three tables: the ids in (int32,
    three a context entry), the sort's permutation (int32, one per update
    and table) and row offsets (int32, rows + 1 a table) out, each update
    row read once, each table row written once; an add per update
    element."""
    el = ELEMENT_BYTES[dtype]
    moved = n_updates * 3 * 4 + n_updates * 3 * 4
    moved += sum((r + 1) * 4 for r in rows)
    moved += sum(n_updates * w * el for w in widths)
    moved += sum(r * w * el for r, w in zip(rows, widths))
    return moved, n_updates * sum(widths)
