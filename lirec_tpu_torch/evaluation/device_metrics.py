"""Device-side metric reductions (counterpart of
lirec_tpu/evaluation/device_metrics.py).

The grounding metrics need only a handful of per-sample argmaxes of the
(sigmoided, masked) logits; the eval sweep computes them on the device and
folds them into its counters (evaluation/packed.py), with the counting
semantics of ``MetricAccumulator.update_probs_max_tracks[_rels]``.
``torch.argmax`` returns the first maximal index, as ``jnp.argmax`` does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from lirec_tpu_torch.ops.select import select_along_axis

__all__ = ["grounding_predictions"]


def grounding_predictions(
    pr_probs_cl: torch.Tensor,
    mask: torch.Tensor,
    gt_classes: torch.Tensor,
    pr_probs_rels: Optional[torch.Tensor] = None,
    gt_rels: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Per-sample predictions for the grounding metrics.

    pr_probs_cl: [B, T, C] logits; mask: [B, T]; gt_classes: [B];
    pr_probs_rels: [B, T, R] logits or None; gt_rels: [B, T] or None.
    Returns small per-sample vectors (argmaxes over masked sigmoids).
    """
    B, T, _ = pr_probs_cl.shape
    valid = mask[:, :, None] > 0
    # made on the card (a host tensor's copy is refused inside a capture)
    neg_inf = torch.full((), float("-inf"), device=pr_probs_cl.device)
    s_cl = torch.sigmoid(torch.where(valid, pr_probs_cl.float(), neg_inf))
    gt_col = gt_classes.reshape(-1, 1).long()

    out: Dict[str, torch.Tensor] = {}
    # class argmax per hypothesis row (for the GT-slot lookups)
    out["cls_argmax"] = s_cl.argmax(dim=2)  # [B, T]

    if pr_probs_rels is None:
        out["pr_track"] = select_along_axis(s_cl, gt_col, axis=2).argmax(dim=1)
        out["t_star"] = s_cl.max(dim=2).values.argmax(dim=1)
        out["c_star"] = select_along_axis(
            s_cl, out["t_star"][:, None], axis=1).argmax(dim=1)
        return out

    rl = torch.where(valid, pr_probs_rels.float(), neg_inf)
    s_rl = torch.sigmoid(rl)
    # 'None' column appended after the sigmoid (score 0, ref evaluation.py:220)
    s_rlp = torch.cat([s_rl, s_rl.new_zeros(B, T, 1)], dim=2)
    out["rels_argmax"] = rl.argmax(dim=2)  # [B, T] over R (no pad)

    rel0 = gt_rels[:, 0].long()
    col = (select_along_axis(s_cl, gt_col, axis=2)
           + select_along_axis(s_rlp, rel0[:, None], axis=2))
    out["pr_track"] = col.argmax(dim=1)
    # separable joint argmax (see evaluation/metrics.py)
    max_c = s_cl.max(dim=2).values
    max_r = s_rlp.max(dim=2).values
    out["t_star"] = (max_c + max_r).argmax(dim=1)
    t_row = out["t_star"][:, None]
    out["c_star"] = select_along_axis(s_cl, t_row, axis=1).argmax(dim=1)
    out["r_star"] = select_along_axis(s_rlp, t_row, axis=1).argmax(dim=1)
    return out
