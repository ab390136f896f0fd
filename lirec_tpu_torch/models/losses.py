"""Multi-task losses (ref `mlp/model.py:357-575`; counterpart of
lirec_tpu/models/losses.py).

All losses take ``outputs`` (the model dict) and ``batch`` (tensors on the
outputs' device) and return a scalar f32 tensor. As in the JAX package:
masked logits become ``-inf`` through ``torch.where`` and columns are
picked with ``ops/select.select_along_axis`` (never a product with a
one-hot, since ``0 * -inf`` is NaN); dynamic boolean subsets become masked
sums with ``sum / max(count, 1)`` means; ``tr_cat_distr`` samples the
positive hypothesis with ``torch.multinomial`` from an explicit
``torch.Generator``.

An optional ``batch['loss_weight']`` ([B], 0/1) excludes padded rows from
every per-sample mean, so a batch padded to the full size gives the values
and gradients of the unpadded one.

Inside a data-parallel step (parallel/dist.sharded_batch) the batch is one
rank's block of rows of a global batch: every mean keeps its numerator
from the rank's rows and takes its denominator (row count, ``loss_weight``
sum, rels-valid count, class-weight sum) summed over the ranks, without
gradient (``batch_total``), and ``tr_cat_distr`` samples at the global
batch's shape. The ranks' losses then add up to the global batch's loss,
and their gradients to its gradient. Outside one, nothing changes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from lirec_tpu_torch.models.layers import draw_rows
from lirec_tpu_torch.ops.select import select_along_axis
from lirec_tpu_torch.parallel.dist import batch_shard, batch_total
from lirec_tpu_torch.utils.graphs import capturing

__all__ = [
    "max_margin_ce_loss",
    "multitask_max_margin_loss",
    "multitask_ce_loss",
    "margin_loss",
    "margin_track_rels_loss",
]

NEG_INF = float("-inf")


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot; an index outside [0, n) gives a zero row (as
    jax.nn.one_hot)."""
    return (idx[..., None].long()
            == torch.arange(n, device=idx.device)).float()


def _batch_weight(batch: Dict) -> Optional[torch.Tensor]:
    w = batch.get("loss_weight")
    return None if w is None else w.float().reshape(-1)


def _wmean(per_sample: torch.Tensor, w: Optional[torch.Tensor]):
    """Mean over real rows: padded rows (weight 0) drop out of both the sum
    and the divisor (the global batch's, in a data-parallel step)."""
    if w is None:
        shard = batch_shard()
        if shard is None:
            return per_sample.mean()
        return per_sample.sum() / (per_sample.shape[0] * shard.size)
    return (per_sample * w).sum() / batch_total(w.sum()).clamp(min=1.0)


def _pair_margin(scores, pos, neg_mask, margin: float) -> torch.Tensor:
    """sum_j relu(margin - pos + neg_j) over masked negatives, per sample."""
    n = scores.shape[0]
    flat_neg = (scores * neg_mask).reshape(n, -1)
    flat_mask = neg_mask.reshape(n, -1)
    terms = torch.relu((margin - pos)[:, None] + flat_neg) * flat_mask
    return terms.sum(dim=1)


def _exponential(shape, generator=None, device=None, dtype=None):
    return torch.empty(shape, dtype=dtype, device=device).exponential_(
        1, generator=generator)


def _sample(probs: torch.Tensor, rng: torch.Generator) -> torch.Tensor:
    """One category per row, with probability proportional to `probs`. In
    a data-parallel step, and inside a CUDA graph's capture (where
    torch.multinomial's check of `probs` reads the card from the host,
    which a capture refuses): torch.multinomial's own one-sample method,
    the argmax of probs / Exp(1) draws, the same draws from the same
    generator, made for the global batch in a data-parallel step
    (layers.draw_rows)."""
    if rng is None:
        raise ValueError("tr_cat_distr sampling needs a generator")
    if batch_shard() is None and not capturing():
        return torch.multinomial(probs, 1, generator=rng).squeeze(1)
    q = draw_rows(_exponential, probs.shape, rng, probs.device, probs.dtype)
    return (probs / q).argmax(dim=-1)


def max_margin_ce_loss(outputs: Dict, batch: Dict, *, margin: float):
    """MaxMarginCrossEntropyLoss (ref mlp/model.py:422-441)."""
    logits = outputs["inters"]
    if logits.dim() == 3:  # [B, 1, C] row from single-hypothesis layouts
        logits = logits.reshape(logits.shape[0], -1)
    target = batch["labels"].reshape(-1).long()
    n_classes = logits.shape[-1]
    neg_mask = (1.0 - _one_hot(target, n_classes)) * batch[
        "multilab_weights"].float()
    s = torch.sigmoid(logits.float())
    pos = select_along_axis(s, target, axis=1)
    return _wmean(_pair_margin(s, pos, neg_mask, margin),
                  _batch_weight(batch))


def multitask_max_margin_loss(outputs: Dict, batch: Dict, n_rels: int, *,
                              margin: float, lymbda: float, ints: bool = True,
                              ctx: bool = True):
    """MultiTaskMaxMargin (ref mlp/model.py:381-419)."""
    bw = _batch_weight(batch)
    loss = torch.zeros((), device=batch["labels"].device)
    if ints:
        inters = outputs["inters"]
        inters = inters.reshape(inters.shape[0], -1, inters.shape[-1])[:, 0]
        target = batch["labels"][:, 0].reshape(-1).long()
        neg_mask = (1.0 - _one_hot(target, inters.shape[-1])) * batch[
            "multilab_weights"].float()
        s = torch.sigmoid(inters.float())
        pos = select_along_axis(s, target, axis=1)
        loss = loss + lymbda * _wmean(_pair_margin(s, pos, neg_mask, margin),
                                      bw)
    if ctx:
        target_rels = batch["rels_label"].reshape(-1).long()
        valid = (target_rels != n_rels).float()
        if bw is not None:
            valid = valid * bw
        rels = outputs["rels"].float()
        safe_target = target_rels.clamp(0, rels.shape[-1] - 1)
        neg_mask = 1.0 - _one_hot(safe_target, rels.shape[-1])
        s = torch.sigmoid(rels)
        pos = select_along_axis(s, safe_target, axis=1)
        per_sample = _pair_margin(s, pos, neg_mask, margin)
        loss = loss + (per_sample * valid).sum() / batch_total(
            valid.sum()).clamp(min=1.0)
    return loss


def multitask_ce_loss(outputs: Dict, batch: Dict, n_rels: int, *,
                      weights: Optional[torch.Tensor] = None):
    """MultiTaskCrossEntropyLoss (ref mlp/model.py:357-378)."""
    logits = outputs["inters"].float()
    target = batch["labels"].reshape(-1).long()
    nll = -select_along_axis(torch.log_softmax(logits, dim=-1), target, 1)
    bw = _batch_weight(batch)
    if weights is not None:
        w = weights[target]
        if bw is not None:
            w = w * bw
        loss = (nll * w).sum() / batch_total(w.sum()).clamp(min=1e-12)
    else:
        loss = _wmean(nll, bw)
    target_rels = batch["rels_label"].reshape(-1).long()
    valid = (target_rels != n_rels).float()
    if bw is not None:
        valid = valid * bw
    rels = outputs["rels"].float()
    safe_target = target_rels.clamp(0, rels.shape[-1] - 1)
    nll_r = -select_along_axis(torch.log_softmax(rels, dim=-1), safe_target,
                               1)
    count = batch_total(valid.sum())
    rel_loss = (nll_r * valid).sum() / count.clamp(min=1.0)
    return loss + torch.where(count > 0, rel_loss, torch.zeros_like(rel_loss))


def margin_loss(outputs: Dict, batch: Dict, *, tr_margin: float,
                tr_correct: bool, tr_cat_distr: bool = False,
                tr_max_neg: bool = False, tr_sum_max_flag: bool = True,
                rng: Optional[torch.Generator] = None):
    """MarginLoss: weak/GT character grounding (ref mlp/model.py:444-494)."""
    x = outputs["inters"].float()  # [B, T, C]
    B, T, C = x.shape
    target = batch["labels"].reshape(-1).long()
    mem = batch["mem_mask"].float()  # [B, T]
    valid = mem[:, :, None] > 0
    x = torch.where(valid, x, NEG_INF)

    neg_mask = valid.float() * batch["multilab_weights"].float()[:, None, :]
    cls_oh = _one_hot(target, C)  # [B, C]
    if tr_correct:
        gt = batch["gt_tracks"].long()  # [B, 2]
        slot_oh = (_one_hot(gt[:, 0], T) + _one_hot(gt[:, 1], T)).clamp(
            max=1.0)
        neg_mask = neg_mask * (1.0 - slot_oh[:, :, None] * cls_oh[:, None, :])
    else:
        neg_mask = neg_mask * (1.0 - cls_oh[:, None, :])

    col = select_along_axis(x, target[:, None], axis=2)  # [B, T]
    s = torch.sigmoid(x)
    if tr_cat_distr:
        max_idxs = _sample(torch.softmax(col, dim=1), rng)
    elif tr_correct:
        max_idxs = torch.zeros(B, dtype=torch.long, device=x.device)
    else:
        max_idxs = torch.argmax(torch.sigmoid(col) * mem, dim=1)
    pos = select_along_axis(torch.sigmoid(col), max_idxs, axis=1)

    if tr_max_neg and tr_sum_max_flag:
        neg_max = (s * neg_mask).amax(dim=2)  # [B, T]
        loss = torch.relu((tr_margin - pos)[:, None] + neg_max).sum(dim=1)
    else:
        loss = _pair_margin(s, pos, neg_mask, tr_margin)
    return _wmean(loss, _batch_weight(batch))


def margin_track_rels_loss(outputs: Dict, batch: Dict, n_rels: int, *,
                           tr_margin: float, lymbda: float, tr_correct: bool,
                           tr_cat_distr: bool = False,
                           tr_max_neg: bool = False,
                           tr_sum_max_flag: bool = True,
                           rng: Optional[torch.Generator] = None):
    """MarginTrackRelsLoss: joint grounding + relationships
    (ref mlp/model.py:497-575)."""
    ints = outputs["inters"].float()  # [B, T, C]
    rels = outputs["rels"].float()  # [B, T, R]
    B, T, C = ints.shape
    R = rels.shape[-1]
    dev = ints.device
    target = batch["labels"].reshape(-1).long()
    target_rels = batch["rels_label"].long()  # [B, T]
    mem = batch["mem_mask"].float()
    gt = batch["gt_tracks"].long()

    valid = mem[:, :, None] > 0
    ints = torch.where(valid, ints, NEG_INF)
    neg_mask_ints = valid.float()

    rel_valid = (target_rels != n_rels)[:, :, None]  # [B, T, 1]
    mask_rels = valid & rel_valid
    # append the 'None' column: zero scores, never a negative (ref :521-522)
    rels_p = torch.cat([rels, torch.zeros((B, T, 1), device=dev)], dim=-1)
    mask_rels_p = torch.cat(
        [mask_rels.expand(B, T, R),
         torch.zeros((B, T, 1), dtype=torch.bool, device=dev)], dim=-1)
    rels_p = torch.where(mask_rels_p, rels_p, NEG_INF)
    neg_mask_rels = mask_rels_p.float()

    neg_mask_ints = neg_mask_ints * batch["multilab_weights"].float()[
        :, None, :]
    cls_oh = _one_hot(target, C)
    if tr_correct:
        slot_oh = (_one_hot(gt[:, 0], T) + _one_hot(gt[:, 1], T)).clamp(
            max=1.0)
        neg_mask_ints = neg_mask_ints * (
            1.0 - slot_oh[:, :, None] * cls_oh[:, None, :])
        # zero each hypothesis row's own rel label (ref :531-533)
        neg_mask_rels = neg_mask_rels * (1.0 - _one_hot(target_rels, R + 1))
    else:
        neg_mask_ints = neg_mask_ints * (1.0 - cls_oh[:, None, :])
        rel_at_gt0 = select_along_axis(target_rels, gt[:, 0], axis=1)
        rel_at_gt1 = select_along_axis(target_rels, gt[:, 1], axis=1)
        gt_rel_oh = (_one_hot(rel_at_gt0, R + 1)
                     + _one_hot(rel_at_gt1, R + 1)).clamp(max=1.0)
        neg_mask_rels = neg_mask_rels * (1.0 - gt_rel_oh[:, None, :])

    rel_at_gt0 = select_along_axis(target_rels, gt[:, 0], axis=1)
    col_ints = select_along_axis(ints, target[:, None], axis=2)  # [B, T]
    col_rels = select_along_axis(rels_p, rel_at_gt0[:, None], axis=2)

    s_ints = torch.sigmoid(ints)
    s_rels = torch.sigmoid(rels_p)
    s_col_ints = torch.sigmoid(col_ints)
    s_col_rels = torch.sigmoid(col_rels)

    if tr_cat_distr:
        probs_cl = torch.softmax(col_ints, dim=1)
        probs_rels = torch.nan_to_num(torch.softmax(col_rels, dim=1))
        max_idxs = _sample((probs_cl + probs_rels) / 2.0, rng)
    elif tr_correct:
        max_idxs = torch.zeros(B, dtype=torch.long, device=dev)
    else:
        max_idxs = torch.argmax((s_col_ints + s_col_rels) * mem, dim=1)

    pos = select_along_axis(s_col_ints, max_idxs, axis=1)
    pos_rels = select_along_axis(s_col_rels, max_idxs, axis=1)

    bw = _batch_weight(batch)
    if tr_max_neg and tr_sum_max_flag:
        neg_max = (s_ints * neg_mask_ints).amax(dim=2)
        neg_max_rels = (s_rels * neg_mask_rels).amax(dim=2)
        loss_ints = _wmean(
            torch.relu((tr_margin - pos)[:, None] + neg_max).sum(dim=1), bw)
        loss_rels = _wmean(
            torch.relu((tr_margin - pos_rels)[:, None]
                       + neg_max_rels).sum(dim=1), bw)
    else:
        loss_ints = _wmean(
            _pair_margin(s_ints, pos, neg_mask_ints, tr_margin), bw)
        loss_rels = _wmean(
            _pair_margin(s_rels, pos_rels, neg_mask_rels, tr_margin), bw)
    return lymbda * loss_ints + loss_rels
