"""Plain reference of int_rels, the joint interaction and relationship model
without the grounding (MidFusionMultiClip with the 18-clip relationship
context and the gate, MultiTaskMaxMargin), as the released int_rel model
evaluates a split: the published code's resume/int_rels.py, mlp/model.py
(MidFusionMultiClip, MultiTaskMaxMargin) and utils/evaluation.py
(MetricAccumulator.update_probs, RelationshipsAcc, ref :367-417). Plain
PyTorch, float32 with TF32 off; it imports nothing of the program, and
takes the layers' arithmetic from reference/plain.py.

Per sample: the ground-truth row's four modality MLPs (the ``ints``
branch) concatenated, tanh; the same MLPs of the ``ctx`` branch over each
of the R context clips, their masked mean (no guard against an empty
context, as in the model: the split leaves none empty), tanh; the gate,
relu(linear(cat(context, interaction))); the heads out_ints and out_ctx.
The loss, per batch: the interaction margin term over every class but
the label, masked by ``multilab_weights``, weighted by lymbda, plus the
relationship margin term over the samples whose label is not 'None'. The
sweep's numbers: the interaction top-1/3/5/10 counts over the logits;
each (pair, relationship) hash's sigmoid relationship scores summed in
sample order, with its label; top-1 and top-3 over the hashes.

Departures from the published code, none of which changes a number in
exact arithmetic:
- the modality MLPs run once per table row and their outputs are
  gathered (eval has no dropout), as ``plain.embed_tables`` does;
- the published loss picks the labelled relationship rows with a boolean
  index and averages them; here a 0/1 mask and a sum over at least one;
- where two interaction logits tie, the lower class ranks first (the
  published ``topk`` leaves the order of ties open); a hash's rank of its
  label counts the classes whose sum is larger;
- the per-hash sums are float32 in sample order (the published code adds
  numpy float32 rows one sample at a time: the same chain).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from reference.plain import (_Drop, _gather_embedded, _heads, _pair_margin,
                             bf16_quant, embed_tables, fp8_quant, no_tf32,
                             param_shapes)

__all__ = ["param_shapes", "fp8_quant", "bf16_quant", "no_tf32",
           "embed_tables", "forward_eval", "loss", "counters",
           "hash_sums", "rels_counts", "MODEL", "TOPK"]

# what this reference computes: the configuration file must say the same
MODEL = {"ctx": True, "gates": True, "tr_maximize": False,
         "tr_correct": False}
# the interaction counters' k (capped at the class count)
TOPK = (1, 3, 5, 10)


def forward_eval(params, cfg, embedded, feat_idx, rels_mask, quant=None
                 ) -> Dict[str, torch.Tensor]:
    """The eval forward of a batch from ``embed_tables``: feat_idx [B, 1 +
    R, 3] (the ground-truth row at slot 0, the context at 1..R), rels_mask
    [B, R] or [B, R, 1] -> {"inters": [B, n_classes], "rels": [B,
    n_rels]}."""
    B = feat_idx.shape[0]
    out_ints = torch.tanh(_gather_embedded(embedded["ints"],
                                           feat_idx[:, 0]))
    e = _gather_embedded(embedded["ctx"], feat_idx[:, 1:])
    m = rels_mask.reshape(B, -1).float()
    out_ctx = torch.tanh((e * m[..., None]).sum(dim=1)
                         / m.sum(dim=1, keepdim=True))
    heads = _heads(params, cfg, out_ints, out_ctx, _Drop(0.0, None), quant,
                   B, 1)
    return {k: v[:, 0] for k, v in heads.items()}


def _one_hot(idx, n):
    return (idx.long()[..., None] == torch.arange(n, device=idx.device)
            ).float()


def loss(out, batch, cfg) -> torch.Tensor:
    """MultiTaskMaxMargin (ref mlp/model.py:381-419) of one batch."""
    margin = cfg["margin"]
    ints = torch.sigmoid(out["inters"].float())
    C = ints.shape[-1]
    target = batch["labels"].reshape(len(ints), -1)[:, 0].long()
    neg = (1.0 - _one_hot(target, C)) * batch["multilab_weights"].float()
    pos = ints.gather(1, target[:, None])[:, 0]
    total = cfg["lymbda"] * _pair_margin(ints, pos, neg, margin).mean()
    rels = torch.sigmoid(out["rels"].float())
    NR = rels.shape[-1]
    label = batch["rels_label"].reshape(-1).long()
    valid = (label != NR).float()
    safe = label.clamp(0, NR - 1)
    per = _pair_margin(rels, rels.gather(1, safe[:, None])[:, 0],
                       1.0 - _one_hot(safe, NR), margin)
    return total + (per * valid).sum() / valid.sum().clamp(min=1.0)


def counters(out, batch, cfg) -> Dict[str, int]:
    """The interaction top-k counts of one batch (ref utils/evaluation.py
    update_probs, :68-107), as ints: a sample counts at k where fewer
    than k classes rank before its label."""
    logits = out["inters"].float()
    B, C = logits.shape
    target = batch["labels"].reshape(B, -1)[:, 0].long()
    at = logits.gather(1, target[:, None])
    lower = torch.arange(C, device=logits.device)[None, :] < target[:, None]
    rank = ((logits > at) | ((logits == at) & lower)).sum(dim=1)
    res = {"top%d" % k: int((rank < min(k, C)).sum()) for k in TOPK}
    res["total"] = B
    return res


def hash_sums(probs: torch.Tensor, hashes: torch.Tensor,
              labels: torch.Tensor, n_hashes: int, n_rels: int):
    """RelationshipsAcc's state over a split: probs [N, n_rels] (the
    sigmoid relationship scores in sample order), hashes [N] (-1: none),
    labels [N] (n_rels: 'None'). Returns (sums [n_hashes, n_rels], each
    hash's labelled samples' scores added in sample order in float32;
    label [n_hashes], its samples' label; seen [n_hashes] bool)."""
    keep = (labels != n_rels) & (hashes >= 0)
    p, h, lab = probs[keep].float(), hashes[keep].long(), labels[keep].long()
    dev = probs.device
    sums = torch.zeros(n_hashes, probs.shape[-1], device=dev)
    label = torch.zeros(n_hashes, dtype=torch.long, device=dev)
    seen = torch.zeros(n_hashes, dtype=torch.bool, device=dev)
    # the k-th sample of each hash in order: one add per hash a round, so
    # each hash's chain runs in sample order
    order = torch.argsort(h, stable=True)
    first = torch.searchsorted(h[order], h[order], right=False)
    nth = torch.empty_like(h)
    nth[order] = torch.arange(len(h), device=dev) - first
    for k in range(int(nth.max()) + 1 if len(h) else 0):
        at = nth == k
        sums[h[at]] += p[at]
    label[h], seen[h] = lab, True
    return sums, label, seen


def rels_counts(sums: torch.Tensor, label: torch.Tensor, seen: torch.Tensor
                ) -> Dict[str, int]:
    """RelationshipsAcc's top-1 and top-3 over the seen hashes: a hash
    counts at k where fewer than k relationships sum higher than its
    label's."""
    s, lab = sums[seen], label[seen]
    rank = (s > s.gather(1, lab[:, None])).sum(dim=1)
    return {"rels_top1": int((rank < 1).sum()),
            "rels_top3": int((rank < 3).sum()), "n_hashes": int(seen.sum())}
