"""Whole-split evaluation on the card (counterpart of
lirec_tpu/evaluation/packed.py).

The split is materialized once (``dataset.materialize()``) and staged on
the device as ``[n_full, B, ...]`` tensors; a Python loop steps over the
full batches (the JAX package's one-dispatch ``fori_loop``), and every
metric counter (the grounding argmax counts of
``update_probs_max_tracks[_rels]``, ref evaluation.py:114-271, the
top-k/soft counters of ``update_probs``, ref :68-107, and the per-hash
score sums of ``RelationshipsAcc``, ref :367-417) accumulates in a carry
of device tensors. One fetch at the end returns everything; the host
finishes the divisions and the per-hash argsort. The ragged tail is a
second step at its natural size, or is dropped when it is one sample (the
reference skips size-1 batches, ref test.py:38-39).

Eval ctx localisation (``localize_ctx``): ``"triple"`` gathers each
batch's unique [clip | tr1 | tr2] index triples into one local table and
pools it with the triple kernel (ops/gather_pool.fused_ctx_pool_triple);
``"tables"`` (or True) gathers each batch's unique embedded ctx rows per
table; False and None keep the full tables (measured on the card, the
triple tier's per-batch local-table build costs more than its kernel
saves: PERF.md). Every tier gives bitwise the same carry.

Not ported: the cross-process reduction ``allreduce_carry`` and the mesh
(multi-GPU), the TPU's VMEM cost model of the localisation gate, and the
``LIREC_TPU_EVAL_LOCALIZE`` switch.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np
import torch

from lirec_tpu_torch.evaluation.metrics import MetricAccumulator, RelationshipsAcc
from lirec_tpu_torch.evaluation.runner import summarize_metrics

__all__ = [
    "evaluate_packed",
    "device_sweep_builder",
    "finish_from_carry",
    "inject_loc",
    "loc_apply_data",
]

MODEL_KEYS = ("feat_idx", "rels_mask", "ctx_uniq_clip", "ctx_uniq_track",
              "ctx_tidx", "ctx_triples")


def _topk_counters(logits, gt, n_classes, soft_labels=None):
    """Device mirror of MetricAccumulator.update_probs (ref :68-107).

    logits: [B, C] float32; gt: [B]. Returns the counter dict. A stable
    descending sort puts tied classes in index order,
    as ``jax.lax.top_k`` does (``torch.topk`` does not promise it).
    """
    k = min(10, n_classes)
    top = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :k]
    hit = top == gt.long()[:, None]
    counters = {
        "top1": hit[:, 0].sum(),
        "top3": hit[:, : min(3, k)].any(dim=1).sum(),
        "top5": hit[:, : min(5, k)].any(dim=1).sum(),
        "top10": hit.any(dim=1).sum(),
        "total": logits.shape[0],
    }
    if soft_labels is not None:
        # first top-5 prediction inside the soft set decides both counters
        # (ref :87-94): soft@5 = any of top-5 in the set, soft@1 = top-1 in it
        k5 = min(5, k)
        in_soft = (top[:, :k5, None] == soft_labels.long()[:, None, :]
                   ).any(dim=2)
        counters["top1_sf"] = in_soft[:, 0].sum()
        counters["top5_sf"] = in_soft.any(dim=1).sum()
    return counters


def _grounding_counters(preds, gt_classes, gt_tracks, just_zeros,
                        gt_rels=None, n_rels=0):
    """Device mirror of MetricAccumulator.update_from_predictions
    (counting semantics of update_probs_max_tracks[_rels], ref :114-271)."""
    B = gt_classes.shape[0]
    rows = torch.arange(B, device=gt_classes.device)
    gt_classes = gt_classes.reshape(-1).long()
    nz = ~just_zeros.bool()
    g0 = gt_tracks[:, 0].long()
    g1 = gt_tracks[:, 1].long()
    has2 = g1 != 0

    l0 = preds["cls_argmax"][rows, g0]
    l1 = preds["cls_argmax"][rows, g1]
    correct0 = l0 == gt_classes
    cls_top1 = correct0.sum() + (~correct0 & (l1 == gt_classes)).sum()

    pr_track = preds["pr_track"]
    hit0 = pr_track == g0
    hit1 = has2 & ~hit0 & (pr_track == g1)
    trks_top1 = (nz & hit0).sum() + (nz & hit1).sum()

    jmatch = preds["c_star"] == gt_classes
    counters = {
        "total": nz.sum(),
        "total_cl": B,
        "cls_top1": cls_top1,
        "trks_top1": trks_top1,
    }
    if gt_rels is not None:
        gt_rels = gt_rels.long()
        rel0 = gt_rels[:, 0]
        # reference rels_mask-nonzero sample filter (ref test.py:62)
        rvalid = (rel0 - n_rels + 1) != 0
        counters["total_rels"] = rvalid.sum()
        rels_argmax = preds["rels_argmax"]
        p0 = rels_argmax[rows, g0]
        p1 = rels_argmax[rows, g1]
        rcorrect0 = p0 == gt_rels[rows, g0]
        counters["rels_top1"] = (rvalid & rcorrect0).sum() + (
            rvalid & ~rcorrect0 & (p1 == gt_rels[rows, g1])).sum()
        jmatch = jmatch & (preds["r_star"] == rel0)
    t_star = preds["t_star"]
    joint0 = jmatch & (t_star == g0)
    joint1 = has2 & ~hit0 & jmatch & (t_star == g1)
    counters["top1"] = (nz & joint0).sum() + (nz & joint1).sum()
    return counters


def device_sweep_builder(bundle, t, n_classes: int, n_rels: int,
                         n_hashes: int, use_kernel: bool = True):
    """Build (init_carry, step) for the metric sweep on the card.

    ``init_carry(device)`` gives the zero carry; ``step(model, tables,
    embedded, carry, batch)`` runs the model, the loss and the metric
    counting of one batch of device tensors and folds the counts into
    `carry` (in place, and returns it). use_kernel=False takes the plain
    ctx pools, for comparisons. The JAX package's opt-in confusion matrix
    (``with_conf_mat``), which no metric reads, is not ported.
    """
    from lirec_tpu_torch.evaluation.device_metrics import (
        grounding_predictions,
    )
    from lirec_tpu_torch.ops.scatter_accum import scatter_accum1

    spec = bundle.spec
    maxtracks = t.tr_maximize and t.ints
    plain = not t.tr_maximize and not t.rels_multitask
    rels_table = t.rels_multitask and t.ctx and not t.tr_maximize
    loss_rng = {}  # one fixed generator per device, for tr_cat_distr

    def init_carry(device):
        def zero(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)

        carry = {"loss_sum": zero(dtype=torch.float32), "n_batches": zero()}
        if maxtracks:
            names = ["total", "total_cl", "cls_top1", "trks_top1", "top1"]
            if t.ctx:
                names += ["total_rels", "rels_top1"]
        else:
            names = ["total", "top1", "top3", "top5", "top10"]
            if t.soft_gt:
                names += ["top1_sf", "top5_sf"]
        carry.update({n: zero() for n in names})
        if rels_table:
            # RelationshipsAcc state: per-hash sigmoid-score sums (+1 dump
            # row for filtered samples), gt label, and a seen count. Width =
            # the model head (spec.n_rels); dataset.n_rels counts 'None' too
            carry["rels_table"] = zero(n_hashes + 1, spec.n_rels,
                                       dtype=torch.float32)
            carry["rels_gt"] = zero(n_hashes + 1)
            carry["rels_seen"] = zero(n_hashes + 1)
        return carry

    def step(model, tables, embedded, carry, batch):
        device = batch["labels"].device
        out = bundle.apply(
            model, {k: batch[k] for k in MODEL_KEYS if k in batch},
            tables=tables, embedded=embedded, use_kernel=use_kernel,
        )
        rng = None
        if t.tr_cat_distr:
            if device not in loss_rng:
                loss_rng[device] = torch.Generator(device=device)
            rng = loss_rng[device].manual_seed(0)
        loss = bundle.loss(out, batch, rng=rng)
        carry["loss_sum"] += loss.float()
        carry["n_batches"] += 1
        B = batch["labels"].shape[0]

        def fold(counters):
            for key, val in counters.items():
                carry[key] += val

        if maxtracks:
            preds = grounding_predictions(
                out["inters"], batch["mem_mask"], batch["labels"],
                pr_probs_rels=out["rels"] if t.ctx else None,
                gt_rels=batch["rels_label"] if t.ctx else None,
            )
            fold(_grounding_counters(
                preds, batch["labels"], batch["gt_tracks"],
                batch["just_zeros"],
                gt_rels=batch["rels_label"] if t.ctx else None,
                n_rels=n_rels,
            ))
            return carry

        if plain:
            logits = out["inters"].float().reshape(B, -1)
            gt = batch["labels"].reshape(-1).long()
            fold(_topk_counters(
                logits, gt, n_classes,
                soft_labels=batch["soft_labels"] if t.soft_gt else None,
            ))
            return carry

        # rels_multitask without maxtracks (int_rels preset)
        if t.ints:
            inters = out["inters"].float().reshape(B, -1, n_classes)[:, 0]
            gt = batch["labels"][:, 0].reshape(-1).long()
            fold(_topk_counters(inters, gt, n_classes))
        if t.ctx:
            rels_label = batch["rels_label"].reshape(-1).long()
            hashes = batch["hash_rel"].reshape(-1).long()
            valid = (rels_label - n_rels + 1) != 0
            probs = torch.sigmoid(out["rels"].float())
            h = torch.where(valid & (hashes >= 0), hashes,
                            torch.full_like(hashes, n_hashes))
            upd = torch.where(valid[:, None], probs, torch.zeros_like(probs))
            # the score table is a float segment-sum: added row by row in
            # update order (the in-order scatter; float atomics would add
            # in another order on every run), with the running table as
            # each row's first term, so every row rounds as XLA's
            # sequential scatter-add does
            n_rows = n_hashes + 1
            ids = torch.cat([torch.arange(n_rows, device=device), h])
            carry["rels_table"] = scatter_accum1(
                ids.to(torch.int32).contiguous(),
                torch.cat([carry["rels_table"], upd]).contiguous(), n_rows)
            carry["rels_gt"][h] = rels_label
            carry["rels_seen"].index_add_(0, h, valid.long())
        return carry

    return init_carry, step


def inject_loc(batch: Dict, loc: Dict, i):
    """Add batch i's ctx localization ids (no-op on an empty loc tree).
    The triple tier carries per-batch unique index triples; its
    per-sample ``ctx_tidx`` rides in the data tree, sliced with the
    batch."""
    if not loc:
        return batch
    if "triples" in loc:
        return dict(batch, ctx_triples=loc["triples"][i])
    return dict(
        batch, ctx_uniq_clip=loc["clip"][i], ctx_uniq_track=loc["track"][i]
    )


def loc_apply_data(data: Dict, loc: Optional[Dict]) -> Dict:
    """Merge a loc's per-SAMPLE arrays into the sweep data tree: the
    (possibly remapped) feat_idx, plus ctx_tidx in triple mode (sliced
    alongside the batch; tail rows carry zeros and run the plain path)."""
    if loc is None:
        return data
    data = dict(data, feat_idx=loc["feat_idx"])
    if "ctx_tidx" in loc:
        data["ctx_tidx"] = loc["ctx_tidx"]
    return data


def _loc_device_tree(loc: Optional[Dict], device) -> Dict:
    """The per-batch loc arrays on the device, keyed for inject_loc."""
    if not loc:
        return {}
    if "triples" in loc:
        return {"triples": torch.as_tensor(loc["triples"], device=device)}
    return {"clip": torch.as_tensor(loc["uniq_clip"], device=device),
            "track": torch.as_tensor(loc["uniq_track"], device=device)}


def _digest(fi: np.ndarray) -> bytes:
    return hashlib.blake2b(np.ascontiguousarray(fi), digest_size=16).digest()


def _maybe_localize_eval_ctx(dataset, data, embedded, B: int, n_full: int,
                             t, use_kernel, override):
    """Decide + compute per-batch ctx localization for the sweep.

    override: True or 'tables' force the per-table tier
    (localize_eval_ctx: {feat_idx with slots 1..R remapped for the first
    n_full*B rows, uniq_clip [n_full, cap_c], uniq_track [n_full,
    cap_t]}); 'triple' the triple tier (localize_eval_ctx_triples:
    {feat_idx unchanged, ctx_tidx [N, (T,) R], triples [n_full, cap_u,
    3]}); False keeps the full tables; None (auto) keeps them too: on
    the card every table lives in device memory, so the TPU's VMEM cost
    model does not apply, and the triple tier measured slower there (its
    local-table build costs more device time than the 3-table kernel
    takes; PERF.md). use_kernel=False (the plain pools) keeps the
    full tables.

    The analysis is cached on the dataset, keyed on the feat_idx array
    (with a content digest for callers that re-slice it): the eval split
    is fixed, so cadence evals reuse it. The decision is recorded via
    ops/dispatch ('eval_ctx_localize').
    """
    from lirec_tpu_torch.data.localize import (
        localize_eval_ctx,
        localize_eval_ctx_triples,
    )
    from lirec_tpu_torch.ops import dispatch

    if override is True:
        override = "tables"  # historical 'forced on' = the per-table tier
    ctx = (embedded or {}).get("ctx")
    if not t.ctx or ctx is None or not n_full or "feat_idx" not in data:
        return None  # structurally inapplicable: nothing to decide
    if override is False or use_kernel is False:
        dispatch.record("eval_ctx_localize", "off", "forced", {})
        return None
    if override is None:
        dispatch.record(
            "eval_ctx_localize", "off",
            "auto: full tables (on the card the triple tier's local-table "
            "build costs more than its kernel saves)", {})
        return None
    mode = override
    fi = np.asarray(data["feat_idx"])
    cache = getattr(dataset, "_eval_ctx_loc_cache", None)
    cache_key = (B, n_full, fi.shape, mode)
    digest = None
    if cache is not None and cache[1] == cache_key:
        if cache[0] is fi:
            return _gate_local(cache[2], ctx)
        digest = _digest(fi)
        if cache[3] == digest:
            return _gate_local(cache[2], ctx)
    if mode == "triple":
        tidx, triples = localize_eval_ctx_triples(
            fi, B, n_full, ctx.tr1.shape[0])
        loc = {"feat_idx": fi, "ctx_tidx": tidx, "triples": triples}
    else:
        new_fi, uc, ut = localize_eval_ctx(
            fi, B, n_full, ctx.clip.shape[0], ctx.tr1.shape[0])
        loc = {"feat_idx": new_fi, "uniq_clip": uc, "uniq_track": ut}
    try:
        dataset._eval_ctx_loc_cache = (fi, cache_key, loc,
                                       digest or _digest(fi))
    except AttributeError:
        pass  # dataset without attribute support: recompute per eval
    return _gate_local(loc, ctx)


def _gate_local(loc, ctx):
    """Record the (forced) localisation of a computed loc and return it."""
    from lirec_tpu_torch.ops import dispatch

    if "triples" in loc:
        shapes = {"tier": "triple", "caps": (loc["triples"].shape[1],)}
    else:
        shapes = {"tier": "tables", "caps": (loc["uniq_clip"].shape[1],
                                             loc["uniq_track"].shape[1])}
    shapes["tables"] = (ctx.clip.shape[0], ctx.tr1.shape[0])
    dispatch.record("eval_ctx_localize", "on", "forced", shapes)
    return loc


def evaluate_packed(
    dataset,
    bundle,
    model,
    cfg,
    mode: str = "val",
    tables: Optional[Dict] = None,
    verbose: bool = True,
    data: Optional[Dict[str, np.ndarray]] = None,
    batch_size: Optional[int] = None,
    use_kernel: bool = True,
    localize_ctx=None,
) -> Dict[str, float]:
    """Evaluation of a whole split on ``model``'s device; returns the same
    metric dict (and prints the same lines) as the JAX package's
    evaluate_packed."""
    t = cfg.tasks
    n_rels = dataset.n_rels
    n_classes = dataset.n_classes
    n_hashes = len(getattr(dataset, "hashidx_rels", ()) or ())
    B = batch_size or cfg.optim.batch_size

    if data is None:
        data = dataset.materialize()
    N = len(data["labels"])
    n_full, tail = divmod(N, B)
    if tail == 1:
        tail = 0  # ref test.py:38-39: size-1 batches are skipped
    if tables is None:
        tables = dataset.tables.as_dict()

    from lirec_tpu_torch.models.tabular import embed_all

    device = next(model.parameters()).device
    init_carry, step = device_sweep_builder(
        bundle, t, n_classes, n_rels, n_hashes, use_kernel=use_kernel)
    model.eval()
    with torch.inference_mode():
        tables = {k: torch.as_tensor(np.asarray(tables[k], np.float32),
                                     device=device)
                  for k in ("text", "visual", "track")}
        embedded = embed_all(model, bundle.spec, tables)
        # remapped feat_idx replaces the sweep rows (tail rows untouched);
        # per-batch unique ids ride a separate [n_full, cap] tree
        loc = _maybe_localize_eval_ctx(dataset, data, embedded, B, n_full,
                                       t, use_kernel, localize_ctx)
        data = loc_apply_data(data, loc)
        # staged once: [n_full, B, ...] on the device, indexed per batch
        data_dev = {
            k: torch.as_tensor(np.asarray(v)[: n_full * B]).reshape(
                (n_full, B) + np.shape(v)[1:]).to(device)
            for k, v in data.items()
        }
        loc_dev = _loc_device_tree(loc, device)
        carry = init_carry(device)
        for i in range(n_full):
            batch = inject_loc({k: v[i] for k, v in data_dev.items()},
                               loc_dev, i)
            carry = step(model, tables, embedded, carry, batch)
        if tail:
            tail_batch = {
                k: torch.as_tensor(np.asarray(v)[n_full * B:]).to(device)
                for k, v in data.items()
            }
            carry = step(model, tables, embedded, carry, tail_batch)
        carry = {k: v.cpu().numpy() for k, v in carry.items()}
    return finish_from_carry(carry, t, n_rels, n_hashes, mode, verbose)


def finish_from_carry(
    carry, t, n_rels: int, n_hashes: int, mode: str, verbose: bool
) -> Dict[str, float]:
    """Host finish of the sweep: fill the accumulators from the fetched
    counters and emit the metric dict (divisions + the per-hash argsort of
    RelationshipsAcc only)."""
    carry = {k: np.asarray(v) for k, v in carry.items()}
    prec = MetricAccumulator(n_rels=n_rels)
    prec.total = int(carry.get("total", 0))
    prec.total_cl = int(carry.get("total_cl", 0))
    prec.total_rels = int(carry.get("total_rels", 0))
    for host_attr, key in (
        ("_top1", "top1"), ("_top3", "top3"), ("_top5", "top5"),
        ("_top10", "top10"), ("_top1_sf", "top1_sf"),
        ("_top5_sf", "top5_sf"), ("_cls_top1", "cls_top1"),
        ("_trks_top1", "trks_top1"), ("_rels_top1", "rels_top1"),
    ):
        if key in carry:
            setattr(prec, host_attr, int(carry[key]))

    prec_rels = None
    if "rels_table" in carry:
        prec_rels = RelationshipsAcc(n_rels=n_rels)
        for h in np.nonzero(carry["rels_seen"][:n_hashes])[0]:
            prec_rels._pr_probs[int(h)] = carry["rels_table"][h]
            prec_rels._gt[int(h)] = int(carry["rels_gt"][h])

    n_batches = int(carry["n_batches"])
    avg_loss = float(carry["loss_sum"]) / n_batches if n_batches else 0.0
    return summarize_metrics(t, prec, prec_rels, avg_loss, mode, verbose)
