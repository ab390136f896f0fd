"""Whole-split evaluation on the card (counterpart of
lirec_tpu/evaluation/packed.py).

The split is materialized once (``dataset.materialize()``) and staged on
the device as ``[n_full, B, ...]`` tensors, and a step runs per full batch
(the JAX package's one-dispatch ``fori_loop``): on a card one replay of a
CUDA graph of the step (utils/graphs.StepGraph), captured once per model
and key of shapes, dtype and localisation tier (the first sweep of a key
runs batch 0 eagerly as the warm-up, then captures; a later one copies
its batches, tables and embeddings into the graph's static tensors and
replays it n_full times); it reads batch i of the staged stack through a
device-side index it advances. On the CPU, or with
``graph=False`` (the tests, ``chip_smoke.py`` and the tools compare the
two), a Python loop of eager steps. Every metric counter (the grounding
argmax counts of ``update_probs_max_tracks[_rels]``, ref
evaluation.py:114-271, the top-k/soft counters of ``update_probs``, ref
:68-107, and the per-hash score sums of ``RelationshipsAcc``, ref
:367-417) accumulates in a carry of device tensors, updated in place. One fetch at the end returns
everything; the host finishes the divisions and ranks each seen hash. The
ragged tail is one eager step at its natural size, or is dropped when it
is one sample (the reference skips size-1 batches, ref test.py:38-39).
``dispatch.decisions("eval_sweep")`` counts which loop ran ("graph" or
"eager").

Eval ctx localisation (``localize_ctx``): ``"triple"`` gathers each
batch's unique [clip | tr1 | tr2] index triples into one local table and
pools it with the triple kernel (ops/gather_pool.fused_ctx_pool_triple);
``"tables"`` (or True) gathers each batch's unique embedded ctx rows per
table; False and None keep the full tables (measured on the card, the
triple tier's per-batch local-table build costs more than its kernel
saves: PERF.md). Every tier gives bitwise the same carry.

Over a data mesh of several processes (parallel/dist.py), each process
sweeps its own contiguous block of full batches (the last one also takes
the ragged tail), so the reference's batch boundaries stay where they
were, with no collective inside the loop (the graph serves there too),
and ``allreduce_carry`` combines the carries: every process ends with the
global carry and the same metrics. Under a model axis the samples are
split over the data axis only: the model peers of a row sweep the same
block (as in the JAX package), and the carries are combined over the
data group, so that no sample counts M times.

Not ported: the TPU's VMEM cost model of the localisation gate, and the
``LIREC_TPU_EVAL_LOCALIZE`` switch.
"""

from __future__ import annotations

import hashlib
import itertools
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from lirec_tpu_torch.evaluation.metrics import MetricAccumulator, RelationshipsAcc
from lirec_tpu_torch.evaluation.runner import summarize_metrics
from lirec_tpu_torch.utils.graphs import StepGraph, capturing, take
from lirec_tpu_torch.utils.profiling import span

__all__ = [
    "evaluate_packed",
    "device_sweep_builder",
    "finish_from_carry",
    "allreduce_carry",
    "sweep_carry",
    "inject_loc",
    "loc_apply_data",
]

MODEL_KEYS = ("feat_idx", "rels_mask", "ctx_uniq_clip", "ctx_uniq_track",
              "ctx_tidx", "ctx_triples")


def allreduce_carry(carry: Dict[str, np.ndarray],
                    mesh=None) -> Dict[str, np.ndarray]:
    """Combine the processes' host carries into the global one (each
    process swept its own block of batches); every process gets it. With
    a `mesh` (parallel/mesh.Mesh2D), over its data group only (the model
    peers of a row swept the same block); else over the whole group.

    Counters, loss sums and the RelationshipsAcc score table are summed.
    ``rels_seen`` is the port's count of valid rows per hash, so its sum is
    both the JAX package's any-reduce (nonzero where any process saw the
    hash) and the one-process count; ``rels_gt`` is a consistent label per
    hash, the max over the processes that saw it. The carries are small:
    they are gathered through the group as host copies. A no-op for one
    process."""
    from lirec_tpu_torch.parallel.dist import all_gather_object

    ranks = all_gather_object(carry, None if mesh is None
                              else mesh.data_group)
    if len(ranks) == 1:
        return carry
    out = {}
    for key in carry:
        stacked = np.stack([r[key] for r in ranks])
        if key == "rels_gt":
            seen = np.stack([r["rels_seen"] for r in ranks]) > 0
            out[key] = np.where(seen, stacked, 0).max(axis=0)
        else:
            out[key] = stacked.sum(axis=0)
    return out


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


def _has_rels_table(t) -> bool:
    """Whether the sweep folds RelationshipsAcc's per-hash score table
    (the int_rels preset: relationships without the grounding)."""
    return t.rels_multitask and t.ctx and not t.tr_maximize


def _record_rels_fold(n_rows: int, batch_size: int, width: int,
                      device) -> None:
    """Record the shape of the score table's fold (once a sweep build):
    each full batch folds ``n_rows`` table rows and ``batch_size`` update
    rows of ``width`` through ``scatter_accum1``, on the launch
    ``scatter_path`` picks for a card ("reference" for CPU tensors)."""
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.scatter_accum import scatter_path

    updates = n_rows + batch_size
    path = scatter_path(updates, (n_rows,), (width,))
    dispatch.record("eval_rels_fold",
                    path if device.type == "cuda" else "reference",
                    "%s tensors" % device.type,
                    {"rows": n_rows, "updates": updates, "width": width,
                     "scatter_path": path})


def device_sweep_builder(bundle, t, n_classes: int, n_rels: int,
                         n_hashes: int, use_kernel: bool = True):
    """Build (init_carry, step) for the metric sweep on the card.

    ``init_carry(device)`` gives the zero carry; ``step(model, tables,
    embedded, carry, batch)`` runs the model, the loss and the metric
    counting of one batch of device tensors and folds the counts into
    `carry` (in place, and returns it). use_kernel=False takes the plain
    ctx pools, for comparisons. ``step.loss_generator(device)`` is the
    generator of ``tr_cat_distr``'s draws (None without it), which the step
    seeds to 0 before every batch, outside a CUDA graph's capture; a
    replay's caller seeds it. The JAX package's opt-in confusion matrix
    (``with_conf_mat``), which no metric reads, is not ported.
    """
    from lirec_tpu_torch.evaluation.device_metrics import (
        grounding_predictions,
    )
    from lirec_tpu_torch.ops.scatter_accum import scatter_accum1

    spec = bundle.spec
    maxtracks = t.tr_maximize and t.ints
    plain = not t.tr_maximize and not t.rels_multitask
    rels_table = _has_rels_table(t)
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

    def loss_generator(device):
        if not t.tr_cat_distr:
            return None
        if device not in loss_rng:
            loss_rng[device] = torch.Generator(device=device)
        return loss_rng[device]

    def step(model, tables, embedded, carry, batch):
        device = batch["labels"].device
        out = bundle.apply(
            model, {k: batch[k] for k in MODEL_KEYS if k in batch},
            tables=tables, embedded=embedded, use_kernel=use_kernel,
        )
        rng = loss_generator(device)
        if rng is not None and not capturing():
            rng.manual_seed(0)
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
            carry["rels_table"].copy_(scatter_accum1(
                ids.to(torch.int32).contiguous(),
                torch.cat([carry["rels_table"], upd]).contiguous(), n_rows))
            carry["rels_gt"][h] = rels_label
            carry["rels_seen"].index_add_(0, h, valid.long())
        return carry

    step.loss_generator = loss_generator
    return init_carry, step


def _at(stack, i):
    """stack[i] for an int, or for a one-element device index tensor."""
    return take(stack, i) if isinstance(i, torch.Tensor) else stack[i]


def inject_loc(batch: Dict, loc: Dict, i):
    """Add batch i's ctx localization ids (no-op on an empty loc tree); `i`
    an int or a one-element device index tensor. The triple tier carries
    per-batch unique index triples; its per-sample ``ctx_tidx`` rides in
    the data tree, sliced with the batch."""
    if not loc:
        return batch
    if "triples" in loc:
        return dict(batch, ctx_triples=_at(loc["triples"], i))
    return dict(batch, ctx_uniq_clip=_at(loc["clip"], i),
                ctx_uniq_track=_at(loc["track"], i))


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


def sweep_carry(
    dataset,
    bundle,
    model,
    cfg,
    mode: str = "val",
    tables: Optional[Dict] = None,
    data: Optional[Dict[str, np.ndarray]] = None,
    batch_size: Optional[int] = None,
    use_kernel: bool = True,
    localize_ctx=None,
    mesh=None,
    graph: Optional[bool] = None,
) -> Dict[str, np.ndarray]:
    """The sweep's carry of a whole split, on the host: the counters
    ``finish_from_carry`` turns into metrics. Over a `mesh`
    (parallel/mesh.Mesh2D) with a data axis of several processes, this
    process sweeps its block of full batches (by its data index) and the
    carries are combined over the data group (``allreduce_carry``). `graph`: None (a CUDA graph of the step on a
    card, eager steps on the CPU), True (raises off a card) or False
    (eager steps, for comparisons); a failed capture raises."""
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
    if mesh is not None and mesh.size > 1:
        # batch-granular blocks keep the reference's batch boundaries: the
        # last process also takes the ragged tail
        lo = n_full * mesh.rank // mesh.size
        hi = n_full * (mesh.rank + 1) // mesh.size
        last = tail if mesh.rank == mesh.size - 1 else 0
        data = {k: np.asarray(v)[lo * B: hi * B + last]
                for k, v in data.items()}
        n_full, tail = hi - lo, last
    if tables is None:
        tables = dataset.tables.as_dict()

    from lirec_tpu_torch.models.tabular import embed_all
    from lirec_tpu_torch.ops import dispatch

    dispatch.record("eval_loop", "packed", mode, {"N": N, "batch_size": B})
    device = next(model.parameters()).device
    init_carry, step = device_sweep_builder(
        bundle, t, n_classes, n_rels, n_hashes, use_kernel=use_kernel)
    if _has_rels_table(t):
        _record_rels_fold(n_hashes + 1, B, bundle.spec.n_rels, device)
    model.eval()
    with torch.inference_mode():
        with span("lirec.eval.tables"):
            # numpy arrays or tensors (the train cadence passes its own)
            tables = {k: torch.as_tensor(tables[k], dtype=torch.float32,
                                         device=device)
                      for k in ("text", "visual", "track")}
        with span("lirec.eval.embed"):
            embedded = embed_all(model, bundle.spec, tables)
        with span("lirec.eval.localize"):
            # remapped feat_idx replaces the sweep rows (tail rows
            # untouched); per-batch unique ids ride a separate [n_full,
            # cap] tree
            loc = _maybe_localize_eval_ctx(dataset, data, embedded, B,
                                           n_full, t, use_kernel,
                                           localize_ctx)
            data = loc_apply_data(data, loc)
            loc_dev = _loc_device_tree(loc, device)
        with span("lirec.eval.stage"):
            # staged once: [n_full, B, ...], indexed per batch
            stack = {k: np.asarray(v)[: n_full * B].reshape(
                (n_full, B) + np.shape(v)[1:]) for k, v in data.items()}
        if graph and device.type != "cuda":
            raise ValueError("the eval sweep's CUDA graph needs the model "
                             "on a card; it is on %s" % device)
        use_graph = bool(n_full) and (device.type == "cuda" if graph is None
                                      else bool(graph))
        if use_graph:
            key = (bundle.apply, bundle.loss, t, n_classes, n_rels,
                   n_hashes, use_kernel, _layout(stack), _layout(loc_dev),
                   _layout(tables), _layout(embedded),
                   tuple(p.data_ptr() for p in itertools.chain(
                       model.parameters(), model.buffers())))
            captured = _GRAPHS.setdefault(model, {}).get(key)
            reason = "cuda: the graph of this key" if captured \
                else "cuda: a new graph"
        else:
            reason = ("cpu tensors" if device.type == "cpu" else
                      "no full batch" if not n_full else "asked")
        dispatch.record("eval_sweep", "graph" if use_graph else "eager",
                        reason, {"n_full": n_full, "batch_size": B})
        if use_graph:
            if captured is None:
                captured = _GRAPHS[model][key] = _EvalGraph(
                    step, init_carry, model, tables, embedded, stack,
                    loc_dev, device)
            else:
                captured.sweep(tables, embedded, stack, loc_dev)
            carry = captured.carry
            tables, embedded = captured.tables, captured.embedded
        else:
            with span("lirec.eval.stage"):
                data_dev = {k: torch.as_tensor(v).to(device)
                            for k, v in stack.items()}
            with span("lirec.eval.zero"):
                carry = init_carry(device)
            with span("lirec.eval.replays"):
                for i in range(n_full):
                    batch = inject_loc({k: v[i] for k, v in
                                        data_dev.items()}, loc_dev, i)
                    step(model, tables, embedded, carry, batch)
        if tail:
            with span("lirec.eval.tail"):
                tail_batch = {
                    k: torch.as_tensor(np.asarray(v)[n_full * B:]).to(device)
                    for k, v in data.items()
                }
                carry = step(model, tables, embedded, carry, tail_batch)
    with span("lirec.eval.fetch"):
        carry = {k: v.cpu().numpy() for k, v in carry.items()}
        if mesh is not None:
            carry = allreduce_carry(carry, mesh)
    return carry


# model -> {key: _EvalGraph}: a model's graphs go with it
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _layout(tree):
    """The shapes and dtypes of a tree of tensors or arrays (dicts, tuples
    and named tuples), as a key."""
    if isinstance(tree, dict):
        return tuple((k, _layout(tree[k])) for k in sorted(tree))
    if isinstance(tree, tuple):
        return (type(tree).__name__,) + tuple(_layout(v) for v in tree)
    return (tuple(tree.shape), str(tree.dtype))


def _copy_into(static, tree):
    """Copy a tree of tensors or arrays into the same-shaped tree of
    device tensors `static`."""
    if isinstance(static, dict):
        for k in static:
            _copy_into(static[k], tree[k])
    elif isinstance(static, tuple):
        for s_, v in zip(static, tree):
            _copy_into(s_, v)
    else:
        static.copy_(torch.as_tensor(tree))


class _EvalGraph:
    """The eval step of one key of shapes, dtype and localisation tier as a
    CUDA graph, with the static tensors it reads and writes: the staged
    ``[n_full, B, ...]`` stack, the loc tree, the tables and their
    embeddings, the carry and the step index. Made by a sweep (batch 0
    eagerly as the warm-up, the capture, n_full - 1 replays); each later
    sweep of the key copies its inputs into the static tensors, zeroes the
    carry and replays n_full times. The model's parameters are read where
    they are (the key holds their addresses), so a trained or reloaded
    model sweeps with its current weights."""

    def __init__(self, step, init_carry, model, tables, embedded, stack,
                 loc_dev, device):
        self.tables, self.embedded = tables, embedded
        with span("lirec.eval.stage"):
            self.stack = {k: torch.as_tensor(v).to(device)
                          for k, v in stack.items()}
        self.loc = loc_dev
        with span("lirec.eval.zero"):
            self.carry = init_carry(device)
            self.index = torch.zeros(1, dtype=torch.int64, device=device)
        gen = step.loss_generator(device)
        self.generators = [gen] if gen is not None else []
        self.n_full = len(stack["labels"])

        def one():
            batch = inject_loc({k: _at(v, self.index)
                                for k, v in self.stack.items()},
                               self.loc, self.index)
            step(model, self.tables, self.embedded, self.carry, batch)
            self.index.add_(1)

        with span("lirec.eval.replays"):
            self._seed()
            self.graph = StepGraph(one, device, self.generators)
            for _ in range(self.n_full - 1):
                self._seed()
                self.graph.replay()

    def _seed(self):
        for g in self.generators:
            g.manual_seed(0)

    def sweep(self, tables, embedded, stack, loc_dev) -> None:
        """The full batches of `stack` (the shapes of the first sweep's)
        into a zeroed carry."""
        with span("lirec.eval.stage"):
            _copy_into(self.tables, tables)
            _copy_into(self.embedded, embedded)
            _copy_into(self.stack, stack)
            _copy_into(self.loc, loc_dev)
        with span("lirec.eval.zero"):
            for v in self.carry.values():
                v.zero_()
            self.index.zero_()
        with span("lirec.eval.replays"):
            for _ in range(self.n_full):
                self._seed()
                self.graph.replay()


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
    mesh=None,
    graph: Optional[bool] = None,
) -> Dict[str, float]:
    """Evaluation of a whole split on ``model``'s device; returns the same
    metric dict (and prints the same lines) as the JAX package's
    evaluate_packed. With a `mesh` of several processes
    (parallel/mesh.Mesh2D), every process calls it; each sweeps its
    block of batches (``sweep_carry``) and all return the global
    metrics. `graph`: as ``sweep_carry``'s."""
    carry = sweep_carry(dataset, bundle, model, cfg, mode=mode,
                        tables=tables, data=data, batch_size=batch_size,
                        use_kernel=use_kernel, localize_ctx=localize_ctx,
                        mesh=mesh, graph=graph)
    n_hashes = len(getattr(dataset, "hashidx_rels", ()) or ())
    with span("lirec.eval.finish"):
        return finish_from_carry(carry, cfg.tasks, dataset.n_rels, n_hashes,
                                 mode, verbose)


def finish_from_carry(
    carry, t, n_rels: int, n_hashes: int, mode: str, verbose: bool
) -> Dict[str, float]:
    """Host finish of the sweep: fill the accumulators from the fetched
    counters and emit the metric dict (divisions, and RelationshipsAcc's
    ranking of the seen hashes inside the span ``lirec.eval.rels_finish``).
    The ranking is ``RelationshipsAcc._compute`` in one pass: an argsort of
    the seen rows along their last axis sorts each row as the 1-D argsort
    of that row alone does, ties included, so ``total``, ``_top1``,
    ``_top3`` and ``conf_mat`` are the counts ``_compute`` makes (its
    per-hash dicts stay empty: nothing reads them on this path)."""
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
        from lirec_tpu_torch.ops import dispatch

        with span("lirec.eval.rels_finish"):
            seen = np.nonzero(carry["rels_seen"][:n_hashes])[0]
            rows = carry["rels_table"][seen]
            dispatch.record("eval_rels_finish", "one_pass", "host carry",
                            {"hashes": len(seen), "width": rows.shape[1]})
            order = np.argsort(-rows, axis=1)
            gt = carry["rels_gt"][seen]
            prec_rels = RelationshipsAcc(n_rels=n_rels)
            prec_rels.total = len(seen)
            prec_rels._top1 = int((order[:, 0] == gt).sum())
            prec_rels._top3 = int((order[:, :3] == gt[:, None]).any(1).sum())
            np.add.at(prec_rels.conf_mat, (gt, order[:, 0]), 1)
            prec_rels.top1()  # no hash seen: raises before a line prints

    n_batches = int(carry["n_batches"])
    avg_loss = float(carry["loss_sum"]) / n_batches if n_batches else 0.0
    return summarize_metrics(t, prec, prec_rels, avg_loss, mode, verbose)
