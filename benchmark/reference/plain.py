"""Plain float32 reference of the mid-fusion grounding models (int_rel_ch,
int_ch): the forward, the weak grounding losses, the eval sweep's
counters and one Adam step, in plain PyTorch. It imports nothing of the
program: it follows the published model (Kukleva, Tapaswi, Laptev,
"Learning Interactions and Relationships between Movie Characters",
CVPR 2020, arXiv:2003.13158, and its released code's mlp/model.py), with
the parameter names of the released checkpoints.

Per hypothesis row of a sample: each modality's two-layer MLP
(linear -> dropout -> relu -> linear) over the row's [text | visual |
track1 | track2] features, concatenated (3 * joint wide), tanh, dropout.
The context branch runs the same MLPs (its own weights) over each of the
R context clips and takes their masked mean (an empty context divides by
1). The gate: relu(linear(cat(context, interaction))), dropout. Heads:
out_ints (interactions), out_ctx (relationships).

Everything is float32 with TF32 off. ``quant`` (a function applied to
both inputs of every product) puts a lower precision in: the control.
Dropout masks are drawn as uniform floats from a caller's
``torch.Generator`` in the forward's order (interaction branch text,
visual, track1, track2, its output; the context branch the same; the
gate), one draw per mask at the masked tensor's shape, and an element is
kept where its draw is below 1 - p.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["param_shapes", "fp8_quant", "bf16_quant", "no_tf32",
           "forward_rows", "embed_tables", "forward_eval", "selection_scores",
           "grounding_loss", "counters", "adam_step", "near_ties",
           "train_steps"]

BRANCHES = ("txt", "vis", "tracks1", "tracks2")
SECOND = {"txt": "txt2", "vis": "vis2", "tracks1": "tracks12",
          "tracks2": "tracks22"}
NEG_INF = float("-inf")


def param_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of the configuration's model, in
    the released checkpoints' names (weight [out, in], bias [out])."""
    j, jh = cfg["joint_dim"], cfg["joint_dim"] // 2
    layers = []
    prefixes = ["ints"] + (["ctx"] if cfg["ctx"] else [])
    for p in prefixes:
        layers += [("txt_%s" % p, j, cfg["text_dim"]), ("txt2_%s" % p, j, j),
                   ("vis_%s" % p, j, cfg["visual_dim"]), ("vis2_%s" % p, j, j),
                   ("tracks1_%s" % p, j, cfg["track_dim"]),
                   ("tracks2_%s" % p, j, cfg["track_dim"]),
                   ("tracks12_%s" % p, jh, j), ("tracks22_%s" % p, jh, j)]
    head_in = 3 * j
    if cfg["gates"]:
        gate_out = j * cfg["mid_m_ints"]
        layers.append(("gates_ints.fc_out", gate_out, 6 * j))
        head_in = gate_out
    layers.append(("out_ints", cfg["n_classes"], head_in))
    if cfg["ctx"]:
        layers.append(("out_ctx", cfg["n_rels"], 3 * j))
    out = []
    for name, o, i in layers:
        out += [(name + ".weight", (o, i)), (name + ".bias", (o,))]
    return out


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale per tensor (its largest
    magnitude to e4m3's 448), as float32. The gradient passes through as
    float32 (the products of the backward take the rounded operands
    saved by the forward, and float32 gradients)."""
    with torch.no_grad():
        scale = 448.0 / x.abs().amax().clamp(min=1e-30)
        q = (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x).detach()


def bf16_quant(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, as float32 (the gradient passes through)."""
    return x + (x.detach().to(torch.bfloat16).float() - x.detach())


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matmuls and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _linear(params, name, x, quant):
    w = params[name + ".weight"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return x @ w.t() + params[name + ".bias"]


class _Drop:
    """Dropout masks drawn in call order from one generator (None: off)."""

    def __init__(self, p: float, generator: Optional[torch.Generator]):
        self.p, self.generator = p, generator

    def __call__(self, x):
        if self.generator is None or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


def embed_rows(params, prefix: str, rows: Dict[str, torch.Tensor],
               drop: _Drop, quant=None) -> torch.Tensor:
    """The four modality MLPs of a branch over raw rows {"txt": [..., text],
    "vis", "tracks1", "tracks2"}, concatenated [..., 3 * joint]."""
    parts = []
    for b in BRANCHES:
        h = _linear(params, "%s_%s" % (b, prefix), rows[b], quant)
        h = torch.relu(drop(h))
        parts.append(_linear(params, "%s_%s" % (SECOND[b], prefix), h,
                             quant))
    return torch.cat(parts, dim=-1)


def _rows(tables, idx):
    """Raw feature rows of index triples idx[..., 3] (clip, track, track)."""
    idx = idx.long()
    return {"txt": tables["text"][idx[..., 0]],
            "vis": tables["visual"][idx[..., 0]],
            "tracks1": tables["track"][idx[..., 1]],
            "tracks2": tables["track"][idx[..., 2]]}


def _heads(params, cfg, out_ints, out_ctx, drop, quant, B, T):
    """The gate (where the model has one) and the two heads, from the
    branches' outputs (after their tanh and dropout)."""
    if cfg["gates"]:
        fused = torch.cat([out_ctx, out_ints], dim=-1)
        out_ints = drop(torch.relu(_linear(params, "gates_ints.fc_out",
                                           fused, quant)))
    res = {"inters": _linear(params, "out_ints", out_ints, quant).reshape(
        B, T, cfg["n_classes"]), "rels": None}
    if cfg["ctx"]:
        res["rels"] = _linear(params, "out_ctx", out_ctx, quant).reshape(
            B, T, cfg["n_rels"])
    return res


def _masked_mean(e, mask):
    """e [N, R, D], mask [N, R] -> [N, D]; an empty context divides by 1."""
    m = mask.float()
    msum = m.sum(dim=1, keepdim=True)
    return (e * m[..., None]).sum(dim=1) / torch.where(
        msum == 0, torch.ones_like(msum), msum)


def forward_rows(params, cfg, tables, feat_idx, rels_mask=None,
                 generator: Optional[torch.Generator] = None,
                 quant=None) -> Dict[str, Optional[torch.Tensor]]:
    """The training forward of a batch, each hypothesis and context clip
    embedded from its raw rows; dropout from `generator` (None: off).
    feat_idx [B, T, 1 + R, 3] (or [B, T, 1, 3] without context)."""
    B, T = feat_idx.shape[:2]
    drop = _Drop(cfg["dropout"], generator)
    ints = embed_rows(params, "ints", _rows(
        tables, feat_idx[:, :, 0].reshape(B * T, 3)), drop, quant)
    out_ints, out_ctx = drop(torch.tanh(ints)), None
    if cfg["ctx"]:
        R = feat_idx.shape[2] - 1
        e = embed_rows(params, "ctx", _rows(
            tables, feat_idx[:, :, 1:].reshape(B * T, R, 3)), drop, quant)
        out_ctx = drop(torch.tanh(_masked_mean(
            e, rels_mask.reshape(B * T, R))))
    return _heads(params, cfg, out_ints, out_ctx, drop, quant, B, T)


def embed_tables(params, cfg, tables, quant=None) -> Dict[str, Dict]:
    """Each branch's MLPs over every table row (no dropout: eval), for
    ``forward_eval``: {prefix: {"txt": [n_clips, j], "vis", "tracks1",
    "tracks2"}}. The same rows as ``forward_rows`` embeds, computed once
    per table row."""
    out = {}
    src = {"txt": "text", "vis": "visual", "tracks1": "track",
           "tracks2": "track"}
    for prefix in ["ints"] + (["ctx"] if cfg["ctx"] else []):
        out[prefix] = {}
        for b in BRANCHES:
            h = torch.relu(_linear(params, "%s_%s" % (b, prefix),
                                   tables[src[b]], quant))
            out[prefix][b] = _linear(params, "%s_%s" % (SECOND[b], prefix),
                                     h, quant)
    return out


def _gather_embedded(emb, idx):
    idx = idx.long()
    return torch.cat([emb["txt"][idx[..., 0]], emb["vis"][idx[..., 0]],
                      emb["tracks1"][idx[..., 1]],
                      emb["tracks2"][idx[..., 2]]], dim=-1)


def forward_eval(params, cfg, embedded, feat_idx, rels_mask=None,
                 quant=None) -> Dict[str, Optional[torch.Tensor]]:
    """The eval forward (no dropout) of a batch from ``embed_tables``."""
    B, T = feat_idx.shape[:2]
    out_ints = torch.tanh(_gather_embedded(
        embedded["ints"], feat_idx[:, :, 0].reshape(B * T, 3)))
    out_ctx = None
    if cfg["ctx"]:
        R = feat_idx.shape[2] - 1
        e = _gather_embedded(embedded["ctx"], feat_idx[:, :, 1:].reshape(
            B * T, R, 3))
        out_ctx = torch.tanh(_masked_mean(e, rels_mask.reshape(B * T, R)))
    return _heads(params, cfg, out_ints, out_ctx, _Drop(0.0, None), quant,
                  B, T)


def _pick(x, idx, dim):
    """x's element at idx along dim (idx has x's shape without dim)."""
    return torch.gather(x, dim, idx.long().unsqueeze(dim)).squeeze(dim)


def _pair_margin(scores, pos, neg_mask, margin):
    """Per sample: the sum over masked negatives of relu(margin - pos +
    score)."""
    n = scores.shape[0]
    terms = torch.relu(margin - pos[:, None] + (scores * neg_mask).reshape(
        n, -1)) * neg_mask.reshape(n, -1)
    return terms.sum(dim=1)


def _one_hot(idx, n):
    return (idx.long()[..., None] == torch.arange(n, device=idx.device)
            ).float()


def _loss_parts(out, batch, cfg):
    """What the weak grounding loss is made of: per sample and hypothesis
    the positive scores of the GT class (and GT relationship), the score
    the positive hypothesis is chosen by, and the masked negatives."""
    ints = out["inters"].float()
    B, T, C = ints.shape
    target = batch["labels"].reshape(-1).long()
    mem = batch["mem_mask"].float()
    valid = mem > 0
    ints = torch.where(valid[..., None], ints, NEG_INF)
    parts = {"ints": (torch.sigmoid(ints), valid[..., None].float()
                      * batch["multilab_weights"].float()[:, None, :]
                      * (1.0 - _one_hot(target, C))[:, None, :]),
             "col_ints": torch.sigmoid(_pick(ints, target[:, None].expand(
                 B, T), 2))}
    parts["select"] = parts["col_ints"] * mem
    if not cfg["ctx"]:
        return parts
    NR = out["rels"].shape[-1]
    target_rels = batch["rels_label"].long()
    gt = batch["gt_tracks"].long()
    rel_ok = valid & (target_rels != NR)
    rels_p = torch.cat([out["rels"].float(),
                        torch.zeros(B, T, 1, device=ints.device)], -1)
    ok_p = torch.cat([rel_ok[..., None].expand(B, T, NR),
                      torch.zeros(B, T, 1, dtype=torch.bool,
                                  device=ints.device)], -1)
    rels_p = torch.where(ok_p, rels_p, NEG_INF)
    rel_gt0 = _pick(target_rels, gt[:, 0], 1)
    rel_gt1 = _pick(target_rels, gt[:, 1], 1)
    gt_rel = (_one_hot(rel_gt0, NR + 1) + _one_hot(rel_gt1, NR + 1)).clamp(
        max=1.0)
    parts["rels"] = (torch.sigmoid(rels_p),
                     ok_p.float() * (1.0 - gt_rel[:, None, :]))
    parts["col_rels"] = torch.sigmoid(_pick(rels_p, rel_gt0[:, None].expand(
        B, T), 2))
    parts["select"] = (parts["col_ints"] + parts["col_rels"]) * mem
    return parts


def selection_scores(out, batch, cfg) -> torch.Tensor:
    """[B, T]: the score by which the weak loss chooses each sample's
    positive hypothesis (its argmax)."""
    return _loss_parts(out, batch, cfg)["select"]


def grounding_loss(out, batch, cfg, best=None) -> torch.Tensor:
    """The weak grounding loss (MarginTrackRelsLoss with context,
    MarginLoss without): each sample's positive hypothesis is the argmax of
    ``selection_scores`` (or `best`, [B], where given), a mean over the
    rows whose ``loss_weight`` is 1 (all rows without one)."""
    margin = cfg["tr_margin"]
    p = _loss_parts(out, batch, cfg)
    B = p["select"].shape[0]
    if best is None:
        best = torch.argmax(p["select"], dim=1)
    w = batch.get("loss_weight")
    w = torch.ones(B, device=best.device) if w is None else w.float()

    def mean(scores, neg, col):
        per = _pair_margin(scores, _pick(col, best, 1), neg, margin)
        return (per * w).sum() / w.sum().clamp(min=1.0)

    loss = mean(*p["ints"], p["col_ints"])
    if not cfg["ctx"]:
        return loss
    return cfg["lymbda"] * loss + mean(*p["rels"], p["col_rels"])


def counters(out, batch, cfg) -> Dict[str, int]:
    """The grounding counters of one batch (the sweep's top-1 counts: ref
    utils/evaluation.py update_probs_max_tracks[_rels]), as ints."""
    ints = out["inters"].float()
    B, T, C = ints.shape
    dev = ints.device
    valid = batch["mem_mask"].float()[..., None] > 0
    s_cl = torch.sigmoid(torch.where(valid, ints, NEG_INF))
    gt_cls = batch["labels"].reshape(-1).long()
    rows = torch.arange(B, device=dev)
    g0, g1 = batch["gt_tracks"][:, 0].long(), batch["gt_tracks"][:, 1].long()
    has2 = g1 != 0
    nz = ~batch["just_zeros"].bool()
    cls_argmax = s_cl.argmax(dim=2)
    s_gt = s_cl[rows, :, gt_cls]                                # [B, T]
    max_c = s_cl.max(dim=2).values
    res = {}
    if cfg["ctx"]:
        rl = torch.where(valid, out["rels"].float(), NEG_INF)
        s_rlp = torch.cat([torch.sigmoid(rl), torch.zeros(B, T, 1,
                                                          device=dev)], 2)
        gt_rels = batch["rels_label"].long()
        rel0 = gt_rels[:, 0]
        pr_track = (s_gt + s_rlp[rows, :, rel0]).argmax(dim=1)
        t_star = (max_c + s_rlp.max(dim=2).values).argmax(dim=1)
        r_star = s_rlp[rows, t_star].argmax(dim=1)
        rels_argmax = rl.argmax(dim=2)
        rvalid = rel0 != cfg["n_rels"]
        p0, p1 = rels_argmax[rows, g0], rels_argmax[rows, g1]
        r0 = p0 == gt_rels[rows, g0]
        res["total_rels"] = int(rvalid.sum())
        res["rels_top1"] = int((rvalid & r0).sum()
                               + (rvalid & ~r0 & (p1 == gt_rels[rows, g1]))
                               .sum())
    else:
        pr_track = s_gt.argmax(dim=1)
        t_star = max_c.argmax(dim=1)
    c_star = s_cl[rows, t_star].argmax(dim=1)
    l0, l1 = cls_argmax[rows, g0], cls_argmax[rows, g1]
    c0 = l0 == gt_cls
    hit0 = pr_track == g0
    hit1 = has2 & ~hit0 & (pr_track == g1)
    jmatch = c_star == gt_cls
    if cfg["ctx"]:
        jmatch = jmatch & (r_star == rel0)
    joint0 = jmatch & (t_star == g0)
    joint1 = has2 & ~hit0 & jmatch & (t_star == g1)
    res.update(total=int(nz.sum()), total_cl=B,
               cls_top1=int(c0.sum() + (~c0 & (l1 == gt_cls)).sum()),
               trks_top1=int((nz & hit0).sum() + (nz & hit1).sum()),
               top1=int((nz & joint0).sum() + (nz & joint1).sum()))
    return res


def adam_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: Dict, lr: float, weight_decay: float,
              betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One step of Adam with L2 weight decay (torch.optim.Adam's
    arithmetic), in place on `params`; `state` holds the moments and the
    step count (empty before the first step)."""
    b1, b2 = betas
    t = state["t"] = state.get("t", 0) + 1
    m, v = state.setdefault("m", {}), state.setdefault("v", {})
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name] + weight_decay * p
            m[name] = b1 * m.get(name, torch.zeros_like(p)) + (1 - b1) * g
            v[name] = b2 * v.get(name, torch.zeros_like(p)) + (1 - b2) * g * g
            denom = v[name].sqrt() / math.sqrt(1 - b2 ** t) + eps
            p -= (lr / (1 - b1 ** t)) * m[name] / denom


def near_ties(scores: torch.Tensor, window: float, most: int):
    """The samples whose best and second-best scores lie within `window`
    (at most `most`, the nearest first), each with its best and its
    second-best hypothesis: [(sample, best, second)]."""
    best = scores.argmax(dim=1)
    rows = torch.arange(scores.shape[0], device=scores.device)
    rest = scores.clone()
    rest[rows, best] = NEG_INF
    second = rest.argmax(dim=1)
    gap = scores[rows, best] - rest[rows, second]
    order = torch.argsort(gap)
    return [(int(i), int(best[i]), int(second[i])) for i in order[:most]
            if float(gap[i]) < window]


def _flipped(scores: torch.Tensor, within: float) -> torch.Tensor:
    """[B]: each sample's best hypothesis, or its second-best where the
    best wins by less than `within`."""
    top = scores.topk(2, dim=1)
    gap = top.values[:, 0] - top.values[:, 1]
    return torch.where(gap < within, top.indices[:, 1], top.indices[:, 0])


def train_steps(params0: Dict[str, torch.Tensor], cfg, tables,
                batches: List[Dict], generators: List[torch.Generator],
                quant: Optional[Callable] = None, tie_window: float = 0.0,
                most_ties: int = 10, flip_within: float = 0.0):
    """Steps of the training forward, loss, backward and Adam from
    `params0` over `batches` (device tensors), step i drawing its dropout
    masks from generators[i]. Returns {"losses", "first": the first step's
    gradients with the weight decay term, as Adam takes them, "after": the
    parameters after the last step, "ties": for each sample of the first
    step whose positive hypothesis is chosen by less than `tie_window`,
    how the first gradient changes where the second-best is chosen}.
    `flip_within` (a fault's reading): in every step, each sample whose
    positive wins by less than this takes its second-best."""
    params = {k: v.detach().clone() for k, v in params0.items()}
    state: Dict = {}
    losses, first, ties = [], None, []
    with no_tf32():
        for batch, gen in zip(batches, generators):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            out = forward_rows(leaves, cfg, tables, batch["feat_idx"],
                               batch.get("rels_mask"), gen, quant)
            loss = grounding_loss(out, batch, cfg, best=_flipped(
                selection_scores(out, batch, cfg).detach(), flip_within)
                if flip_within else None)
            near = [] if first is not None or flip_within else near_ties(
                selection_scores(out, batch, cfg).detach(), tie_window,
                most_ties)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()), retain_graph=bool(near))))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: grads[k] + cfg["weight_decay"] * params[k]
                         for k in params}
                best = selection_scores(out, batch, cfg).argmax(dim=1)
                for n, (i, _, second) in enumerate(near):
                    alt = best.clone()
                    alt[i] = second
                    other = torch.autograd.grad(
                        grounding_loss(out, batch, cfg, best=alt),
                        list(leaves.values()),
                        retain_graph=n + 1 < len(near))
                    ties.append({k: o - grads[k]
                                 for k, o in zip(leaves, other)})
            adam_step(params, grads, state, cfg["lr"], cfg["weight_decay"])
            del leaves, out, loss, grads
    return {"losses": losses, "first": first, "after": params, "ties": ties}
