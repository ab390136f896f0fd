"""Hybrid packed forward for training: table-level first layers, per-use
second layers (counterpart of lirec_tpu/models/hybrid.py).

The reference applies dropout AFTER each modality MLP's first linear
(``linear1 -> dropout -> relu -> linear2``, ref mlp/model.py:154-167), so
the first-layer GEMMs over the 768/2048-wide raw features run once per
table row (``project_tables``) and their outputs are gathered per (sample,
hypothesis, clip), even in training. In the ctx branch the second layers
also move after the masked mean over the clip axis, with the bias scaled
by mask_sum / divider: linear2 commutes with the pool, so its GEMMs run on
[N, joint] pooled rows instead of [N * R, joint] (``_pooled_ctx_from_h1``).

The ctx branch's gathers go through ``ops/scatter_accum.gather_h1``, whose
backward is the CUDA scatter-accumulate kernel. The ints branch gathers
with plain indexing, whose backward stays torch's own (the JAX package has
no kernel there either).

Dropout calls keep the JAX package's order and shapes (txt, vis, tr1, tr2
per branch, then the branch output, then the gate), so a forward draws the
same number of masks in the same order.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from lirec_tpu_torch.models.blocks import gate_apply
from lirec_tpu_torch.models.layers import (
    DropoutRng,
    compute_dtype,
    dropout,
    linear,
)
from lirec_tpu_torch.ops.scatter_accum import gather_h1

__all__ = [
    "H1Tables",
    "project_tables",
    "midfusion_hybrid",
    "midfusion_maxtracks_hybrid",
    "modalities_hybrid",
]


class H1Tables(NamedTuple):
    """First-layer activations of the feature tables, per branch. txt and
    vis are indexed by the same clip id, so they are stored concatenated
    (one gather, one backward scatter). Stored bf16 under bf16 compute."""

    clip: torch.Tensor  # [n_clips, 2*joint] = [txt | vis]
    tr1: torch.Tensor  # [n_tracks, joint]
    tr2: torch.Tensor  # [n_tracks, joint]


def project_tables(model, prefix: str, tables: Dict, spec) -> H1Tables:
    cdt = compute_dtype(spec)

    def act(h):
        return h if cdt is None else h.to(cdt)

    def first(name, x):
        return linear(model.get_submodule(name % prefix), x, cdt)

    return H1Tables(
        clip=act(torch.cat([first("txt_%s", tables["text"]),
                            first("vis_%s", tables["visual"])], dim=-1)),
        tr1=act(first("tracks1_%s", tables["track"])),
        tr2=act(first("tracks2_%s", tables["track"])),
    )


def _embed_from_h1(model, prefix: str, h1: H1Tables, idx: torch.Tensor,
                   spec, rng: DropoutRng, deterministic: bool) -> torch.Tensor:
    """Gather first-layer rows for idx[..., 3], then dropout -> relu ->
    second layers, concatenated [txt | vis | tr1 | tr2]."""
    p = spec.dropout
    cdt = compute_dtype(spec)
    joint = spec.joint_dim

    def second(name, h):
        h = torch.relu(dropout(h, p, rng, deterministic))
        return linear(model.get_submodule(name % prefix), h, cdt)

    idx = idx.long()
    clip = h1.clip[idx[..., 0]]
    txt = second("txt2_%s", clip[..., :joint])
    vis = second("vis2_%s", clip[..., joint:])
    tr1 = second("tracks12_%s", h1.tr1[idx[..., 1]])
    tr2 = second("tracks22_%s", h1.tr2[idx[..., 2]])
    return torch.cat([txt, vis, tr1, tr2], dim=-1)


def _pooled_ctx_from_h1(model, prefix: str, h1: H1Tables, idx: torch.Tensor,
                        mask: torch.Tensor, spec, rng: DropoutRng,
                        deterministic: bool, guard_zero_divide: bool,
                        use_kernel: bool = True) -> torch.Tensor:
    """ctx branch with the second layers applied after the masked mean.

    idx [N, R, 3], mask [N, R] -> [N, 3 * joint]. The pool sums the
    relu(dropout) activations in f32 (bf16 values times 0/1 weights are
    exact in f32, as in the JAX package's f32-accumulating einsum); the
    second layer's bias is scaled by msum / divider (1 for a non-empty
    context, 0 for an empty guarded one, NaN for an empty unguarded one).
    use_kernel=False takes the plain scatter in the gathers' backward.
    """
    p = spec.dropout
    cdt = compute_dtype(spec)
    joint = spec.joint_dim

    m = mask.float()                                   # [N, R]
    msum = m.sum(dim=1, keepdim=True)                  # [N, 1]
    divider = (torch.where(msum == 0, torch.ones_like(msum), msum)
               if guard_zero_divide else msum)
    bias_scale = msum / divider                        # [N, 1]

    def pooled(h):
        h = torch.relu(dropout(h, p, rng, deterministic))
        return torch.einsum("nrj,nr->nj", h.float(), m) / divider

    def second(name, ph):
        layer = model.get_submodule(name % prefix)
        w = layer.weight
        if cdt is not None:
            ph = ph.to(cdt).float()
            w = w.to(cdt).float()
        return ph @ w.t() + layer.bias * bias_scale

    clip, g_tr1, g_tr2 = gather_h1(h1.clip, h1.tr1, h1.tr2, idx,
                                   use_kernel=use_kernel)
    txt = second("txt2_%s", pooled(clip[..., :joint]))
    vis = second("vis2_%s", pooled(clip[..., joint:]))
    tr1 = second("tracks12_%s", pooled(g_tr1))
    tr2 = second("tracks22_%s", pooled(g_tr2))
    return torch.cat([txt, vis, tr1, tr2], dim=-1)


def midfusion_maxtracks_hybrid(
    model,
    spec,
    tables: Dict,
    feat_idx: torch.Tensor,
    rels_mask: Optional[torch.Tensor] = None,
    deterministic: bool = False,
    rng: Optional[torch.Generator] = None,
    use_kernel: bool = True,
) -> Dict[str, Optional[torch.Tensor]]:
    """MidFusionMultiClipMaxTracks over packed batches, hybrid layering.

    feat_idx: [B, T, 1+R, 3] (ctx on) or [B, T, 1, 3]; rels_mask [B, T, R];
    rng: the dropout stream's generator (on the tables' device).
    """
    cdt = compute_dtype(spec)
    drop = DropoutRng(rng)
    B, T = feat_idx.shape[0], feat_idx.shape[1]
    output_ints = output_ctx = None
    if spec.ints:
        h1 = project_tables(model, "ints", tables, spec)
        ints_repr = _embed_from_h1(
            model, "ints", h1, feat_idx[:, :, 0, :].reshape(B * T, 3), spec,
            drop, deterministic,
        )
        output_ints = dropout(torch.tanh(ints_repr), spec.dropout, drop,
                              deterministic)
    if spec.ctx:
        h1c = project_tables(model, "ctx", tables, spec)
        R = feat_idx.shape[2] - 1
        pooled = _pooled_ctx_from_h1(
            model, "ctx", h1c, feat_idx[:, :, 1:, :].reshape(B * T, R, 3),
            rels_mask.reshape(B * T, R), spec, drop, deterministic,
            guard_zero_divide=True, use_kernel=use_kernel,
        )
        output_ctx = dropout(torch.tanh(pooled), spec.dropout, drop,
                             deterministic)
    if spec.gates:
        output_ints = gate_apply(model, output_ints, output_ctx, spec, drop,
                                 deterministic)
    rels_out = ints_out = None
    if spec.ctx:
        rels_out = linear(model.out_ctx, output_ctx, cdt).reshape(
            B, T, spec.n_rels)
    if spec.ints:
        ints_out = linear(model.out_ints, output_ints, cdt).reshape(
            B, T, spec.n_classes)
    return {"inters": ints_out, "rels": rels_out}


def midfusion_hybrid(
    model,
    spec,
    tables: Dict,
    feat_idx: torch.Tensor,
    rels_mask: Optional[torch.Tensor] = None,
    deterministic: bool = False,
    rng: Optional[torch.Generator] = None,
    use_kernel: bool = True,
) -> Dict[str, Optional[torch.Tensor]]:
    """MidFusionMultiClip over packed batches, hybrid layering.

    feat_idx: [B, 1+R, 3]; rels_mask: [B, R] or [B, R, 1]. An empty context
    gives NaN relationship logits, as in the reference (no zero guard).
    """
    cdt = compute_dtype(spec)
    drop = DropoutRng(rng)
    B = feat_idx.shape[0]
    output_ints = output_ctx = None
    if spec.ints:
        h1 = project_tables(model, "ints", tables, spec)
        ints_repr = _embed_from_h1(model, "ints", h1, feat_idx[:, 0, :],
                                   spec, drop, deterministic)
        output_ints = dropout(torch.tanh(ints_repr), spec.dropout, drop,
                              deterministic)
    if spec.ctx:
        h1c = project_tables(model, "ctx", tables, spec)
        R = feat_idx.shape[1] - 1
        pooled = _pooled_ctx_from_h1(
            model, "ctx", h1c, feat_idx[:, 1:, :], rels_mask.reshape(B, R),
            spec, drop, deterministic, guard_zero_divide=False,
            use_kernel=use_kernel,
        )
        output_ctx = dropout(torch.tanh(pooled), spec.dropout, drop,
                             deterministic)
    if spec.gates:
        output_ints = gate_apply(model, output_ints, output_ctx, spec, drop,
                                 deterministic)
    rels_out = linear(model.out_ctx, output_ctx, cdt) if spec.ctx else None
    ints_out = linear(model.out_ints, output_ints, cdt) if spec.ints else None
    return {"inters": ints_out, "rels": rels_out}


def modalities_hybrid(
    model,
    spec,
    tables: Dict,
    feat_idx: torch.Tensor,
    deterministic: bool = False,
    rng: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Modalities over packed batches, hybrid layering. feat_idx [B, 1, 3]
    or [B, 3] -> {"inters": [B, n_classes]}.

    Each branch's first layer runs over its table, its rows are gathered
    by plain indexing (the JAX package's gather is plain XLA indexing
    too), then dropout -> relu -> the second layer. With tracks on, the
    track branches run under every modality, as in the JAX package, so the
    dropout calls keep its order (txt, vis, tr1, tr2, the output)."""
    cdt = compute_dtype(spec)
    drop = DropoutRng(rng)
    p = spec.dropout
    if feat_idx.dim() == 3:
        feat_idx = feat_idx[:, 0, :]
    idx = feat_idx.long()

    def branch(n1, n2, table, which):
        h = linear(model.get_submodule(n1), table, cdt)[idx[..., which]]
        h = torch.relu(dropout(h, p, drop, deterministic))
        return linear(model.get_submodule(n2), h, cdt)

    parts = []
    if spec.modality in ("m", "t"):
        parts.append(branch("txt_ints", "txt2_ints", tables["text"], 0))
    if spec.modality in ("m", "v"):
        parts.append(branch("vis_ints", "vis2_ints", tables["visual"], 0))
    if spec.tracks:
        tr1 = branch("tracks1_ints", "tracks12_ints", tables["track"], 1)
        tr2 = branch("tracks2_ints", "tracks22_ints", tables["track"], 2)
        if spec.modality == "m":
            parts += [tr1, tr2]
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    out = dropout(torch.tanh(out), p, drop, deterministic)
    return {"inters": linear(model.out_ints, out, cdt)}
