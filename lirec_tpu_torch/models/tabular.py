"""Embed-then-gather eval forwards (counterpart of lirec_tpu/models/tabular.py).

At eval (no dropout) the per-modality MLPs run ONCE per feature-table row,
and the per-(sample, hypothesis, clip) work reduces to row gathers, the
fused context pool (ops/gather_pool.fused_ctx_pool, a CUDA kernel on the
GPU), the gate and the heads. This is exact: tanh and the masked mean are
elementwise or linear and commute with the concatenation.

Table dtype: the ctx tables are stored bfloat16 when the spec computes in
bfloat16 and float32 otherwise, on every device. The pool accumulates in
float32 either way. (The JAX package decided this from TPU VMEM budgets and
stored bf16 as packed int32 words; neither applies to a GPU.)
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from lirec_tpu_torch.models.blocks import gate_apply
from lirec_tpu_torch.models.layers import compute_dtype, linear
from lirec_tpu_torch.ops.gather_pool import (
    fused_ctx_pool,
    fused_ctx_pool_reference,
    fused_ctx_pool_triple,
    fused_ctx_pool_triple_reference,
)

__all__ = [
    "EmbeddedTables",
    "embed_tables",
    "embed_all",
    "embed_modalities",
    "ctx_table_dtype",
    "midfusion_maxtracks_tabular",
    "midfusion_tabular",
    "modalities_tabular",
]


class EmbeddedTables(NamedTuple):
    # txt and vis are indexed by the SAME clip id, so their embeddings are
    # stored pre-concatenated: one wide gather instead of two
    clip: torch.Tensor  # [n_clips, 2*joint] = [txt | vis]
    tr1: torch.Tensor  # [n_tracks, joint//2]
    tr2: torch.Tensor  # [n_tracks, joint//2]


def _two_layer(model, n1, n2, x, cdt):
    h = linear(model.get_submodule(n1), x, cdt)
    return linear(model.get_submodule(n2), torch.relu(h), cdt)


def embed_tables(model, prefix: str, tables: Dict, spec) -> EmbeddedTables:
    """Per-modality MLPs over the deduplicated tables (eval: dropout = id)."""
    cdt = compute_dtype(spec)
    txt = _two_layer(model, "txt_%s" % prefix, "txt2_%s" % prefix,
                     tables["text"], cdt)
    vis = _two_layer(model, "vis_%s" % prefix, "vis2_%s" % prefix,
                     tables["visual"], cdt)
    return EmbeddedTables(
        clip=torch.cat([txt, vis], dim=-1),
        tr1=_two_layer(model, "tracks1_%s" % prefix, "tracks12_%s" % prefix,
                       tables["track"], cdt),
        tr2=_two_layer(model, "tracks2_%s" % prefix, "tracks22_%s" % prefix,
                       tables["track"], cdt),
    )


def ctx_table_dtype(spec) -> torch.dtype:
    return torch.bfloat16 if spec.compute_dtype == "bfloat16" else torch.float32


def embed_modalities(model, spec, tables: Dict) -> Dict[str, torch.Tensor]:
    """The Modalities model's branch MLPs over the tables, keyed ``txt`` /
    ``vis`` (clip rows) and ``tr1`` / ``tr2`` (track rows), in the head's
    concatenation order; the branches ``modalities_tabular`` reads (the
    track branches under modality 'm' only, as in the JAX package)."""
    cdt = compute_dtype(spec)
    out: Dict[str, torch.Tensor] = {}
    if spec.modality in ("m", "t"):
        out["txt"] = _two_layer(model, "txt_ints", "txt2_ints",
                                tables["text"], cdt)
    if spec.modality in ("m", "v"):
        out["vis"] = _two_layer(model, "vis_ints", "vis2_ints",
                                tables["visual"], cdt)
    if spec.tracks and spec.modality == "m":
        out["tr1"] = _two_layer(model, "tracks1_ints", "tracks12_ints",
                                tables["track"], cdt)
        out["tr2"] = _two_layer(model, "tracks2_ints", "tracks22_ints",
                                tables["track"], cdt)
    return out


def embed_all(model, spec, tables: Dict) -> Dict:
    """All branch embeddings of the tables, computed once (the weights are
    frozen at eval, so this amortizes over every request or batch). The
    ctx tables are cast to ``ctx_table_dtype(spec)``. The Modalities
    model's go under ``mod`` (``embed_modalities``)."""
    out: Dict = {}
    if spec.mod_check:
        out["mod"] = embed_modalities(model, spec, tables)
    elif spec.ints:
        out["ints"] = embed_tables(model, "ints", tables, spec)
    if spec.ctx:
        dt = ctx_table_dtype(spec)
        emb = embed_tables(model, "ctx", tables, spec)
        out["ctx"] = EmbeddedTables(*(t.to(dt).contiguous() for t in emb))
    return out


def _gather_row(emb: EmbeddedTables, idx: torch.Tensor) -> torch.Tensor:
    """Fused row embedding for index triples idx[..., 3] -> [..., 3*joint].
    Output order [txt | vis | tr1 | tr2] is preserved by the clip concat."""
    idx = idx.long()
    return torch.cat(
        [emb.clip[idx[..., 0]], emb.tr1[idx[..., 1]], emb.tr2[idx[..., 2]]],
        dim=-1,
    )


def _ctx_branch(emb: EmbeddedTables, idx: torch.Tensor, mask: torch.Tensor,
                guard_zero: bool, use_kernel: bool) -> torch.Tensor:
    """tanh(masked mean of the gathered ctx rows). use_kernel=False takes
    the plain PyTorch version on any device (for comparisons)."""
    idx = idx.to(torch.int32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    pool = fused_ctx_pool if use_kernel else fused_ctx_pool_reference
    return pool(emb, idx, mask, guard_zero)


def _ctx_branch_triple(fused: torch.Tensor, tidx: torch.Tensor,
                       mask: torch.Tensor, guard_zero: bool,
                       use_kernel: bool) -> torch.Tensor:
    """Triple-tier ctx branch: one fused-row gather per context entry.

    fused: the batch's unique [clip | tr1 | tr2] rows gathered into one
    local table (models/factory.apply_model builds it from
    ``ctx_triples``); tidx: [N, R] positions into it. The same values in
    the same order as _ctx_branch (ops/gather_pool.fused_ctx_pool_triple).
    """
    tidx = tidx.to(torch.int32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    pool = (fused_ctx_pool_triple if use_kernel
            else fused_ctx_pool_triple_reference)
    return pool(fused.contiguous(), tidx, mask, guard_zero)


def _embedded(model, spec, tables, embedded, branch):
    if embedded:
        return embedded[branch]
    return embed_tables(model, branch, tables, spec)


def midfusion_maxtracks_tabular(
    model,
    spec,
    tables: Optional[Dict],
    feat_idx: torch.Tensor,
    rels_mask: Optional[torch.Tensor] = None,
    embedded: Optional[Dict[str, EmbeddedTables]] = None,
    use_kernel: bool = True,
    ctx_triple=None,
) -> Dict[str, Optional[torch.Tensor]]:
    """MidFusionMultiClipMaxTracks eval forward over tables.

    feat_idx: [B, T, 1+R, 3]; rels_mask: [B, T, R] ->
    {"inters": [B, T, n_classes], "rels": [B, T, n_rels]}. ctx_triple
    (optional): (fused local table, tidx [B, T, R]), the triple tier
    (_ctx_branch_triple) in place of the 3-table ctx pool.
    """
    cdt = compute_dtype(spec)
    B, T = feat_idx.shape[0], feat_idx.shape[1]
    output_ints = output_ctx = None
    if spec.ints:
        emb_i = _embedded(model, spec, tables, embedded, "ints")
        output_ints = torch.tanh(
            _gather_row(emb_i, feat_idx[:, :, 0, :]).reshape(B * T, -1)
        )
    if spec.ctx:
        flat_mask = rels_mask.reshape(B * T, -1)
        if ctx_triple is not None:
            fused, tidx = ctx_triple
            output_ctx = _ctx_branch_triple(
                fused, tidx.reshape(B * T, -1), flat_mask, True, use_kernel)
        else:
            emb_c = _embedded(model, spec, tables, embedded, "ctx")
            output_ctx = _ctx_branch(
                emb_c, feat_idx[:, :, 1:, :].reshape(B * T, -1, 3),
                flat_mask, True, use_kernel,
            )
    if spec.gates:
        output_ints = gate_apply(model, output_ints, output_ctx, spec)
    rels_out = (
        linear(model.out_ctx, output_ctx, cdt).reshape(B, T, spec.n_rels)
        if spec.ctx else None
    )
    ints_out = (
        linear(model.out_ints, output_ints, cdt).reshape(B, T, spec.n_classes)
        if spec.ints else None
    )
    return {"inters": ints_out, "rels": rels_out}


def midfusion_tabular(
    model,
    spec,
    tables: Optional[Dict],
    feat_idx: torch.Tensor,
    rels_mask: Optional[torch.Tensor] = None,
    embedded: Optional[Dict[str, EmbeddedTables]] = None,
    use_kernel: bool = True,
    ctx_triple=None,
) -> Dict[str, Optional[torch.Tensor]]:
    """MidFusionMultiClip eval forward over tables.

    feat_idx: [B, 1+R, 3]; rels_mask: [B, R, 1] or [B, R]. A sample without
    any context gives NaN relationship logits, as in the reference (no
    zero-divider guard on this model). ctx_triple (optional): (fused local
    table, tidx [B, R]), see _ctx_branch_triple.
    """
    cdt = compute_dtype(spec)
    B = feat_idx.shape[0]
    output_ints = output_ctx = None
    if spec.ints:
        emb_i = _embedded(model, spec, tables, embedded, "ints")
        output_ints = torch.tanh(_gather_row(emb_i, feat_idx[:, 0, :]))
    if spec.ctx:
        mask = rels_mask.reshape(B, -1)
        if ctx_triple is not None:
            fused, tidx = ctx_triple
            output_ctx = _ctx_branch_triple(fused, tidx.reshape(B, -1), mask,
                                            False, use_kernel)
        else:
            emb_c = _embedded(model, spec, tables, embedded, "ctx")
            output_ctx = _ctx_branch(emb_c, feat_idx[:, 1:, :], mask, False,
                                     use_kernel)
    if spec.gates:
        output_ints = gate_apply(model, output_ints, output_ctx, spec)
    rels_out = linear(model.out_ctx, output_ctx, cdt) if spec.ctx else None
    ints_out = linear(model.out_ints, output_ints, cdt) if spec.ints else None
    return {"inters": ints_out, "rels": rels_out}


def modalities_tabular(
    model,
    spec,
    tables: Optional[Dict],
    feat_idx: torch.Tensor,
    embedded: Optional[Dict] = None,
) -> Dict[str, torch.Tensor]:
    """Modalities eval forward over tables. feat_idx: [B, 1, 3] or [B, 3]
    -> {"inters": [B, n_classes]}. The branch MLPs run over the tables
    (``embed_modalities``), or are read from ``embedded["mod"]``
    (embed_all), and their rows are gathered per sample: txt and vis by
    the clip id, tr1 and tr2 by the two track ids."""
    cdt = compute_dtype(spec)
    if feat_idx.dim() == 3:
        feat_idx = feat_idx[:, 0, :]
    idx = feat_idx.long()
    emb = (embedded["mod"] if embedded and "mod" in embedded
           else embed_modalities(model, spec, tables))
    column = {"txt": 0, "vis": 0, "tr1": 1, "tr2": 2}
    parts = [emb[k][idx[..., column[k]]] for k in emb]
    out = torch.tanh(parts[0] if len(parts) == 1 else torch.cat(parts, -1))
    return {"inters": linear(model.out_ints, out, cdt)}
