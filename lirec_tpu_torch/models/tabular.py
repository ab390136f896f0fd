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
)

__all__ = [
    "EmbeddedTables",
    "embed_tables",
    "embed_all",
    "ctx_table_dtype",
    "midfusion_maxtracks_tabular",
    "midfusion_tabular",
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


def embed_all(model, spec, tables: Dict) -> Dict[str, EmbeddedTables]:
    """All branch embeddings of the tables, computed once (the weights are
    frozen at eval, so this amortizes over every request or batch). The
    ctx tables are cast to ``ctx_table_dtype(spec)``."""
    out: Dict[str, EmbeddedTables] = {}
    if spec.ints and not spec.mod_check:
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
) -> Dict[str, Optional[torch.Tensor]]:
    """MidFusionMultiClipMaxTracks eval forward over tables.

    feat_idx: [B, T, 1+R, 3]; rels_mask: [B, T, R] ->
    {"inters": [B, T, n_classes], "rels": [B, T, n_rels]}.
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
        emb_c = _embedded(model, spec, tables, embedded, "ctx")
        output_ctx = _ctx_branch(
            emb_c,
            feat_idx[:, :, 1:, :].reshape(B * T, -1, 3),
            rels_mask.reshape(B * T, -1),
            True,
            use_kernel,
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
) -> Dict[str, Optional[torch.Tensor]]:
    """MidFusionMultiClip eval forward over tables.

    feat_idx: [B, 1+R, 3]; rels_mask: [B, R, 1] or [B, R]. A sample without
    any context gives NaN relationship logits, as in the reference (no
    zero-divider guard on this model).
    """
    cdt = compute_dtype(spec)
    B = feat_idx.shape[0]
    output_ints = output_ctx = None
    if spec.ints:
        emb_i = _embedded(model, spec, tables, embedded, "ints")
        output_ints = torch.tanh(_gather_row(emb_i, feat_idx[:, 0, :]))
    if spec.ctx:
        emb_c = _embedded(model, spec, tables, embedded, "ctx")
        output_ctx = _ctx_branch(
            emb_c, feat_idx[:, 1:, :], rels_mask.reshape(B, -1), False,
            use_kernel,
        )
    if spec.gates:
        output_ints = gate_apply(model, output_ints, output_ctx, spec)
    rels_out = linear(model.out_ctx, output_ctx, cdt) if spec.ctx else None
    ints_out = linear(model.out_ints, output_ints, cdt) if spec.ints else None
    return {"inters": ints_out, "rels": rels_out}
