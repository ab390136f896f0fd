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

Under a model axis (parallel/mesh.shard_model) the first layers are
column-parallel, so each process's h1 tables hold its columns: ``clip``
is ``[txt shard | vis shard]``, ``2 * joint / M`` wide, ``tr1`` and ``tr2``
``joint / M``; the gathers and their backward (the scatter kernel) run on
those widths. The second layers are row-parallel: their partial products
are summed over the model group before the bias (scaled by the pool's
bias scale in the ctx branch) is added. The dropout masks on the sharded
h1 rows are drawn at the full width (layers.draw_cols).
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
    product,
    row_reduce,
)
from lirec_tpu_torch.parallel.mesh import shard_of
from lirec_tpu_torch.ops.scatter_accum import gather_h1

__all__ = [
    "H1Tables",
    "masked_sum",
    "project_tables",
    "midfusion_hybrid",
    "midfusion_maxtracks_hybrid",
    "modalities_hybrid",
]


class H1Tables(NamedTuple):
    """First-layer activations of the feature tables, per branch. txt and
    vis are indexed by the same clip id, so they are stored concatenated
    (one gather, one backward scatter). Stored bf16 under bf16 compute."""

    clip: torch.Tensor  # [n_clips, 2*joint] = [txt | vis] (/ M: shards)
    tr1: torch.Tensor  # [n_tracks, joint] (/ M)
    tr2: torch.Tensor  # [n_tracks, joint] (/ M)


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
    half = h1.clip.shape[-1] // 2

    def second(name, h):
        layer = model.get_submodule(name % prefix)
        h = torch.relu(dropout(h, p, rng, deterministic,
                               cols=shard_of(layer)))
        return linear(layer, h, cdt)

    idx = idx.long()
    clip = h1.clip[idx[..., 0]]
    txt = second("txt2_%s", clip[..., :half])
    vis = second("vis2_%s", clip[..., half:])
    tr1 = second("tracks12_%s", h1.tr1[idx[..., 1]])
    tr2 = second("tracks22_%s", h1.tr2[idx[..., 2]])
    return torch.cat([txt, vis, tr1, tr2], dim=-1)


def masked_sum(h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """sum_r m[n, r] h[n, r, :] in f32: h [N, R, J], 0/1 weights m [N, R]
    (f32) -> [N, J]. A bf16 h on a card: ``_masked_sum_bf16``; otherwise
    the einsum of h in f32."""
    if h.is_cuda and h.dtype == torch.bfloat16:
        return _masked_sum_bf16(h, m)
    return torch.einsum("nrj,nr->nj", h.float(), m)


def _masked_sum_bf16(h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``masked_sum`` of a bf16 h without its f32 copy: the products in
    bf16 (exact, the weights are 0/1) summed in f32 by one reduction that
    reads h once, where the einsum casts h to f32 and runs an f32 batched
    GEMM. Its gradient, the incoming one rounded to bf16 times the
    weights, is the einsum's bit for bit."""
    return (h * m.to(h.dtype)[..., None]).sum(dim=1, dtype=torch.float32)


def _pooled_ctx_from_h1(model, prefix: str, h1: H1Tables, idx: torch.Tensor,
                        mask: torch.Tensor, spec, rng: DropoutRng,
                        deterministic: bool, guard_zero_divide: bool,
                        use_kernel: bool = True) -> torch.Tensor:
    """ctx branch with the second layers applied after the masked mean.

    idx [N, R, 3], mask [N, R] -> [N, 3 * joint]. The pool sums the
    relu(dropout) activations in f32 (``masked_sum``: bf16 values times
    0/1 weights are exact, as in the JAX package's f32-accumulating
    einsum); the second layer's bias is scaled by msum / divider (1 for a
    non-empty context, 0 for an empty guarded one, NaN for an empty
    unguarded one).
    The second layers' products are ``layers.product`` of the pooled rows:
    under bf16 compute cuBLAS's bf16 GEMM with an f32 result on CUDA
    tensors (``layers.matmul_bf16``, backward too), the f32 product of the
    bf16-rounded operands on CPU tensors.
    use_kernel=False takes the plain scatter in the gathers' backward.
    Under a model axis the pools run on this process's columns and the
    second layers' products are summed over the model group before the
    scaled bias is added.
    """
    p = spec.dropout
    cdt = compute_dtype(spec)
    half = h1.clip.shape[-1] // 2

    m = mask.float()                                   # [N, R]
    msum = m.sum(dim=1, keepdim=True)                  # [N, 1]
    divider = (torch.where(msum == 0, torch.ones_like(msum), msum)
               if guard_zero_divide else msum)
    bias_scale = msum / divider                        # [N, 1]

    def second(name, h):
        layer = model.get_submodule(name % prefix)
        h = torch.relu(dropout(h, p, rng, deterministic,
                               cols=shard_of(layer)))
        ph = masked_sum(h, m) / divider
        return (row_reduce(layer, product(ph, layer.weight, cdt))
                + layer.bias * bias_scale)

    clip, g_tr1, g_tr2 = gather_h1(h1.clip, h1.tr1, h1.tr2, idx,
                                   use_kernel=use_kernel)
    txt = second("txt2_%s", clip[..., :half])
    vis = second("vis2_%s", clip[..., half:])
    tr1 = second("tracks12_%s", g_tr1)
    tr2 = second("tracks22_%s", g_tr2)
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
        layer = model.get_submodule(n2)
        h = torch.relu(dropout(h, p, drop, deterministic,
                               cols=shard_of(layer)))
        return linear(layer, h, cdt)

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
