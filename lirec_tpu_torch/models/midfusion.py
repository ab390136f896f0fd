"""Mid-fusion multi-clip models (ref `mlp/model.py:95-354`; counterpart of
lirec_tpu/models/midfusion.py).

``MidFusion`` holds the parameters of both variants. The dense forwards
over reference-layout rows: ``midfusion_forward`` = MidFusionMultiClip
(GT-row ints branch + masked-mean context branch over the context clips +
gated fusion + heads) and ``midfusion_maxtracks_forward`` =
MidFusionMultiClipMaxTracks, the same computation batched over the track
pair hypotheses. The packed forwards are in models/tabular.py (eval) and
models/hybrid.py (training).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from lirec_tpu_torch.models.blocks import (
    FeatSlices, gate_apply, init_gate, init_modality_mlps, modality_embed,
)
from lirec_tpu_torch.models.layers import (
    DropoutRng, compute_dtype, dropout, init_linear, linear,
)

__all__ = ["MidFusion", "init_midfusion", "midfusion_forward",
           "midfusion_maxtracks_forward"]


class MidFusion(nn.Module):
    """MidFusionMultiClip / MidFusionMultiClipMaxTracks parameters under the
    reference checkpoint's names (``txt_ints.weight [out, in]``, ...,
    ``gates_ints.fc_out.*``), so a reference ``state_dict`` loads with
    ``load_state_dict``. Both variants share names and shapes."""

    def __init__(self, layers: Dict[str, nn.Module]):
        super().__init__()
        for name, layer in layers.items():
            self.add_module(name, layer)


def init_midfusion(spec, generator: torch.Generator) -> MidFusion:
    layers: Dict[str, nn.Module] = {}
    out_dim_ints = spec.joint_dim * 3
    if spec.ints:
        layers.update(init_modality_mlps(spec, "ints", generator))
    if spec.ctx:
        layers.update(init_modality_mlps(spec, "ctx", generator))
    if spec.gates:
        out_dim_ints = spec.gate_out_dim
        layers.update(init_gate(spec, generator))
    if spec.ints:
        layers["out_ints"] = init_linear(
            out_dim_ints, spec.n_classes, generator
        )
    if spec.ctx:
        layers["out_ctx"] = init_linear(
            spec.joint_dim * 3, spec.n_rels, generator
        )
    return MidFusion(layers).eval()


def _ctx_branch(model: nn.Module, ctx_slices: FeatSlices,
                rels_mask: torch.Tensor, spec, drop: DropoutRng,
                deterministic: bool, guard_zero_divide: bool) -> torch.Tensor:
    """Per-clip MLPs, then the masked mean over the context-clip axis (ref
    model.py:173-199 / 300-327). ctx_slices [N, R, dim], rels_mask [N, R].
    """
    embedded = modality_embed(model, "ctx", ctx_slices, spec, drop,
                              deterministic)  # [N, R, 3 * joint]
    mask = rels_mask[..., None].to(embedded.dtype)
    divider = mask.sum(dim=-2)  # [N, 1]
    if guard_zero_divide:
        # only the MaxTracks variant guards empty contexts (ref model.py:303)
        divider = torch.where(divider == 0, torch.ones_like(divider),
                              divider)
    pooled = (embedded * mask).sum(dim=-2) / divider
    return dropout(torch.tanh(pooled), spec.dropout, drop, deterministic)


def midfusion_forward(model: nn.Module, spec, s: FeatSlices,
                      rels_mask: Optional[torch.Tensor] = None,
                      deterministic: bool = True,
                      rng: Optional[torch.Generator] = None
                      ) -> Dict[str, Optional[torch.Tensor]]:
    """MidFusionMultiClip. s: [B, 1+R, dim] slices (row 0 = the GT clip);
    rels_mask [B, R]; rng: the dropout generator. Returns {'inters': [B,
    C], 'rels': [B, n_rels]}. An empty context gives NaN relationship
    logits, as in the reference."""
    drop = DropoutRng(rng)
    cdt = compute_dtype(spec)
    output_ints = output_ctx = None
    if spec.ints:
        ints_repr = modality_embed(model, "ints", s.index(slice(None), 0),
                                   spec, drop, deterministic)
        output_ints = dropout(torch.tanh(ints_repr), spec.dropout, drop,
                              deterministic)
    if spec.ctx:
        output_ctx = _ctx_branch(
            model, s.index(slice(None), slice(1, None)),
            rels_mask.reshape(rels_mask.shape[0], -1), spec, drop,
            deterministic, guard_zero_divide=False)
    if spec.gates:
        output_ints = gate_apply(model, output_ints, output_ctx, spec, drop,
                                 deterministic)
    rels_out = linear(model.out_ctx, output_ctx, cdt) if spec.ctx else None
    ints_out = linear(model.out_ints, output_ints, cdt) if spec.ints else None
    return {"inters": ints_out, "rels": rels_out}


def midfusion_maxtracks_forward(model: nn.Module, spec, s: FeatSlices,
                                rels_mask: Optional[torch.Tensor] = None,
                                deterministic: bool = True,
                                rng: Optional[torch.Generator] = None
                                ) -> Dict[str, Optional[torch.Tensor]]:
    """MidFusionMultiClipMaxTracks. s: [B, T, 1+R, dim] (ctx on) or [B, T,
    1, dim] (ctx off); rels_mask [B, T, R]. Returns {'inters': [B, T, C],
    'rels': [B, T, n_rels] or None}."""
    drop = DropoutRng(rng)
    cdt = compute_dtype(spec)
    batch, n_tracks = s.text.shape[0], s.text.shape[1]
    flat = FeatSlices(*(a.reshape((batch * n_tracks,) + tuple(a.shape[2:]))
                        for a in s))
    output_ints = output_ctx = None
    if spec.ints:
        ints_repr = modality_embed(model, "ints", flat.index(slice(None), 0),
                                   spec, drop, deterministic)
        output_ints = dropout(torch.tanh(ints_repr), spec.dropout, drop,
                              deterministic)
    if spec.ctx:
        output_ctx = _ctx_branch(
            model, flat.index(slice(None), slice(1, None)),
            rels_mask.reshape(batch * n_tracks, -1), spec, drop,
            deterministic, guard_zero_divide=True)
    if spec.gates:
        output_ints = gate_apply(model, output_ints, output_ctx, spec, drop,
                                 deterministic)
    rels_out = ints_out = None
    if spec.ctx:
        rels_out = linear(model.out_ctx, output_ctx, cdt).reshape(
            batch, n_tracks, spec.n_rels)
    if spec.ints:
        ints_out = linear(model.out_ints, output_ints, cdt).reshape(
            batch, n_tracks, spec.n_classes)
    return {"inters": ints_out, "rels": rels_out}
