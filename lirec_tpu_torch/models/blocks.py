"""Shared model building blocks (counterpart of lirec_tpu/models/blocks.py).

The packed paths gather per-modality rows from the feature tables
(models/tabular.py, models/hybrid.py); the dense path slices a
reference-layout row ``[text | visual | track1 | track2]`` into a
`FeatSlices` (``slices_from_dense``) and runs the same ``nn.Linear``s over
it (``modality_embed``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from lirec_tpu_torch.models.layers import (
    DropoutRng,
    compute_dtype,
    dropout,
    init_linear,
    linear,
)
from lirec_tpu_torch.parallel.mesh import shard_of

__all__ = ["FeatSlices", "slices_from_dense", "GatingUnit",
           "init_modality_mlps", "modality_embed", "init_gate", "gate_apply"]


class FeatSlices(NamedTuple):
    text: torch.Tensor  # [..., text_dim]
    visual: torch.Tensor  # [..., visual_dim]
    track1: torch.Tensor  # [..., track_dim]
    track2: torch.Tensor  # [..., track_dim]

    def index(self, *idx) -> "FeatSlices":
        return FeatSlices(*(a[idx] for a in self))


def slices_from_dense(features: torch.Tensor, spec) -> FeatSlices:
    """Split a reference-layout row [text | visual | track1 | track2]."""
    t, v, k = spec.text_dim, spec.visual_dim, spec.track_dim
    return FeatSlices(
        text=features[..., :t],
        visual=features[..., t: t + v],
        track1=features[..., t + v: t + v + k],
        track2=features[..., t + v + k:],
    )


def init_modality_mlps(spec, prefix: str,
                       generator: torch.Generator) -> Dict[str, nn.Linear]:
    """Two-layer per-modality MLPs (ref mlp/model.py:103-113 naming)."""
    j = spec.joint_dim
    shapes = {
        "txt_%s": (spec.text_dim, j),
        "txt2_%s": (j, j),
        "vis_%s": (spec.visual_dim, j),
        "vis2_%s": (j, j),
        "tracks1_%s": (spec.track_dim, j),
        "tracks2_%s": (spec.track_dim, j),
        "tracks12_%s": (j, j // 2),
        "tracks22_%s": (j, j // 2),
    }
    return {
        name % prefix: init_linear(i, o, generator)
        for name, (i, o) in shapes.items()
    }


def modality_embed(model: nn.Module, prefix: str, s: FeatSlices, spec,
                   rng: DropoutRng, deterministic: bool) -> torch.Tensor:
    """linear -> dropout -> relu -> linear per modality over slices with
    any leading axes, concatenated [txt j | vis j | tr1 j/2 | tr2 j/2]
    (ref mlp/model.py:152-169), with the per-modality ``nn.Linear``s of
    `model` (``init_modality_mlps``' names under `prefix`)."""
    p = spec.dropout
    cdt = compute_dtype(spec)

    def two_layer(name1, name2, x):
        h = linear(model.get_submodule(name1 % prefix), x, cdt)
        layer = model.get_submodule(name2 % prefix)
        h = torch.relu(dropout(h, p, rng, deterministic,
                               cols=shard_of(layer)))
        return linear(layer, h, cdt)

    return torch.cat([
        two_layer("txt_%s", "txt2_%s", s.text),
        two_layer("vis_%s", "vis2_%s", s.visual),
        two_layer("tracks1_%s", "tracks12_%s", s.track1),
        two_layer("tracks2_%s", "tracks22_%s", s.track2),
    ], dim=-1)


class GatingUnit(nn.Module):
    """The reference GatingUnit (ref mlp/model.py:342-354): one ``fc_out``
    linear, so its checkpoint entries are ``gates_ints.fc_out.*``."""

    def __init__(self, fc_out: nn.Linear):
        super().__init__()
        self.fc_out = fc_out


def init_gate(spec, generator: torch.Generator) -> Dict:
    return {
        "gates_ints": GatingUnit(
            init_linear(spec.joint_dim * 6, spec.gate_out_dim, generator)
        )
    }


def gate_apply(model: nn.Module, ints_repr: torch.Tensor,
               ctx_repr: torch.Tensor, spec,
               rng: Optional[DropoutRng] = None,
               deterministic: bool = True) -> torch.Tensor:
    """cat(ctx, ints) -> linear -> relu -> dropout (ref
    mlp/model.py:349-354; the dropout is the identity at eval). Under a
    model axis the gate is column-parallel on the replicated fused input,
    so the output holds this process's columns (and out_ints after it is
    row-parallel)."""
    fused = torch.cat([ctx_repr, ints_repr], dim=-1)
    layer = model.gates_ints.fc_out
    out = torch.relu(linear(layer, fused, compute_dtype(spec)))
    return dropout(out, spec.dropout, rng, deterministic,
                   cols=shard_of(layer))
