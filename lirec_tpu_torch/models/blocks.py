"""Shared model building blocks (counterpart of lirec_tpu/models/blocks.py)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from lirec_tpu_torch.models.layers import (
    DropoutRng,
    compute_dtype,
    dropout,
    init_linear,
    linear,
)

__all__ = ["GatingUnit", "init_modality_mlps", "init_gate", "gate_apply"]


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
    mlp/model.py:349-354; the dropout is the identity at eval)."""
    fused = torch.cat([ctx_repr, ints_repr], dim=-1)
    out = torch.relu(
        linear(model.gates_ints.fc_out, fused, compute_dtype(spec))
    )
    return dropout(out, spec.dropout, rng, deterministic)
