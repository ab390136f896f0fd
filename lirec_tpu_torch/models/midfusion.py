"""Mid-fusion multi-clip model parameters (ref `mlp/model.py:95-354`).

Counterpart of ``init_midfusion`` in lirec_tpu/models/midfusion.py. The
dense forwards belong to the training slice; the eval forwards over
embedded tables are in models/tabular.py.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from lirec_tpu_torch.models.blocks import init_gate, init_modality_mlps
from lirec_tpu_torch.models.layers import init_linear

__all__ = ["MidFusion", "init_midfusion"]


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
