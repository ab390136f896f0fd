"""Modality-check interaction model parameters (ref `mlp/model.py:19-92`).

Counterpart of ``init_modalities`` in lirec_tpu/models/modalities.py:
per-modality 2-layer MLPs on the GT feature row, concatenated, tanh +
dropout, a linear head. The modality subset (``'m'`` / ``'t'`` / ``'v'``)
and the optional track branches follow the reference flags. The eval
forward over the tables is models/tabular.modalities_tabular, the training
forward models/hybrid.modalities_hybrid; the dense forward is not ported.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from lirec_tpu_torch.models.layers import init_linear

__all__ = ["Modalities", "init_modalities"]


class Modalities(nn.Module):
    """Modalities parameters under the reference checkpoint's names
    (``txt_ints``, ``txt2_ints``, ``vis_ints``, ``vis2_ints``,
    ``tracks1_ints``, ``tracks2_ints``, ``tracks12_ints``,
    ``tracks22_ints``, ``out_ints``; ``weight [out, in]``), so
    ``mod_all.pth.tar`` loads with ``load_state_dict`` and
    ``checkpoint.params_from_jax`` maps the JAX tree unchanged."""

    def __init__(self, layers: Dict[str, nn.Module]):
        super().__init__()
        for name, layer in layers.items():
            self.add_module(name, layer)


def init_modalities(spec, generator: torch.Generator) -> Modalities:
    j = spec.joint_dim
    layers: Dict[str, nn.Module] = {}
    out_dim = 0
    if spec.modality in ("m", "t"):
        layers["txt_ints"] = init_linear(spec.text_dim, j, generator)
        layers["txt2_ints"] = init_linear(j, j, generator)
        out_dim += j
    if spec.modality in ("m", "v"):
        layers["vis_ints"] = init_linear(spec.visual_dim, j, generator)
        layers["vis2_ints"] = init_linear(j, j, generator)
        out_dim += j
    if spec.tracks:
        layers["tracks1_ints"] = init_linear(spec.track_dim, j, generator)
        layers["tracks2_ints"] = init_linear(spec.track_dim, j, generator)
        layers["tracks12_ints"] = init_linear(j, j // 2, generator)
        layers["tracks22_ints"] = init_linear(j, j // 2, generator)
        # the JAX package counts the track branches into the head's input
        # under every modality, though only 'm' concatenates them: under
        # 't' / 'v' with tracks on, the forwards of both packages raise on
        # the head's width (ROADMAP.md queue 3)
        out_dim += j
    layers["out_ints"] = init_linear(out_dim, spec.n_classes, generator)
    return Modalities(layers).eval()
