"""Modality-check interaction model parameters (ref `mlp/model.py:19-92`).

Counterpart of ``init_modalities`` in lirec_tpu/models/modalities.py:
per-modality 2-layer MLPs on the GT feature row, concatenated, tanh +
dropout, a linear head. The modality subset (``'m'`` / ``'t'`` / ``'v'``)
and the optional track branches follow the reference flags. The eval
forward over the tables is models/tabular.modalities_tabular, the training
forward models/hybrid.modalities_hybrid, and ``modalities_forward`` the
dense forward over reference-layout GT rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from lirec_tpu_torch.models.blocks import FeatSlices
from lirec_tpu_torch.models.layers import (
    DropoutRng, compute_dtype, dropout, init_linear, linear,
)
from lirec_tpu_torch.parallel.mesh import shard_of

__all__ = ["Modalities", "init_modalities", "modalities_forward"]


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


def modalities_forward(model: nn.Module, spec, s: FeatSlices,
                       deterministic: bool = True,
                       rng: Optional[torch.Generator] = None
                       ) -> Dict[str, torch.Tensor]:
    """s: GT-row slices with leading batch axes [B]; rng: the dropout
    generator. Returns {'inters': [B, C]}. The track branches run whenever
    ``spec.tracks`` is on, as in the JAX package, so the dropout calls keep
    its order (txt, vis, tr1, tr2, the output)."""
    drop = DropoutRng(rng)
    p = spec.dropout
    cdt = compute_dtype(spec)

    def two_layer(n1, n2, x):
        h = linear(model.get_submodule(n1), x, cdt)
        layer = model.get_submodule(n2)
        h = torch.relu(dropout(h, p, drop, deterministic,
                               cols=shard_of(layer)))
        return linear(layer, h, cdt)

    txt = vis = None
    if spec.modality in ("m", "t"):
        txt = two_layer("txt_ints", "txt2_ints", s.text)
    if spec.modality in ("m", "v"):
        vis = two_layer("vis_ints", "vis2_ints", s.visual)
    if spec.tracks:
        tr1 = two_layer("tracks1_ints", "tracks12_ints", s.track1)
        tr2 = two_layer("tracks2_ints", "tracks22_ints", s.track2)
    if spec.modality == "m":
        out = torch.cat([txt, vis] + ([tr1, tr2] if spec.tracks else []),
                        dim=-1)
    else:
        out = txt if spec.modality == "t" else vis
    out = dropout(torch.tanh(out), p, drop, deterministic)
    return {"inters": linear(model.out_ints, out, cdt)}
