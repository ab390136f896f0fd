"""Weights and feature tables made on the device from the run's seed, in a
few large draws (no leaf-by-leaf host init).

Weights follow torch's default ``nn.Linear`` init, U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for weight and bias alike, as the released model was
initialised; tables are standard normal, as the benchmarks of the
program have always drawn them. Both are float32, the type the model
keeps its parameters and its tables in.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

__all__ = ["generator", "make_weights", "make_tables"]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one stream (0: weights, 1: tables) of a run."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 2 + stream) % (1 << 63))


def make_weights(shapes: List[Tuple[str, Tuple[int, ...]]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for (name, shape) pairs of ``.weight`` /
    ``.bias`` leaves, all drawn in one call and scaled by their layer's
    fan-in (the weight's second axis)."""
    fan_in = {name[: -len(".weight")]: shape[1] for name, shape in shapes
              if name.endswith(".weight")}
    sizes = [math.prod(shape) for _, shape in shapes]
    flat = torch.rand(sum(sizes), generator=generator(seed, 0, device),
                      device=device)
    out = {}
    for (name, shape), part in zip(shapes, torch.split(flat, sizes)):
        bound = 1.0 / math.sqrt(fan_in[name.rsplit(".", 1)[0]])
        out[name] = ((part * 2.0 - 1.0) * bound).reshape(shape)
    return out


def make_tables(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The feature tables of a configuration's split: text and visual rows
    per clip, track rows per face track, standard normal float32."""
    g = generator(seed, 1, device)
    n_c, n_t = cfg["n_clips"], cfg["n_tracks"]
    return {
        "text": torch.randn(n_c, cfg["text_dim"], generator=g, device=device),
        "visual": torch.randn(n_c, cfg["visual_dim"], generator=g,
                              device=device),
        "track": torch.randn(n_t, cfg["track_dim"], generator=g,
                             device=device),
    }
