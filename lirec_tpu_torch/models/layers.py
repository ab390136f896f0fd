"""Linear layers in the reference checkpoint's layout, and dropout.

Counterpart of ``lirec_tpu/models/layers.py``. Layers are ``nn.Linear``
(``weight [out, in]``, the transpose of the JAX package's ``kernel``) with
the torch default init, uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight
and bias, drawn from an explicit ``torch.Generator``.

Dropout masks come from one explicit ``torch.Generator`` per forward, drawn
in the forward's fixed call order. They cannot match JAX's key stream: the
two are held to the same distribution only.

Under a model axis (parallel/mesh.shard_model) a layer carries its
``Shard``: ``linear`` then runs it column- or row-parallel, and a dropout
mask on the activation between the two is drawn at the full width and
cut to this process's columns (``draw_cols``), so that a tensor-parallel
step draws the one-process step's masks bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from lirec_tpu_torch.parallel.mesh import (
    COLUMN, copy_to_model, reduce_from_model, shard_of,
)

__all__ = ["DropoutRng", "compute_dtype", "dropout", "init_linear", "linear",
           "row_reduce", "draw_rows", "draw_cols"]


def compute_dtype(spec) -> Optional[torch.dtype]:
    """Matmul input dtype for a ModelSpec ('bfloat16' -> torch.bfloat16,
    anything else -> None = keep the input dtype)."""
    return torch.bfloat16 if spec.compute_dtype == "bfloat16" else None


def init_linear(in_dim: int, out_dim: int,
                generator: torch.Generator) -> nn.Linear:
    """nn.Linear on the CPU with weight and bias drawn U(+-1/sqrt(in_dim))
    from `generator` (a CPU generator, so a seed gives the same weights
    whatever device the model is moved to)."""
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim)
    bound = 1.0 / math.sqrt(in_dim)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def linear(layer: nn.Linear, x: torch.Tensor,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ W^T + b with a float32 result.

    Under bf16 compute the JAX package casts x and the kernel to bf16 and
    asks for an f32 product (``preferred_element_type``). A bf16 matmul here
    would round its output to bf16, so both operands are rounded to bf16
    and multiplied in f32 instead: bf16 x bf16 products are exact in f32,
    so only the order of the f32 sums differs. (A fast bf16 GEMM with f32
    output is later work.)

    A column-parallel layer (its ``tp_shard``) multiplies its slice after
    ``copy_to_model``; a row-parallel one multiplies its slice, sums the
    partial products over the model group, and only then adds the bias
    (once, not once per process).
    """
    w = layer.weight
    if compute_dtype is not None:
        x = x.to(compute_dtype).float()
        w = w.to(compute_dtype).float()
    shard = shard_of(layer)
    if shard is None:
        return nn.functional.linear(x, w, layer.bias)
    if shard.kind == COLUMN:
        return nn.functional.linear(copy_to_model(x, shard.group), w,
                                    layer.bias)
    return reduce_from_model(x @ w.t(), shard.group) + layer.bias


def row_reduce(layer: nn.Module, partial: torch.Tensor) -> torch.Tensor:
    """A product with `layer`'s weight summed over the model group where
    the layer is row-parallel; `partial` itself otherwise."""
    shard = shard_of(layer)
    if shard is None or shard.kind == COLUMN:
        return partial
    return reduce_from_model(partial, shard.group)


def draw_rows(draw, shape, generator, device, dtype=None):
    """``draw(shape, generator=, device=)`` (``torch.rand`` or an
    in-place sampler's factory), where `shape`'s first axis is rows of a
    batch. Inside a data-parallel step (parallel/dist.sharded_batch) the
    draw is made at the global batch's shape, the same on every rank, and
    this rank's block of rows is kept, so the masks are the
    single-process run's; outside it, the plain draw."""
    from lirec_tpu_torch.parallel.dist import batch_shard

    shard = batch_shard()
    kw = {} if dtype is None else {"dtype": dtype}
    if shard is None:
        return draw(shape, generator=generator, device=device, **kw)
    n = shape[0]
    full = draw((n * shard.size,) + tuple(shape[1:]), generator=generator,
                device=device, **kw)
    return full[shard.rank * n:(shard.rank + 1) * n]


def draw_cols(draw, shape, generator, device, cols):
    """``draw_rows`` of an activation that holds columns `cols.index` of
    `cols.size` equal blocks of the full width (a parallel/mesh.Shard):
    the draw is made at the full width, the same on every process of the
    model group, and this process's columns are kept; with `cols` None,
    ``draw_rows`` itself."""
    if cols is None:
        return draw_rows(draw, shape, generator, device)
    w = shape[-1]
    full = draw_rows(draw, tuple(shape[:-1]) + (w * cols.size,), generator,
                     device)
    return full[..., cols.index * w:(cols.index + 1) * w]


class DropoutRng:
    """The dropout stream of one forward: a ``torch.Generator`` on the
    activations' device (None: no randomness, e.g. at eval), drawn from in
    call order; ``calls`` counts the masks drawn."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator
        self.calls = 0


def dropout(x: torch.Tensor, rate: float, rng: DropoutRng,
            deterministic: bool, cols=None) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate); the identity when deterministic or
    rate == 0. (The JAX package drew 16-bit words on the TPU to cut its RNG
    cost; one f32 uniform per element is drawn here.) Inside a
    data-parallel step the masks are drawn for the global batch and this
    rank keeps its rows (draw_rows); on an activation sharded over the
    model axis (`cols`: the Shard of the layer around it, None where it
    is whole) at the full width, keeping this process's columns
    (draw_cols)."""
    if deterministic or rate == 0.0:
        return x
    if rng.generator is None:
        raise ValueError("dropout needs a generator unless deterministic")
    rng.calls += 1
    keep = 1.0 - rate
    u = draw_cols(torch.rand, x.shape, rng.generator, x.device, cols)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
