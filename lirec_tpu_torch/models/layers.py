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

Products under bf16 compute (``product``, ``linear``): on CUDA tensors
``matmul_bf16``, cuBLAS's bf16 GEMM with an f32 result on the tensor
cores, forward and backward (the incoming f32 gradient as two bf16 terms;
launch count and decisions ``GEMM_NAME``);
on CPU tensors the f32 product of the bf16-rounded operands. Under f32
compute the f32 product (TF32 stays off).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.parallel.mesh import (
    COLUMN, copy_to_model, reduce_from_model, shard_of,
)

__all__ = ["DropoutRng", "GEMM_NAME", "compute_dtype", "dropout",
           "init_linear", "linear", "matmul_bf16", "on_tensor_cores",
           "product", "row_reduce", "draw_rows", "draw_cols"]

GEMM_NAME = "bf16_gemm"


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


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two bf16 matrices with an f32 result, counted under
    ``GEMM_NAME``: cuBLAS's bf16 GEMM, which accumulates in f32, on CUDA
    tensors; on CPU tensors, where ``mm``'s ``out_dtype`` is not
    registered, the f32 product of the same values (products of two bf16
    values are exact in f32, so only the order of the sums differs)."""
    if a.is_cuda:
        out = torch.mm(a, b, out_dtype=torch.float32)
    else:
        out = torch.mm(a.float(), b.float())
    dispatch.count_launch(GEMM_NAME)
    return out


def _split(g: torch.Tensor):
    """An f32 `g` as two bf16 terms hi + lo whose sum holds it to 2**-17
    of its value: hi is g rounded to bf16, lo the rest rounded to bf16
    (g - hi is exact in f32)."""
    hi = g.to(torch.bfloat16)
    return hi, (g - hi).to(torch.bfloat16)


class _MatmulBf16(torch.autograd.Function):
    """x @ w^T of bf16-rounded operands with an f32 result. Backward: the
    incoming f32 gradient as two bf16 terms (``_split``), so that each
    gradient's two bf16 GEMMs with f32 results sum to the f32 gradient's
    product as the cast chain ``x.to(bf16).float()`` takes it (and JAX's
    transpose of a dot with an f32 result); only the gradients that
    ``needs_input_grad`` asks for; each rounded to bf16 and returned in its
    input's dtype, as the cast chain returns it, except an input gradient
    with `round_grad_x` False (a column-parallel layer's, rounded after the
    model group's sum). Saves the bf16 operands."""

    @staticmethod
    def forward(ctx, x, w, round_grad_x):
        xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        wb = w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.x_shape, ctx.x_dtype, ctx.w_dtype = x.shape, x.dtype, w.dtype
        ctx.round_grad_x = round_grad_x
        return _mm(xb, wb.t()).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        hi, lo = _split(g.reshape(-1, g.shape[-1]).float())
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _mm(hi, wb).add_(_mm(lo, wb))
            if ctx.round_grad_x:
                gx = gx.to(torch.bfloat16)
            gx = gx.to(ctx.x_dtype).reshape(ctx.x_shape)
        if ctx.needs_input_grad[1]:
            gw = _mm(hi.t(), xb).add_(_mm(lo.t(), xb))
            gw = gw.to(torch.bfloat16).to(ctx.w_dtype)
        return gx, gw, None


def matmul_bf16(x: torch.Tensor, w: torch.Tensor,
                round_grad_x: bool = True) -> torch.Tensor:
    """x [..., in] @ w[out, in]^T -> [..., out] f32 on the tensor cores
    (``_MatmulBf16``); x of any leading axes. `round_grad_x` False leaves
    x's gradient unrounded, for a caller that rounds it later."""
    return _MatmulBf16.apply(x, w, round_grad_x)


def on_tensor_cores(x: torch.Tensor, w: torch.Tensor,
                    compute_dtype: Optional[torch.dtype]) -> bool:
    """True where x @ w^T runs as ``matmul_bf16``: bf16 compute on CUDA
    tensors. Records the decision under ``GEMM_NAME``: "cuda", or
    "reference" (f32 compute, or CPU tensors, whose cast chain is kept)."""
    if compute_dtype != torch.bfloat16:
        path, reason = "reference", "f32 compute"
    elif x.is_cuda:
        path, reason = "cuda", "bf16 compute on cuda tensors"
    else:
        path, reason = "reference", "%s tensors" % x.device.type
    dispatch.record(GEMM_NAME, path, reason, (x.shape, w.shape))
    return path == "cuda"


def product(x: torch.Tensor, w: torch.Tensor,
            compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ w^T with an f32 result, without bias or collectives: under bf16
    compute ``matmul_bf16`` on CUDA tensors, else (CPU tensors) the f32
    product of both operands rounded to bf16; the f32 product under f32
    compute."""
    if on_tensor_cores(x, w, compute_dtype):
        return matmul_bf16(x, w)
    if compute_dtype is not None:
        x = x.to(compute_dtype).float()
        w = w.to(compute_dtype).float()
    return x @ w.t()


def linear(layer: nn.Linear, x: torch.Tensor,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ W^T + b with a float32 result.

    Under bf16 compute the JAX package casts x and the kernel to bf16 and
    asks for an f32 product (``preferred_element_type``). On CUDA tensors
    that is ``matmul_bf16``: cuBLAS's bf16 GEMM with f32 accumulation and
    an f32 result; backward, each gradient from two such GEMMs, of the f32
    incoming gradient's two bf16 terms; the bias is added after it. On CPU
    tensors both operands are rounded to bf16 and multiplied in f32
    (``mm``'s ``out_dtype`` is CUDA's only): bf16 x bf16 products are exact
    in f32, so the two differ only in the order of the f32 sums. Under f32
    compute: the f32 product.

    A column-parallel layer (its ``tp_shard``) multiplies its slice after
    ``copy_to_model``; a row-parallel one multiplies its slice, sums the
    partial products over the model group, and only then adds the bias
    (once, not once per process). A column-parallel layer's input
    gradient is summed over the group in f32 and then rounded to bf16, on
    both paths.
    """
    shard = shard_of(layer)
    if on_tensor_cores(x, layer.weight, compute_dtype):
        if shard is None or shard.kind != COLUMN:
            return row_reduce(layer, matmul_bf16(x, layer.weight)) + layer.bias
        # the cast's backward rounds x's gradient after the group's sum
        x = copy_to_model(x.to(compute_dtype).float(), shard.group)
        return matmul_bf16(x, layer.weight, round_grad_x=False) + layer.bias
    w = layer.weight
    if compute_dtype is not None:
        x = x.to(compute_dtype).float()
        w = w.to(compute_dtype).float()
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
