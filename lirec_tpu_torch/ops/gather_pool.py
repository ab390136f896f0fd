"""Fused context pool: gathers + masked mean + tanh in one CUDA kernel.

    out[m] = tanh([pool(clip, 0) | pool(tr1, 1) | pool(tr2, 2)] / div[m])
    pool(T, k)[m] = sum_r mask[m, r] * T[idx[m, r, k]],  div = sum_r mask

Counterpart of ``lirec_tpu/ops/gather_pool.fused_ctx_pool``. The three TPU
tiers (VMEM-resident f32, packed-bf16, HBM-streaming) are one kernel here,
``csrc/fused_ctx_pool.cu``, instantiated for float32 and bfloat16 tables;
the output is float32 for both, with float32 accumulation.

``fused_ctx_pool`` launches the kernel for CUDA tensors and takes the plain
version (``fused_ctx_pool_reference``) only for CPU tensors. For a CUDA
tensor it launches or raises: a missing nvcc or a failed build is an error.
"""

from __future__ import annotations

import ctypes

import torch

from lirec_tpu_torch.ops import dispatch

__all__ = ["fused_ctx_pool", "fused_ctx_pool_reference", "KERNEL_NAMES"]

_SOURCE = "fused_ctx_pool"
_SYMBOLS = {torch.float32: "fused_ctx_pool_f32",
            torch.bfloat16: "fused_ctx_pool_bf16"}
# launch-count keys, one per instantiation of the kernel
KERNEL_NAMES = dict(_SYMBOLS)
MAX_CONTEXT = 2048  # 16 bytes of shared memory per context entry, < 48 KB


def fused_ctx_pool_reference(emb, idx, mask, guard_zero: bool):
    """Plain PyTorch version: [M, R, 3] indices, [M, R] weights -> f32
    [M, d_clip + 2 * d_tr]. Divides where the kernel multiplies by 1/div
    (one-ulp differences); an all-zero row without guard_zero gives NaN,
    as in the JAX reference."""
    idx = idx.long()
    mask = mask.float()
    divider = mask.sum(dim=-1, keepdim=True)
    if guard_zero:
        divider = torch.where(divider == 0, torch.ones_like(divider), divider)
    w = mask[..., None]

    def pool(tab, which):
        return (tab[idx[..., which]].float() * w).sum(dim=-2)

    pooled = torch.cat(
        [pool(emb.clip, 0), pool(emb.tr1, 1), pool(emb.tr2, 2)], dim=-1
    )
    return torch.tanh(pooled / divider)


def _check(emb, idx, mask):
    clip, tr1, tr2 = emb.clip, emb.tr1, emb.tr2
    dev = clip.device
    if clip.dtype not in _SYMBOLS:
        raise TypeError("fused_ctx_pool tables must be float32 or bfloat16; "
                        "got %s" % clip.dtype)
    for name, t in (("tr1", tr1), ("tr2", tr2)):
        if t.dtype != clip.dtype:
            raise TypeError("fused_ctx_pool tables must share one dtype; "
                            "clip %s, %s %s" % (clip.dtype, name, t.dtype))
    for name, t in (("clip", clip), ("tr1", tr1), ("tr2", tr2),
                    ("idx", idx), ("mask", mask)):
        if t.device != dev:
            raise ValueError("fused_ctx_pool: %s is on %s, clip on %s"
                             % (name, t.device, dev))
        if not t.is_contiguous():
            raise ValueError("fused_ctx_pool: %s must be contiguous" % name)
    if clip.dim() != 2 or tr1.dim() != 2 or tr1.shape != tr2.shape:
        raise ValueError("fused_ctx_pool tables: clip [Nc, dc], tr1/tr2 "
                         "[Nt, dt]; got %s %s %s" % (
                             tuple(clip.shape), tuple(tr1.shape),
                             tuple(tr2.shape)))
    if idx.dtype != torch.int32 or idx.dim() != 3 or idx.shape[2] != 3:
        raise ValueError("fused_ctx_pool idx must be int32 [M, R, 3]; got "
                         "%s %s" % (idx.dtype, tuple(idx.shape)))
    M, R = idx.shape[0], idx.shape[1]
    if mask.dtype != torch.float32 or tuple(mask.shape) != (M, R):
        raise ValueError("fused_ctx_pool mask must be float32 [%d, %d]; got "
                         "%s %s" % (M, R, mask.dtype, tuple(mask.shape)))
    if not 1 <= R <= MAX_CONTEXT:
        raise ValueError("fused_ctx_pool needs 1 <= R <= %d; got %d"
                         % (MAX_CONTEXT, R))
    if M >= 2**31 or clip.shape[1] + 2 * tr1.shape[1] >= 2**31:
        raise ValueError("fused_ctx_pool: M and the row width must fit in "
                         "an int32")


def _kernel_fn(dtype):
    from lirec_tpu_torch.ops import build

    fn = getattr(build.load(_SOURCE), _SYMBOLS[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_ctx_pool(emb, idx: torch.Tensor, mask: torch.Tensor,
                   guard_zero: bool) -> torch.Tensor:
    """tanh(masked mean of the gathered [clip | tr1 | tr2] rows).

    emb: models.tabular.EmbeddedTables (clip [Nc, dc], tr1/tr2 [Nt, dt],
    all float32 or all bfloat16); idx: int32 [M, R, 3]; mask: float32
    [M, R] -> float32 [M, dc + 2 * dt]. Indices must lie in range: the
    kernel does not check them.
    """
    _check(emb, idx, mask)
    shapes = dict(idx=tuple(idx.shape), clip=tuple(emb.clip.shape),
                  tr=tuple(emb.tr1.shape), table_dtype=str(emb.clip.dtype))
    name = KERNEL_NAMES[emb.clip.dtype]
    if emb.clip.device.type == "cpu":
        dispatch.record(name, "reference", "cpu tensors", shapes)
        return fused_ctx_pool_reference(emb, idx, mask, guard_zero)
    if emb.clip.device.type != "cuda":
        raise ValueError("fused_ctx_pool: no kernel for device %s"
                         % emb.clip.device)
    M, R = idx.shape[0], idx.shape[1]
    d_clip, d_tr = emb.clip.shape[1], emb.tr1.shape[1]
    out = torch.empty((M, d_clip + 2 * d_tr), dtype=torch.float32,
                      device=emb.clip.device)
    if M == 0:
        return out
    fn = _kernel_fn(emb.clip.dtype)
    dispatch.record(name, "cuda", "cuda tensors", shapes)
    with torch.cuda.device(emb.clip.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(emb.clip.data_ptr(), emb.tr1.data_ptr(), emb.tr2.data_ptr(),
                 idx.data_ptr(), mask.data_ptr(), out.data_ptr(), M, R,
                 d_clip, d_tr, int(bool(guard_zero)), stream)
    if err != 0:
        raise RuntimeError("%s launch failed: cudaError %d" % (name, err))
    dispatch.count_launch(name)
    return out
