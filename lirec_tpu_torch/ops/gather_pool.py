"""Context pools: gathers + masked mean + tanh in one CUDA kernel.

    fused_ctx_pool:
    out[m] = tanh([pool(clip, 0) | pool(tr1, 1) | pool(tr2, 2)] / div[m])
    pool(T, k)[m] = sum_r mask[m, r] * T[idx[m, r, k]],  div = sum_r mask

    fused_ctx_pool_triple (the eval sweep's triple tier):
    out[m] = tanh(sum_r mask[m, r] * fused[tidx[m, r]] / div[m])

    gather_masked_sum (no epilogue):
    out[m] = sum_r mask[m, r] * table[idx[m, r]]

Counterparts of ``lirec_tpu/ops/gather_pool.fused_ctx_pool``,
``fused_ctx_pool_triple`` and ``gather_masked_sum``. The three TPU tiers of
the 3-table pool (VMEM-resident f32, packed-bf16, HBM-streaming) are one
kernel here, ``csrc/fused_ctx_pool.cu``; the triple pool and the masked sum
are ``csrc/fused_ctx_pool_triple.cu``. Each is instantiated for float32 and
bfloat16 tables and accumulates in float32; the pools write float32, the
masked sum the table's dtype.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version (``*_reference``) only for CPU tensors. For a CUDA tensor it
launches or raises: a missing nvcc or a failed build is an error.
"""

from __future__ import annotations

import ctypes

import torch

from lirec_tpu_torch.ops import dispatch

__all__ = [
    "fused_ctx_pool", "fused_ctx_pool_reference",
    "fused_ctx_pool_triple", "fused_ctx_pool_triple_reference",
    "gather_masked_sum", "gather_masked_sum_reference", "KERNEL_NAMES",
]

_SOURCES = {"fused_ctx_pool": "fused_ctx_pool",
            "fused_ctx_pool_triple": "fused_ctx_pool_triple",
            "gather_masked_sum": "fused_ctx_pool_triple"}
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# launch-count keys and C symbols, one per (wrapper, table dtype)
KERNEL_NAMES = {(op, dt): "%s_%s" % (op, tag)
                for op in _SOURCES for dt, tag in _DTYPES.items()}
MAX_CONTEXT = 2048  # at most 16 bytes of shared memory per context entry


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
    if clip.dtype not in _DTYPES:
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


def _kernel_fn(op, dtype, n_ptrs, n_ints):
    """The C launcher of `op` for `dtype` tables: n_ptrs device pointers,
    n_ints ints, then the stream; returns a cudaError_t."""
    from lirec_tpu_torch.ops import build

    fn = getattr(build.load(_SOURCES[op]), KERNEL_NAMES[(op, dtype)])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(op, table, n_ptrs, args):
    """Launch `op` on the current stream of `table`'s card, raise on a
    refused launch, count it."""
    name = KERNEL_NAMES[(op, table.dtype)]
    fn = _kernel_fn(op, table.dtype, n_ptrs, len(args) - n_ptrs)
    with torch.cuda.device(table.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("%s launch failed: cudaError %d" % (name, err))
    dispatch.count_launch(name)


def _route(op, table, shapes):
    """True where the kernel runs (CUDA tensors); False for CPU tensors,
    which take the plain version. Any other device raises."""
    name = KERNEL_NAMES[(op, table.dtype)]
    if table.device.type == "cpu":
        dispatch.record(name, "reference", "cpu tensors", shapes)
        return False
    if table.device.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (op, table.device))
    dispatch.record(name, "cuda", "cuda tensors", shapes)
    return True


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
    if not _route("fused_ctx_pool", emb.clip, shapes):
        return fused_ctx_pool_reference(emb, idx, mask, guard_zero)
    M, R = idx.shape[0], idx.shape[1]
    d_clip, d_tr = emb.clip.shape[1], emb.tr1.shape[1]
    out = torch.empty((M, d_clip + 2 * d_tr), dtype=torch.float32,
                      device=emb.clip.device)
    if M:
        _launch("fused_ctx_pool", emb.clip, 6, (
            emb.clip.data_ptr(), emb.tr1.data_ptr(), emb.tr2.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), out.data_ptr(), M, R, d_clip,
            d_tr, int(bool(guard_zero))))
    return out


# ----------------------------------------------------- triple tier, kernel 5


def fused_ctx_pool_triple_reference(fused, tidx, mask, guard_zero: bool):
    """Plain PyTorch version: fused [U, d] rows, tidx [M, R], mask [M, R]
    -> f32 [M, d]. Divides where the kernel multiplies by 1/div."""
    mask = mask.float()
    divider = mask.sum(dim=-1, keepdim=True)
    if guard_zero:
        divider = torch.where(divider == 0, torch.ones_like(divider), divider)
    pooled = (fused[tidx.long()].float() * mask[..., None]).sum(dim=-2)
    return torch.tanh(pooled / divider)


def gather_masked_sum_reference(table, idx, mask):
    """Plain PyTorch version: [N, D], [M, R], [M, R] -> [M, D] in the
    table's dtype, summed in float32."""
    g = table[idx.long()].float()
    return (g * mask.float()[..., None]).sum(dim=-2).to(table.dtype)


def _check_single(op, table, idx, mask):
    """Checks of the one-table kernels: table [N, D] f32/bf16, idx int32
    [M, R], mask f32 [M, R], all contiguous on one device."""
    if table.dtype not in _DTYPES:
        raise TypeError("%s table must be float32 or bfloat16; got %s"
                        % (op, table.dtype))
    for name, t in (("idx", idx), ("mask", mask)):
        if t.device != table.device:
            raise ValueError("%s: %s is on %s, the table on %s"
                             % (op, name, t.device, table.device))
    for name, t in (("table", table), ("idx", idx), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (op, name))
    if table.dim() != 2:
        raise ValueError("%s table must be [N, D]; got %s"
                         % (op, tuple(table.shape)))
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError("%s idx must be int32 [M, R]; got %s %s"
                         % (op, idx.dtype, tuple(idx.shape)))
    M, R = idx.shape
    if mask.dtype != torch.float32 or tuple(mask.shape) != (M, R):
        raise ValueError("%s mask must be float32 [%d, %d]; got %s %s"
                         % (op, M, R, mask.dtype, tuple(mask.shape)))
    if not 1 <= R <= MAX_CONTEXT:
        raise ValueError("%s needs 1 <= R <= %d; got %d"
                         % (op, MAX_CONTEXT, R))
    if M >= 2**31 or table.shape[1] >= 2**31:
        raise ValueError("%s: M and the row width must fit in an int32" % op)


def fused_ctx_pool_triple(fused: torch.Tensor, tidx: torch.Tensor,
                          mask: torch.Tensor, guard_zero: bool
                          ) -> torch.Tensor:
    """tanh(masked mean of gathered fused rows): the triple tier.

    fused: float32 or bfloat16 [U, dc + 2 * dt], a batch's unique
    [clip | tr1 | tr2] rows in natural column order; tidx: int32 [M, R]
    into it; mask: float32 [M, R] -> float32 [M, dc + 2 * dt]. The kernel
    adds the same values in the same order as ``fused_ctx_pool`` on the
    corresponding global index triples, so the two agree bit for bit.
    Indices must lie in [0, U): the kernel does not check them.
    """
    op = "fused_ctx_pool_triple"
    _check_single(op, fused, tidx, mask)
    shapes = dict(tidx=tuple(tidx.shape), fused=tuple(fused.shape),
                  table_dtype=str(fused.dtype))
    if not _route(op, fused, shapes):
        return fused_ctx_pool_triple_reference(fused, tidx, mask, guard_zero)
    M, R = tidx.shape
    width = fused.shape[1]
    out = torch.empty((M, width), dtype=torch.float32, device=fused.device)
    if M:
        _launch(op, fused, 4, (fused.data_ptr(), tidx.data_ptr(),
                               mask.data_ptr(), out.data_ptr(), M, R, width,
                               int(bool(guard_zero))))
    return out


def gather_masked_sum(table: torch.Tensor, idx: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """sum_r mask[m, r] * table[idx[m, r]].

    table: float32 or bfloat16 [N, D]; idx: int32 [M, R]; mask: float32
    [M, R] -> [M, D] in the table's dtype, accumulated in float32. No
    product path calls it (as in the JAX package). Indices must lie in
    [0, N): the kernel does not check them.
    """
    op = "gather_masked_sum"
    _check_single(op, table, idx, mask)
    shapes = dict(idx=tuple(idx.shape), table=tuple(table.shape),
                  table_dtype=str(table.dtype))
    if not _route(op, table, shapes):
        return gather_masked_sum_reference(table, idx, mask)
    M, R = idx.shape
    out = torch.empty((M, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if M:
        _launch(op, table, 4, (table.data_ptr(), idx.data_ptr(),
                               mask.data_ptr(), out.data_ptr(), M, R,
                               table.shape[1]))
    return out
