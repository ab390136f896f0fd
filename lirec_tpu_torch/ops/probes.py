"""The two probe kernels: the run pool and the packed-bf16 gather-sum.

    run_pool (csrc/probe_hbm_dma.cu):
    out[m] = tanh([pool(clip, 0) | pool(tr1, 1) | pool(tr2, 2)] * inv[m])
    pool(T, k)[m] = sum_r mask[m, r] * T[idx[m, 0, k] + r]
    inv[m] = 1 / max(sum_r mask[m, r], 1)

    packed_gather_sum (csrc/probe_bf16_pack.cu):
    out[m] = sum_r mask[m, r] * unpack_bf16(packed)[idx[m, r]]

Counterparts of the TPU probes ``tools/probe_hbm_dma.py`` (the per-run
DMA kernel) and ``tools/probe_bf16_pack.py`` (the packed-int32 bf16
layout). Neither is on a product path: ``lirec_tpu_torch.tools.
probe_hbm_dma`` and ``probe_bf16_pack`` time them beside the pool and the
masked gather-sum (ops/gather_pool.py) to measure what row-load issue and
row-load width cost on the card.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version (``*_reference``) only for CPU tensors. For a CUDA tensor it
launches or raises.
"""

from __future__ import annotations

import ctypes

import torch

from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.ops.gather_pool import MAX_CONTEXT, _check

__all__ = [
    "run_pool", "run_pool_reference", "pack_bf16", "unpack_bf16",
    "packed_gather_sum", "packed_gather_sum_reference", "KERNEL_NAMES",
]

_SOURCES = {"run_pool": "probe_hbm_dma",
            "packed_gather_sum": "probe_bf16_pack"}
# launch-count keys, which are also the C symbols
KERNEL_NAMES = {"run_pool": "probe_hbm_dma_f32",
                "packed_gather_sum": "packed_gather_sum"}
_SMEM_OPTIN: dict = {}  # device index -> opt-in shared bytes per block


def _lib(op):
    from lirec_tpu_torch.ops import build

    return build.load(_SOURCES[op])


def _launch(op, device, n_ptrs, args):
    """Launch `op` on the current stream of `device`: n_ptrs device
    pointers, then ints."""
    from lirec_tpu_torch.ops import build

    name = KERNEL_NAMES[op]
    fn = build.launcher(_SOURCES[op], name, n_ptrs, len(args) - n_ptrs)
    dispatch.launch(name, fn, device, args)


# ------------------------------------------------------ run pool, kernel 9


def run_pool_reference(emb, idx, mask):
    """Plain PyTorch version: the f32 [M, dc + 2 * dt] pool of the runs
    idx[m, 0, k] .. idx[m, 0, k] + R - 1, in the kernel's arithmetic (the
    masked sum times 1 / max(sum mask, 1)). A run that leaves its table
    gives NaN, as the kernel does."""
    R = idx.shape[1]
    mask = mask.float()
    inv = 1.0 / mask.sum(dim=-1, keepdim=True).clamp_min(1.0)
    starts = idx[:, 0, :].long()
    steps = torch.arange(R, device=idx.device)
    w = mask[..., None]

    def pool(tab, k):
        n = tab.shape[0]
        s = starts[:, k]
        ok = (s >= 0) & (s <= n - R)
        rows = (s.clamp(0, max(n - R, 0))[:, None] + steps).clamp(max=n - 1)
        pooled = (tab[rows].float() * w).sum(dim=-2)
        return torch.where(ok[:, None], pooled,
                           torch.full_like(pooled, float("nan")))

    pooled = torch.cat([pool(emb.clip, 0), pool(emb.tr1, 1),
                        pool(emb.tr2, 2)], dim=-1)
    return torch.tanh(pooled * inv)


def _smem_optin(device):
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SMEM_OPTIN:
        fn = _lib("run_pool").probe_hbm_dma_smem_optin
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        _SMEM_OPTIN[index] = fn(index)
    return _SMEM_OPTIN[index]


def _smem_bytes(R, d_clip, d_tr):
    fn = _lib("run_pool").probe_hbm_dma_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn(R, d_clip, d_tr)


def run_pool(emb, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """tanh of the masked mean (divider at least 1) of contiguous runs.

    emb: models.tabular.EmbeddedTables of float32 tables (clip [Nc, dc],
    tr1/tr2 [Nt, dt], dc and dt multiples of 4); idx: int32 [M, R, 3], of
    which only idx[:, 0, :] (the runs' first rows) is read; mask: float32
    [M, R] -> float32 [M, dc + 2 * dt]. On the card the R rows of a run
    come in as one bulk copy into shared memory, so R x (dc + 2 dt) x 4
    bytes must fit in a block's shared memory.
    """
    _check(emb, idx, mask)
    if emb.clip.dtype != torch.float32:
        raise TypeError("run_pool tables must be float32; got %s"
                        % emb.clip.dtype)
    M, R = idx.shape[0], idx.shape[1]
    d_clip, d_tr = emb.clip.shape[1], emb.tr1.shape[1]
    if d_clip % 4 or d_tr % 4:
        raise ValueError("run_pool: a row must be a multiple of 16 bytes "
                         "(the bulk copy's unit); got widths %d, %d"
                         % (d_clip, d_tr))
    shapes = dict(idx=tuple(idx.shape), clip=tuple(emb.clip.shape),
                  tr=tuple(emb.tr1.shape))
    dev = emb.clip.device
    if not dispatch.route(KERNEL_NAMES["run_pool"], "run_pool", dev,
                          shapes):
        return run_pool_reference(emb, idx, mask)
    for name, t in (("clip", emb.clip), ("tr1", emb.tr1), ("tr2", emb.tr2)):
        if t.data_ptr() % 16:
            raise ValueError("run_pool: %s must be 16-byte aligned" % name)
    need, limit = _smem_bytes(R, d_clip, d_tr), _smem_optin(dev)
    if need > limit:
        raise ValueError(
            "run_pool: a run of R = %d rows of %d columns needs %d bytes of "
            "shared memory; the card allows %d per block"
            % (R, d_clip + 2 * d_tr, need, limit))
    out = torch.empty((M, d_clip + 2 * d_tr), dtype=torch.float32,
                      device=dev)
    if M:
        _launch("run_pool", dev, 6, (
            emb.clip.data_ptr(), emb.tr1.data_ptr(), emb.tr2.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), out.data_ptr(), M, R, d_clip,
            d_tr, emb.clip.shape[0], emb.tr1.shape[0]))
    return out


# --------------------------------------- packed-bf16 gather-sum, kernel 10


def pack_bf16(table: torch.Tensor) -> torch.Tensor:
    """float [N, D] -> int32 [N, D/2]: word d holds bf16(column d) in its
    low half and bf16(column d + D/2) in its high half (bit for bit the
    TPU probe's ``pack``). A layout operation, on the table's device."""
    if table.dim() != 2 or table.shape[1] % 2:
        raise ValueError("pack_bf16 needs [N, D] with D even; got %s"
                         % (tuple(table.shape),))
    b = table.to(torch.bfloat16).view(torch.int16)
    half = b.shape[1] // 2
    pair = torch.stack([b[:, :half], b[:, half:]], dim=-1).contiguous()
    return pair.view(torch.int32).reshape(b.shape[0], half)


def unpack_bf16(packed: torch.Tensor) -> torch.Tensor:
    """int32 [N, D/2] -> the bf16 [N, D] table that ``pack_bf16`` packed."""
    pair = packed.contiguous().view(torch.bfloat16).reshape(
        packed.shape[0], packed.shape[1], 2)
    return torch.cat([pair[..., 0], pair[..., 1]], dim=-1)


def packed_gather_sum_reference(packed, idx, mask):
    """Plain PyTorch version: unpack, gather, f32 masked sum -> f32
    [M, D]."""
    table = unpack_bf16(packed).float()
    return (table[idx.long()] * mask.float()[..., None]).sum(dim=-2)


def _check_packed(packed, idx, mask):
    for name, t in (("packed", packed), ("idx", idx), ("mask", mask)):
        if t.device != packed.device:
            raise ValueError("packed_gather_sum: %s is on %s, the table on "
                             "%s" % (name, t.device, packed.device))
        if not t.is_contiguous():
            raise ValueError("packed_gather_sum: %s must be contiguous"
                             % name)
    if packed.dtype != torch.int32 or packed.dim() != 2:
        raise ValueError("packed_gather_sum table must be int32 [N, D/2]; "
                         "got %s %s" % (packed.dtype, tuple(packed.shape)))
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError("packed_gather_sum idx must be int32 [M, R]; got "
                         "%s %s" % (idx.dtype, tuple(idx.shape)))
    M, R = idx.shape
    if mask.dtype != torch.float32 or tuple(mask.shape) != (M, R):
        raise ValueError("packed_gather_sum mask must be float32 [%d, %d]; "
                         "got %s %s" % (M, R, mask.dtype, tuple(mask.shape)))
    if not 1 <= R <= MAX_CONTEXT:
        raise ValueError("packed_gather_sum needs 1 <= R <= %d; got %d"
                         % (MAX_CONTEXT, R))
    if M >= 2**31 or 2 * packed.shape[1] >= 2**31:
        raise ValueError("packed_gather_sum: M and the row width must fit "
                         "in an int32")


def packed_gather_sum(packed: torch.Tensor, idx: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """sum_r mask[m, r] * bf16 row idx[m, r] of a packed table, in f32.

    packed: int32 [N, D/2] from ``pack_bf16``; idx: int32 [M, R] in
    [0, N) (the kernel does not check them); mask: float32 [M, R] ->
    float32 [M, D].
    """
    _check_packed(packed, idx, mask)
    shapes = dict(idx=tuple(idx.shape), packed=tuple(packed.shape))
    if not dispatch.route(KERNEL_NAMES["packed_gather_sum"],
                          "packed_gather_sum", packed.device, shapes):
        return packed_gather_sum_reference(packed, idx, mask)
    M, R = idx.shape
    out = torch.empty((M, 2 * packed.shape[1]), dtype=torch.float32,
                      device=packed.device)
    if M:
        _launch("packed_gather_sum", packed.device, 4, (
            packed.data_ptr(), idx.data_ptr(), mask.data_ptr(),
            out.data_ptr(), M, R, packed.shape[1]))
    return out
