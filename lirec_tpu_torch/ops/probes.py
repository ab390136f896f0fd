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
probe_hbm_dma`` and ``probe_bf16_pack`` time them beside the pool on the
same runs and the masked gather-sum on the native bf16 table
(ops/gather_pool.py): whether bulk copies of whole runs beat row loads of
the same rows, and whether packed words beat native bf16 rows at equal
(16-byte) load width.

Both kernels have a Hopper design. The run pool is a ring of
shared-memory stages filled by bulk copies (``cp.async.bulk`` on
mbarriers) from one producer lane and drained by consumer warps, in
persistent blocks; its chunk size, stage count and grid are host logic,
``run_pool_plan``. The packed gather-sum is the masked sum's one-table
design on packed words (16-byte lanes of 4 words, rows loaded ahead of
the add chain), on ``gather_pool.gather_plan``'s geometry. Both keep the
arithmetic of their first design operation for operation, so each equals
it, and its reference arithmetic, bit for bit.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version (``*_reference``) only for CPU tensors. For a CUDA tensor it
launches or raises.
"""

from __future__ import annotations

import torch

from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.ops.gather_pool import (
    CARD_SMS, _check, _sms, gather_plan, rows_aligned,
)

__all__ = [
    "run_pool", "run_pool_reference", "run_pool_plan", "pack_bf16",
    "unpack_bf16", "packed_gather_sum", "packed_gather_sum_reference",
    "KERNEL_NAMES", "PROBE_MAX_CONTEXT",
]

_SOURCES = {"run_pool": "probe_hbm_dma",
            "packed_gather_sum": "probe_bf16_pack"}
# launch-count keys, which are also the C symbols
KERNEL_NAMES = {"run_pool": "probe_hbm_dma_f32",
                "packed_gather_sum": "packed_gather_sum"}
# csrc/probe_hbm_dma.cu: consumer threads, 16-byte lanes a consumer thread
# can own, stages the header holds, run rows a chunk can take, and the
# header's bytes (the barriers, then each stage's run flags and weights);
# the plan's stage size and count; a block's opt-in shared memory on an H100
RUN_CONSUMERS = 384
RUN_MAX_LANES = 6
RUN_MAX_STAGES = 8
RUN_MAX_CHUNK_ROWS = 32
RUN_HEADER_BYTES = 128 + RUN_MAX_STAGES * (16 + 4 * RUN_MAX_CHUNK_ROWS)
RUN_STAGE_BYTES = 108 * 1024  # a pooled row's whole runs at R = 18, 1536
RUN_STAGES = 2                # columns: the fastest geometry measured
SMEM_OPTIN = 232448
# the probes' own context limit: they answer layout questions at the eval
# sweep's shapes, and kernel 10 stages a row's whole context at once (the
# product pools take any R, in chunks of gather_pool.CONTEXT_CHUNK)
PROBE_MAX_CONTEXT = 2048


def _check_context(op, R):
    if not 1 <= R <= PROBE_MAX_CONTEXT:
        raise ValueError("%s needs 1 <= R <= %d; got %d"
                         % (op, PROBE_MAX_CONTEXT, R))


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


def run_pool_plan(M: int, R: int, d_clip: int, d_tr: int,
                  sms: int = CARD_SMS, stage_bytes: int = RUN_STAGE_BYTES,
                  stages: int = RUN_STAGES) -> dict:
    """The run pool's geometry. A stage holds rows_per_chunk consecutive
    run rows of each table (clip, then tr1, then tr2: as many whole rows
    of the three as fit in `stage_bytes`, at most R and
    RUN_MAX_CHUNK_ROWS); a pooled row's runs are chunks_per_run chunks, in
    r order, each of them one bulk copy per table into one stage; the ring
    is `stages` stages behind a header of RUN_HEADER_BYTES (barriers, and
    each stage's weights and run flags); one persistent block per SM
    (`grid`, at most M). Raises where one row of the three tables exceeds
    a stage, or its 16-byte lanes exceed what the consumers keep in
    registers (RUN_CONSUMERS x RUN_MAX_LANES lanes: 9,216 columns)."""
    width = d_clip + 2 * d_tr
    row = width * 4
    if row > stage_bytes:
        raise ValueError(
            "run_pool: one row of the three tables (%d columns, %d bytes) "
            "exceeds a stage of %d bytes" % (width, row, stage_bytes))
    if width // 4 > RUN_CONSUMERS * RUN_MAX_LANES:
        raise ValueError("run_pool: %d columns exceed the consumers' %d "
                         "lanes" % (width, RUN_CONSUMERS * RUN_MAX_LANES))
    k = min(R, RUN_MAX_CHUNK_ROWS, stage_bytes // row)
    stage = k * row
    smem = RUN_HEADER_BYTES + stages * stage
    if not 1 <= stages <= RUN_MAX_STAGES or smem > SMEM_OPTIN:
        raise ValueError("run_pool: %d stages of %d bytes do not fit"
                         % (stages, stage))
    return dict(rows_per_chunk=k, chunks_per_run=-(-R // k), stages=stages,
                stage_bytes=stage, smem_bytes=smem, grid=min(M, sms))


def run_pool(emb, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """tanh of the masked mean (divider at least 1) of contiguous runs.

    emb: models.tabular.EmbeddedTables of float32 tables (clip [Nc, dc],
    tr1/tr2 [Nt, dt], dc and dt multiples of 4); idx: int32 [M, R, 3], of
    which only idx[:, 0, :] (the runs' first rows) is read; mask: float32
    [M, R] -> float32 [M, dc + 2 * dt]. On the card the runs stream
    through a ring of shared-memory stages (``run_pool_plan``), so one row
    of the three tables must fit in a stage.
    """
    _check(emb, idx, mask)
    _check_context("run_pool", idx.shape[1])
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
    plan = run_pool_plan(M, R, d_clip, d_tr, _sms(dev))
    out = torch.empty((M, d_clip + 2 * d_tr), dtype=torch.float32,
                      device=dev)
    if M:
        _launch("run_pool", dev, 6, (
            emb.clip.data_ptr(), emb.tr1.data_ptr(), emb.tr2.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), out.data_ptr(), M, R, d_clip,
            d_tr, emb.clip.shape[0], emb.tr1.shape[0],
            plan["rows_per_chunk"], plan["stages"], plan["grid"]))
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
    _check_context("packed_gather_sum", R)
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
    d_half = packed.shape[1]
    out = torch.empty((M, 2 * d_half), dtype=torch.float32,
                      device=packed.device)
    if M:
        vec = rows_aligned(packed)
        plan = gather_plan(M, R, d_half, 4, vec, _sms(packed.device))
        _launch("packed_gather_sum", packed.device, 4, (
            packed.data_ptr(), idx.data_ptr(), mask.data_ptr(),
            out.data_ptr(), M, R, d_half, plan["rows_per_block"],
            plan["slab_lanes"], int(vec)))
    return out
