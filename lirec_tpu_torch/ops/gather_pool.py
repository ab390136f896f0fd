"""Context pools: gathers + masked mean + tanh in one CUDA kernel.

    fused_ctx_pool:
    out[m] = tanh([pool(clip, 0) | pool(tr1, 1) | pool(tr2, 2)] / div[m])
    pool(T, k)[m] = sum_r mask[m, r] * T[idx[m, r, k]],  div = sum_r mask

    fused_ctx_pool_triple (the eval sweep's triple tier):
    out[m] = tanh(sum_r mask[m, r] * fused[tidx[m, r]] / div[m])

    gather_masked_sum (no epilogue):
    out[m] = sum_r mask[m, r] * table[idx[m, r]]

    matmul_pool (the triple pool's matmul tier, fused_ctx_pool_triple's
    force="matmul"; no kernel, as in the JAX package):
    out = tanh((S @ fused) / div),  S[m, u] = sum_r mask[m, r] [tidx[m, r] == u]

Counterparts of ``lirec_tpu/ops/gather_pool.fused_ctx_pool``,
``fused_ctx_pool_triple`` and ``gather_masked_sum``. The three TPU tiers of
the 3-table pool (VMEM-resident f32, packed-bf16, HBM-streaming) are one
kernel here, ``csrc/fused_ctx_pool.cu``; the triple pool and the masked sum
are ``csrc/fused_ctx_pool_triple.cu``. Each is instantiated for float32 and
bfloat16 tables and accumulates in float32; the pools write float32, the
masked sum the table's dtype.

The 3-table kernel (redesigned for Hopper) replaces the three TPU tiers
(``_make_fused_kernel``, ``_make_fused_packed_kernel``,
``_make_fused_hbm_kernel``). Its bytes bound counts each distinct row
once, but every pooled row gathers its own R rows of each table, so what
holds it is the traffic from L2 into the SMs (141.6 / 70.8 MB f32 / bf16
at the eval sweep's shapes). It gives each thread 16-byte lanes (4 f32
or 8 bf16 columns of one table) of a few pooled rows per block and
issues a chunk of gathered rows' loads ahead of each add chain. The
arithmetic is fixed, operation for operation: per column an
``__fadd_rn`` chain of ``__fmul_rn(w_r, x_r)`` in r order, the divider
the weights' sum in r order, ``tanhf`` of the product with its
reciprocal. That keeps the triple kernel, the run-pool probe and the
three eval tiers bitwise equal to it. What it reads in 16-byte lanes
and how many pooled rows a block takes is host logic
(``rows_aligned``, ``pool_plan``), tested on the CPU.

The triple pool and the masked sum (redesigned for Hopper) are that
design on one table: 16-byte lanes of a few pooled rows per block, a
chunk of gathered rows loaded ahead of each add chain, 8 staged bytes
per context entry. Where the pooled rows are too few to give every SM a
block (the masked sum at M = 64), ``gather_plan`` cuts each row's lanes
into column slabs over several blocks. The triple pool's operations are
the 3-table kernel's, so the two agree bit for bit; the masked sum's
column is the same ``__fadd_rn`` chain, stored in the table's dtype.

Every pool kernel takes any context length R. A pooled row's indices and
weights are staged in shared memory a chunk of at most CONTEXT_CHUNK
(2,048) entries at a time. Past one chunk every pool kernel takes one
pooled row per block and at most one lane per thread, so a thread
carries its chains and divider in registers from chunk to chunk in r
order: a row of any length is bitwise what one pass over it would give,
and a launch's shared memory stays within 48 KB. At R <= CONTEXT_CHUNK
the kernels run their one-pass instantiation.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version (``*_reference``) only for CPU tensors. For a CUDA tensor it
launches or raises: a missing nvcc or a failed build is an error.
"""

from __future__ import annotations


import torch

from lirec_tpu_torch.ops import dispatch

__all__ = [
    "fused_ctx_pool", "fused_ctx_pool_reference", "pool_plan", "rows_aligned",
    "fused_ctx_pool_triple", "fused_ctx_pool_triple_reference", "matmul_pool",
    "gather_plan", "CONTEXT_CHUNK",
    "gather_masked_sum", "gather_masked_sum_reference", "KERNEL_NAMES",
]

_SOURCES = {"fused_ctx_pool": "fused_ctx_pool",
            "fused_ctx_pool_triple": "fused_ctx_pool_triple",
            "gather_masked_sum": "fused_ctx_pool_triple"}
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# launch-count keys and C symbols, one per (wrapper, table dtype)
KERNEL_NAMES = {(op, dt): "%s_%s" % (op, tag)
                for op in _SOURCES for dt, tag in _DTYPES.items()}
# the most context entries of a pooled row the pool kernels stage in
# shared memory at once (16 bytes each in the 3-table kernel, 8 in the
# one-table kernels); a longer context is walked in chunks of this many
CONTEXT_CHUNK = 2048
# csrc/fused_ctx_pool.cu: threads per block; the plan aims at this many
# 16-byte lanes per thread, within 48 KB of staged indices and weights
POOL_THREADS = 128
POOL_LANES_PER_THREAD = 3
POOL_SMEM_BYTES = 48 * 1024
# csrc/fused_ctx_pool_triple.cu (same threads): at least this many lanes
# per thread (measured better than three on the card)
GATHER_LANES_PER_THREAD = 2
CARD_SMS = 132  # streaming multiprocessors of an H100 SXM


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether every row of the contiguous 2-D tensor `t` is whole 16-byte
    vectors on 16-byte boundaries: the base address and the row's bytes
    are multiples of 16."""
    return t.data_ptr() % 16 == 0 and t.shape[-1] * t.element_size() % 16 == 0


def _one_lane_a_thread(M: int, lanes: int, sms: int) -> dict:
    """Geometry past one chunk, where a thread carries one lane's chains
    from chunk to chunk: one pooled row per block, its lanes cut into
    column slabs of at most POOL_THREADS (a multiple of 32 where there are
    that many), at least `sms` blocks where M x lanes allows."""
    slabs = max(-(-lanes // POOL_THREADS), min(lanes, -(-sms // M)))
    slab_lanes = lanes // slabs
    if slab_lanes >= 32:
        slab_lanes -= slab_lanes % 32
    slabs = -(-lanes // slab_lanes)
    return dict(rows_per_block=1, slab_lanes=slab_lanes, slabs=slabs,
                blocks=M * slabs)


def pool_plan(M: int, R: int, d_clip: int, d_tr: int, elem_size: int,
              vec_clip: bool, vec_tr: bool, sms: int = CARD_SMS) -> dict:
    """Launch geometry of the 3-table kernel: lanes per pooled row, the
    context entries staged at once (`chunk`: min(R, CONTEXT_CHUNK), at
    most what 48 KB holds at 16 bytes an entry), and the blocks. At
    R <= chunk: pooled rows per block (about POOL_LANES_PER_THREAD lanes
    per thread, their index triples and weights within POOL_SMEM_BYTES),
    every lane of a row in one block. Past one chunk: `_one_lane_a_thread`,
    as the one-table kernels."""
    chunk = min(R, CONTEXT_CHUNK, POOL_SMEM_BYTES // 16)
    n = 16 // elem_size
    lanes = ((d_clip // n if vec_clip else d_clip)
             + 2 * (d_tr // n if vec_tr else d_tr))
    if R > chunk:
        return dict(lanes=lanes, chunk=chunk,
                    **_one_lane_a_thread(M, lanes, sms))
    rows = max(1, POOL_THREADS * POOL_LANES_PER_THREAD // lanes)
    rows = min(rows, max(1, POOL_SMEM_BYTES // (16 * R)))
    return dict(lanes=lanes, rows_per_block=rows, slab_lanes=lanes, slabs=1,
                blocks=-(-M // rows), chunk=chunk)


def gather_plan(M: int, R: int, width: int, elem_size: int, vec: bool,
                sms: int = CARD_SMS) -> dict:
    """Launch geometry of the one-table kernels (triple pool, masked sum):
    lanes per pooled row (16-byte vectors where `vec`, else columns), the
    context entries staged at once (`chunk`: min(R, CONTEXT_CHUNK), at
    most what 48 KB holds at 8 bytes an entry), pooled rows per block (at
    least GATHER_LANES_PER_THREAD lanes per thread, their indices and
    weights within POOL_SMEM_BYTES), and, where that leaves fewer than
    `sms` blocks, one row per block with its lanes cut into column slabs
    (slab_lanes, a multiple of 32 where there are that many) so that the
    grid has at least `sms` blocks when M x lanes allows. Past one chunk:
    `_one_lane_a_thread`."""
    chunk = min(R, CONTEXT_CHUNK, POOL_SMEM_BYTES // 8)
    lanes = width // (16 // elem_size) if vec else width
    if R > chunk:
        return dict(lanes=lanes, chunk=chunk,
                    **_one_lane_a_thread(M, lanes, sms))
    rows = -(-POOL_THREADS * GATHER_LANES_PER_THREAD // lanes)
    rows = min(rows, max(1, POOL_SMEM_BYTES // (8 * R)))
    slab_lanes = lanes
    if -(-M // rows) < sms:
        rows = 1
        slabs = min(lanes, -(-sms // M))
        slab_lanes = lanes // slabs  # at least `slabs` slabs
        if slab_lanes >= 32:
            slab_lanes -= slab_lanes % 32
    slabs = -(-lanes // slab_lanes)
    return dict(lanes=lanes, rows_per_block=rows, slab_lanes=slab_lanes,
                slabs=slabs, blocks=-(-M // rows) * slabs, chunk=chunk)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    if R < 1:
        raise ValueError("fused_ctx_pool needs R >= 1; got %d" % R)
    if (M >= 2**31 or 3 * R >= 2**31
            or clip.shape[1] + 2 * tr1.shape[1] >= 2**31):
        raise ValueError("fused_ctx_pool: M, 3 x R and the row width must "
                         "fit in an int32")


def _launch(op, table, n_ptrs, args):
    """Launch `op` for `table`'s dtype on the current stream of its card:
    n_ptrs device pointers, then ints."""
    from lirec_tpu_torch.ops import build

    name = KERNEL_NAMES[(op, table.dtype)]
    fn = build.launcher(_SOURCES[op], name, n_ptrs, len(args) - n_ptrs)
    dispatch.launch(name, fn, table.device, args)


def _route(op, table, shapes):
    return dispatch.route(KERNEL_NAMES[(op, table.dtype)], op, table.device,
                          shapes)


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
        vec_clip = rows_aligned(emb.clip)
        vec_tr = rows_aligned(emb.tr1) and rows_aligned(emb.tr2)
        plan = pool_plan(M, R, d_clip, d_tr, emb.clip.element_size(),
                         vec_clip, vec_tr, _sms(emb.clip.device))
        _launch("fused_ctx_pool", emb.clip, 6, (
            emb.clip.data_ptr(), emb.tr1.data_ptr(), emb.tr2.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), out.data_ptr(), M, R,
            plan["chunk"], d_clip, d_tr, int(bool(guard_zero)),
            plan["rows_per_block"], plan["slab_lanes"], int(vec_clip),
            int(vec_tr)))
    return out


# --------------------------------------------- triple tier (kernel 4), kernel 5


def fused_ctx_pool_triple_reference(fused, tidx, mask, guard_zero: bool):
    """Plain PyTorch version: fused [U, d] rows, tidx [M, R], mask [M, R]
    -> f32 [M, d]. Divides where the kernel multiplies by 1/div."""
    mask = mask.float()
    divider = mask.sum(dim=-1, keepdim=True)
    if guard_zero:
        divider = torch.where(divider == 0, torch.ones_like(divider), divider)
    pooled = (fused[tidx.long()].float() * mask[..., None]).sum(dim=-2)
    return torch.tanh(pooled / divider)


def matmul_pool(fused, tidx, mask, guard_zero: bool) -> torch.Tensor:
    """The matmul tier of the triple pool (counterpart of the JAX
    package's ``_matmul_pool``, plain jnp there, no kernel):
    tanh((S @ fused) / div), where S [M, U] counts, per pooled row, the
    mask's weight on each unique fused row (exact small integers in f32).
    f32 tables multiply in f32 (TF32 must be off on a card: checked);
    bf16 tables multiply S in bf16 (exact: counts up to R) by the bf16
    table with an f32 result (``torch.mm(..., out_dtype=torch.float32)``
    on a card, the f32 product of the same bf16 values on the CPU).
    Against the gather pool only the order of the sum differs (u-order,
    duplicate rows as one multiple)."""
    mask = mask.float()
    M = tidx.shape[0]
    counts = torch.zeros((M, fused.shape[0]), dtype=torch.float32,
                         device=fused.device)
    counts.scatter_add_(1, tidx.long(), mask)
    if fused.dtype == torch.float32:
        if fused.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("matmul_pool multiplies f32 tables in f32; "
                               "TF32 is on (torch.backends.cuda.matmul."
                               "allow_tf32)")
        pooled = counts @ fused
    elif fused.is_cuda:
        pooled = torch.mm(counts.to(fused.dtype), fused,
                          out_dtype=torch.float32)
    else:
        pooled = counts @ fused.float()
    divider = mask.sum(dim=-1, keepdim=True)
    if guard_zero:
        divider = torch.where(divider == 0, torch.ones_like(divider), divider)
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
    if R < 1:
        raise ValueError("%s needs R >= 1; got %d" % (op, R))
    if M >= 2**31 or R >= 2**31 or table.shape[1] >= 2**31:
        raise ValueError("%s: M, R and the row width must fit in an int32"
                         % op)


def _launch_single(op, table, idx, mask, out, extra):
    """Launch a one-table kernel on `gather_plan`'s geometry; `extra`: the
    ints between the width and the plan (the pool's guard)."""
    M, R = idx.shape
    if not M:
        return
    width = table.shape[1]
    vec = rows_aligned(table)
    plan = gather_plan(M, R, width, table.element_size(), vec,
                       _sms(table.device))
    _launch(op, table, 4, (table.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                           out.data_ptr(), M, R, plan["chunk"], width,
                           *extra, plan["rows_per_block"],
                           plan["slab_lanes"], int(vec)))


def fused_ctx_pool_triple(fused: torch.Tensor, tidx: torch.Tensor,
                          mask: torch.Tensor, guard_zero: bool,
                          force: str = "auto") -> torch.Tensor:
    """tanh(masked mean of gathered fused rows): the triple tier.

    fused: float32 or bfloat16 [U, dc + 2 * dt], a batch's unique
    [clip | tr1 | tr2] rows in natural column order; tidx: int32 [M, R]
    into it; mask: float32 [M, R] -> float32 [M, dc + 2 * dt]. The kernel
    adds the same values in the same order as ``fused_ctx_pool`` on the
    corresponding global index triples, so the two agree bit for bit.
    Indices must lie in [0, U): the kernel does not check them.
    force: "auto" (the kernel for CUDA tensors, the plain version for CPU
    ones), "reference" (the plain version) or "matmul" (``matmul_pool``),
    each recorded through ops/dispatch.
    """
    op = "fused_ctx_pool_triple"
    _check_single(op, fused, tidx, mask)
    shapes = dict(tidx=tuple(tidx.shape), fused=tuple(fused.shape),
                  table_dtype=str(fused.dtype))
    if force in ("reference", "matmul"):
        dispatch.record(KERNEL_NAMES[(op, fused.dtype)], force, "forced",
                        shapes)
        return (matmul_pool if force == "matmul"
                else fused_ctx_pool_triple_reference)(fused, tidx, mask,
                                                      guard_zero)
    if force != "auto":
        raise ValueError("%s: force must be 'auto', 'reference' or "
                         "'matmul'; got %r" % (op, force))
    if not _route(op, fused, shapes):
        return fused_ctx_pool_triple_reference(fused, tidx, mask, guard_zero)
    out = torch.empty((tidx.shape[0], fused.shape[1]), dtype=torch.float32,
                      device=fused.device)
    _launch_single(op, fused, tidx, mask, out, (int(bool(guard_zero)),))
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
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    _launch_single(op, table, idx, mask, out, ())
    return out
