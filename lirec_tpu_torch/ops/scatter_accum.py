"""Scatter-accumulate into the h1 tables: the backward of the train path's
gathers, as one deterministic CUDA kernel.

    acc_t[idx[u, t]] += g_t[u]    for every update row u, in the order of u,
                                  f32 accumulation, one table t or three

Counterpart of ``lirec_tpu/ops/scatter_accum.py``. Its three Pallas
kernels (three tables over [N, R, d] updates, the same over [N * R, d],
one table) are one kernel here, ``csrc/scatter_accum.cu``, instantiated
for float32 and bfloat16 updates; it accumulates in float32 and writes
float32 or the tables' bfloat16. ``gather_h1`` is the gather whose
backward runs it.

The kernel wants the updates grouped by destination row: a stable sort of
the row ids (``sort_by_row``, PyTorch's own sort) gives the permutation
and each row's segment, and the kernel then sums every segment in update
order. That order is part of the result: each output column is one f32
chain over its row's updates, so the sum is bitwise the plain version's
in-order sum on the CPU (and the JAX kernels'), and it does not change
from run to run (f32 atomics would).

What bounds it on the card is bytes (each update read once, each output
written once), and on the row every masked ctx slot points at (a quarter
of the updates) the length of that chain. The Hopper design (see the
source's header): a one-block plan kernel lists the column tiles of the
long segments; then, at once on two streams, one block per such tile
streams its update rows through a shared-memory ring with 16-byte
``cp.async`` copies while one warp adds them in order, and warps sum the
short segments from per-lane rings of 16-byte copies, writing untouched
rows as zeros. How the work is cut (``scatter_plan``) and which tables
take 16-byte vectors (``rows_aligned``) is host logic, tested on the
CPU.

``scatter_accum3`` and ``scatter_accum1`` launch the kernel for CUDA
tensors and take the plain versions (``scatter_accum3_reference``,
``scatter_accum1_reference``) only for CPU tensors. For a CUDA tensor they
launch or raise: a missing nvcc or a failed build is an error. Row ids
must lie in range (callers check the host batch): the kernel stays in
bounds whatever the ids, but an id past its table lands in another table.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.ops.gather_pool import rows_aligned

__all__ = [
    "KERNEL_NAMES",
    "gather_h1",
    "launch_sorted",
    "scatter_accum1",
    "scatter_accum1_reference",
    "scatter_accum3",
    "scatter_accum3_reference",
    "scatter_plan",
    "sort_by_row",
]

_SOURCE = "scatter_accum"
_SYMBOLS = {torch.float32: "scatter_accum_f32",
            torch.bfloat16: "scatter_accum_bf16"}
# launch-count keys, one per instantiation (by update dtype)
KERNEL_NAMES = dict(_SYMBOLS)
_OUT_DTYPES = (torch.float32, torch.bfloat16)
# csrc/scatter_accum.cu's constants (checked against the built library):
# the longest segment a warp sums, a hot tile's bytes of an update row,
# the consecutive rows of one warp item
SHORT_MAX = 32
HOT_ROW_BYTES = 128
RUN_ROWS = 8


def scatter_accum1_reference(idx, g, n_rows: int) -> torch.Tensor:
    """Plain version of one table: idx [...] row ids, g [..., d] -> f32
    [n_rows, d] (``index_add_``, which sums in update order on the CPU)."""
    d = g.shape[-1]
    acc = torch.zeros((n_rows, d), dtype=torch.float32, device=g.device)
    return acc.index_add_(0, idx.reshape(-1).long(),
                          g.reshape(-1, d).float())


def scatter_accum3_reference(idx3, g_clip, g_tr1, g_tr2, n_clip: int,
                             n_tr: int):
    """Plain version of the three h1 tables: idx3 [..., 3] (clip, tr1, tr2
    row ids), g_* [..., d] -> f32 ([n_clip, d_clip], [n_tr, d_tr] x 2)."""
    flat = idx3.reshape(-1, 3)
    return (scatter_accum1_reference(flat[:, 0], g_clip, n_clip),
            scatter_accum1_reference(flat[:, 1], g_tr1, n_tr),
            scatter_accum1_reference(flat[:, 2], g_tr2, n_tr))


def sort_by_row(idx: torch.Tensor, rows: Sequence[int]):
    """Order updates by destination: idx [M, n] int row ids of n tables
    with rows[t] rows each -> (perm int64 [M * n]: flat positions
    u * n + t stably sorted by table, then row; offsets int64
    [sum(rows) + 1]: the segment of table t's row r is
    perm[offsets[s]:offsets[s + 1]] with s = rows[0] + ... + rows[t-1] + r).
    """
    n = len(rows)
    # int32 keys (sum(rows) < 2**31): half the radix passes of int64
    key = idx.reshape(-1, n).to(torch.int32, copy=True)
    start = 0
    for t in range(1, n):
        start += rows[t - 1]
        key[:, t] += start
    sorted_key, perm = torch.sort(key.reshape(-1), stable=True)
    offsets = torch.searchsorted(
        sorted_key, torch.arange(sum(rows) + 1, dtype=torch.int32,
                                 device=key.device))
    return perm, offsets


def scatter_plan(rows: Sequence[int], widths: Sequence[int], elem_size: int,
                 n_positions: int, vec: Sequence[bool]) -> dict:
    """How the kernel cuts the work, per table t (rows[t] x widths[t]
    outputs, updates of elem_size bytes, read in 16-byte vectors where
    vec[t]): a warp sums one column tile (32 lanes of 16 / elem_size
    columns, 1 where not vec; `tiles` per row) of RUN_ROWS consecutive
    rows, an item; `items` in all, table after table, (run, tile)
    row-major. A segment of over SHORT_MAX updates is summed
    in hot tiles of HOT_ROW_BYTES / elem_size columns (`hot_tiles` per
    row); `hot_cap` bounds the hot tiles of any n_positions updates and
    sizes the int32 workspace (`workspace_ints`)."""
    n = 16 // elem_size
    tiles = [-(-d // (32 * (n if v else 1))) for d, v in zip(widths, vec)]
    hot_cols = HOT_ROW_BYTES // elem_size
    hot_tiles = [-(-d // hot_cols) for d in widths]
    cap = n_positions // (SHORT_MAX + 1) * max(hot_tiles, default=0)
    return dict(tiles=tiles, hot_tiles=hot_tiles, hot_cols=hot_cols,
                items=sum(-(-r // RUN_ROWS) * t for r, t in zip(rows, tiles)),
                hot_cap=cap,
                workspace_ints=1 + 2 * cap)


def _check(idx, gs, rows, out_dtype):
    dev = idx.device
    dtype = gs[0].dtype
    if dtype not in _SYMBOLS:
        raise TypeError("scatter_accum updates must be float32 or bfloat16; "
                        "got %s" % dtype)
    if out_dtype not in _OUT_DTYPES:
        raise TypeError("scatter_accum writes float32 or bfloat16; got %s"
                        % out_dtype)
    if idx.dtype != torch.int32 or idx.shape[-1] != len(gs):
        raise ValueError("scatter_accum idx must be int32 [..., %d]; got %s "
                         "%s" % (len(gs), idx.dtype, tuple(idx.shape)))
    lead = tuple(idx.shape[:-1])
    for t, g in enumerate(gs):
        if g.dtype != dtype:
            raise TypeError("scatter_accum updates must share one dtype; "
                            "%s and %s" % (dtype, g.dtype))
        if tuple(g.shape[:-1]) != lead:
            raise ValueError("scatter_accum update %d is %s; idx gives %s"
                             % (t, tuple(g.shape), lead))
        if g.device != dev:
            raise ValueError("scatter_accum: update %d is on %s, idx on %s"
                             % (t, g.device, dev))
        if not g.is_contiguous():
            raise ValueError("scatter_accum: update %d must be contiguous" % t)
        if g.shape[-1] >= 2**31:
            raise ValueError("scatter_accum: row width must fit an int32")
    if sum(rows) >= 2**31:
        raise ValueError("scatter_accum: at most 2**31 - 1 output rows")
    if idx.numel() >= 2**31:
        raise ValueError("scatter_accum: at most 2**31 - 1 row ids")


def _library():
    """The built csrc/scatter_accum.cu with its entry points typed."""
    from lirec_tpu_torch.ops import build

    lib = build.load(_SOURCE)
    config = lib.scatter_accum_config
    if config.argtypes is None:
        for symbol in _SYMBOLS.values():
            fn = getattr(lib, symbol)
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                           + [ctypes.c_int64] + [ctypes.c_int] * 2
                           + [ctypes.c_int64] + [ctypes.c_void_p] * 2)
            fn.restype = ctypes.c_int
        config.argtypes, config.restype = [ctypes.c_void_p], None
        got = (ctypes.c_int * 5)()
        config(ctypes.cast(got, ctypes.c_void_p))
        want = (SHORT_MAX, HOT_ROW_BYTES, RUN_ROWS)
        if tuple(got[:3]) != want:
            raise RuntimeError("scatter_accum.cu has kShort, kHotRowBytes, "
                               "kRun %s; the wrapper plans for %s"
                               % (tuple(got[:3]), want))
    return lib


def _scatter(idx, gs, rows, out_dtype):
    """Sort, then launch the kernel for len(gs) tables (1 or 3) on CUDA
    tensors."""
    if idx.device.type != "cuda":
        raise ValueError("scatter_accum: no kernel for device %s" % idx.device)
    outs = [torch.empty((r, g.shape[-1]), dtype=out_dtype, device=idx.device)
            for g, r in zip(gs, rows)]
    if sum(rows) == 0:
        return outs
    perm, offsets = sort_by_row(idx, rows)
    launch_sorted(gs, outs, perm, offsets)
    return outs


def launch_sorted(gs, outs, perm, offsets) -> None:
    """The kernel alone, on updates already ordered by ``sort_by_row``:
    gs [M, d_t] updates (1 or 3 tables, one dtype, contiguous, on one CUDA
    device), outs [rows_t, d_t] preallocated contiguous float32 or
    bfloat16 outputs."""
    if len(gs) not in (1, 3):
        raise ValueError("scatter_accum launches 1 or 3 tables; got %d"
                         % len(gs))
    name = KERNEL_NAMES[gs[0].dtype]
    out_dtype = outs[0].dtype
    shapes = dict(updates=tuple(gs[0].shape[:-1]),
                  rows=tuple(o.shape[0] for o in outs),
                  widths=tuple(g.shape[-1] for g in gs),
                  update_dtype=str(gs[0].dtype), out_dtype=str(out_dtype))
    pad = 3 - len(gs)
    g_ptrs = [g.data_ptr() for g in gs] + [None] * pad
    o_ptrs = [o.data_ptr() for o in outs] + [None] * pad
    n_rows = [o.shape[0] for o in outs] + [0] * pad
    widths = [g.shape[-1] for g in gs] + [0] * pad
    lib = _library()
    fn = getattr(lib, _SYMBOLS[gs[0].dtype])
    vec = [rows_aligned(g) for g in gs]
    flags = sum((v << t) | ((v and o.data_ptr() % 16 == 0) << (3 + t))
                for t, (v, o) in enumerate(zip(vec, outs)))
    plan = scatter_plan(n_rows[:len(gs)], widths[:len(gs)],
                        gs[0].element_size(), perm.numel(), vec)
    # the plan kernel's list of hot tiles, and their count
    workspace = torch.empty(plan["workspace_ints"], dtype=torch.int32,
                            device=perm.device)
    dispatch.record(name, "cuda", "cuda tensors", shapes)
    dispatch.launch(name, fn, gs[0].device, (
        *g_ptrs, *o_ptrs, *n_rows, *widths, len(gs), perm.data_ptr(),
        offsets.data_ptr(), perm.numel(), int(out_dtype == torch.bfloat16),
        flags, plan["hot_cap"], workspace.data_ptr()))


def scatter_accum3(idx3: torch.Tensor, g_clip: torch.Tensor,
                   g_tr1: torch.Tensor, g_tr2: torch.Tensor, n_clip: int,
                   n_tr: int, out_dtype: torch.dtype = torch.float32):
    """acc_t[idx3[..., t]] += g_t for the three h1 tables, f32 accumulation.

    idx3: int32 [..., 3]; g_*: [..., d_*], all float32 or all bfloat16,
    contiguous -> (out_dtype [n_clip, d_clip], [n_tr, d_tr] x 2)."""
    gs = (g_clip, g_tr1, g_tr2)
    rows = (int(n_clip), int(n_tr), int(n_tr))
    _check(idx3, gs, rows, out_dtype)
    if idx3.device.type == "cpu":
        dispatch.record(KERNEL_NAMES[g_clip.dtype], "reference",
                        "cpu tensors", dict(idx=tuple(idx3.shape)))
        return tuple(a.to(out_dtype) for a in scatter_accum3_reference(
            idx3, g_clip, g_tr1, g_tr2, n_clip, n_tr))
    return tuple(_scatter(idx3.reshape(-1, 3), gs, rows, out_dtype))


def scatter_accum1(idx: torch.Tensor, g: torch.Tensor, n_rows: int,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The single-table entry: acc[idx] += g. idx: int32 [...]; g: [..., d]
    float32 or bfloat16, contiguous -> out_dtype [n_rows, d]."""
    rows = (int(n_rows),)
    _check(idx[..., None], (g,), rows, out_dtype)
    if idx.device.type == "cpu":
        dispatch.record(KERNEL_NAMES[g.dtype], "reference", "cpu tensors",
                        dict(idx=tuple(idx.shape)))
        return scatter_accum1_reference(idx, g, n_rows).to(out_dtype)
    return _scatter(idx.reshape(-1, 1), (g,), rows, out_dtype)[0]


class _GatherH1(torch.autograd.Function):
    """Forward: the plain gathers. Backward: the scatter-accumulate, cast
    to the tables' dtypes."""

    @staticmethod
    def forward(ctx, clip, tr1, tr2, idx3, use_kernel):
        ctx.save_for_backward(idx3)
        ctx.tables = (clip.shape[0], tr1.shape[0],
                      clip.dtype, tr1.dtype, tr2.dtype)
        ctx.use_kernel = use_kernel
        i = idx3.long()
        return clip[i[..., 0]], tr1[i[..., 1]], tr2[i[..., 2]]

    @staticmethod
    def backward(ctx, g_clip, g_tr1, g_tr2):
        (idx3,) = ctx.saved_tensors
        n_clip, n_tr, dt_c, dt_1, dt_2 = ctx.tables
        gs = [g.contiguous() for g in (g_clip, g_tr1, g_tr2)]
        if ctx.use_kernel:
            same = dt_c == dt_1 == dt_2
            accs = scatter_accum3(idx3, *gs, n_clip, n_tr,
                                  out_dtype=dt_c if same else torch.float32)
        else:
            accs = scatter_accum3_reference(idx3, *gs, n_clip, n_tr)
        return (accs[0].to(dt_c), accs[1].to(dt_1), accs[2].to(dt_2),
                None, None)


def gather_h1(clip: torch.Tensor, tr1: torch.Tensor, tr2: torch.Tensor,
              idx3: torch.Tensor, use_kernel: bool = True):
    """(clip[idx3[..., 0]], tr1[idx3[..., 1]], tr2[idx3[..., 2]]), whose
    table gradients come from ``scatter_accum3`` (the CUDA kernel for CUDA
    tensors) in the tables' dtypes. use_kernel=False takes the plain
    scatter on any device (for comparisons). idx3: int32 [..., 3]."""
    return _GatherH1.apply(clip, tr1, tr2,
                           idx3.to(torch.int32).contiguous(), use_kernel)
