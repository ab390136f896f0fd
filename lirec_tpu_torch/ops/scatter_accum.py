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
the row ids gives the permutation and each row's segment, and the kernel
then sums every segment in update order. That order is part of the
result: each output column is one f32 chain over its row's updates, so the
sum is bitwise the plain version's in-order sum on the CPU (and the JAX
kernels'), and it does not change from run to run (f32 atomics would).
The sort is a hand-written stable counting sort in the same source
(``count_sort``; its plain version is ``sort_by_row``, PyTorch's own sort,
which no CUDA path calls). Where the [units, rows + 2] count matrix is
small (``sort_plan``) one pass by the whole row: three launches over units
of at most 1,024 positions (per-unit counts; their prefix over the units,
each range scanned; per unit a scan of the ranges' sums and a warp placing
its positions in order). Past it an LSD radix sort by digits of 8 bits in
the manner of onesweep: one launch clears the scratch, one counts every
pass's digits, a launch a pass ranks tiles of 1,280 or 4,096 positions
(early counts, a warp multi-split by ballots, a decoupled look-back over
the earlier tiles, the tile written out by digit) and one launch merges
the sorted rows with 0 .. rows to find the offsets.
Where the updates and outputs are few and narrow (the
int_rels sweep's score table) one launch does everything with no sort
(``launch_small``): a warp per output row walks the update ids in order
and adds the rows that hit, the same chain. ``scatter_path`` is that size
rule.

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
    "SMALL_NAMES",
    "SORT_NAME",
    "count_sort",
    "gather_h1",
    "launch_small",
    "launch_sorted",
    "scatter_accum1",
    "scatter_accum1_reference",
    "scatter_accum3",
    "scatter_accum3_reference",
    "scatter_path",
    "scatter_plan",
    "sort_by_row",
    "sort_plan",
    "sort_updates",
]

_SOURCE = "scatter_accum"
_SYMBOLS = {torch.float32: "scatter_accum_f32",
            torch.bfloat16: "scatter_accum_bf16"}
_SMALL_SYMBOLS = {torch.float32: "scatter_small_f32",
                  torch.bfloat16: "scatter_small_bf16"}
# launch-count keys: the sorted scatter per instantiation (by update
# dtype), the counting sort, and the one-launch path per instantiation
KERNEL_NAMES = dict(_SYMBOLS)
SORT_NAME = "scatter_sort"
SMALL_NAMES = dict(_SMALL_SYMBOLS)
_OUT_DTYPES = (torch.float32, torch.bfloat16)
# csrc/scatter_accum.cu's constants (checked against the built library):
# the longest segment a warp sums, a hot tile's bytes of an update row,
# the consecutive rows of one warp item, the update ids the one-launch
# path stages, the one-pass sort's most ranges of buckets (256 each), the
# most positions of its units (a warp walks a unit in order) and its most
# buckets (16-bit counters in shared memory), the positions of a tile of
# the sort by digits, its most passes (of SORT_DIGIT_BITS) and the merged
# (position, row) items of a block of its offsets' launch
SHORT_MAX = 32
HOT_ROW_BYTES = 128
RUN_ROWS = 8
SMALL_MAX_UPDATES = 12288
SORT_MAX_RANGES = 256
SORT_UNIT = 1024
SORT_MAX_BUCKETS = 1 << 16
SORT_TILE = 4096
SORT_SMALL_TILE = 1280
SORT_MAX_PASSES = 4
SORT_BOUND_ITEMS = 4096
SORT_DIGIT_BITS = 8
# the sort by digits' scratch: every pass's 256 digit counts, then a
# ticket per pass (16-byte padded)
SORT_COUNT_INTS = SORT_MAX_PASSES * (1 << SORT_DIGIT_BITS) + 4
# the sort by digits takes tiles of SORT_TILE positions from
# SORT_LARGE_TILES of them on (a tile an SM), else tiles of
# SORT_SMALL_TILE: on an NVIDIA H100 80GB HBM3 at 700 W (CHANGES.md,
# the sort by digits' redesign) the small tiles were faster up to the train
# step's B = 256 at split-scale tables (0.0498 against 0.0503 ms), the
# large ones from B = 512 (0.0582 against 0.0617)
SORT_LARGE_TILES = 132
# one pass where the [units, rows + 2] count matrix holds at most
# SORT_MATRIX_INTS, past it the passes by digit: on the same card one
# pass was no slower at split-scale tables at B = 64 (68 x 61,442: 0.0385
# against 0.0393 ms), by digit faster from B = 128 (0.0425 against 0.0735)
SORT_MATRIX_INTS = 1 << 22
# the one-launch path: one table of at most SMALL_MAX_WIDTH columns (a
# lane a column), and updates x rows at most SMALL_MAX_WORK (every warp
# walks every id): the int_rels table of B = 64 into 3,072 hashes, the
# largest synthetic shape where the card measured one launch faster than
# the sort and the sorted kernel (0.0211 against 0.0233 ms; 4,096 hashes
# 0.0277 against 0.0241)
SMALL_MAX_WIDTH = 32
SMALL_MAX_WORK = 3137 * 3073


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


def sort_plan(n_positions: int, rows: Sequence[int]) -> dict:
    """How ``count_sort`` sorts n_positions flat positions into rows
    segments: `buckets` = sum(rows) + 2 (a bucket before the rows and one
    after them, for ids out of range); `units` of `unit` positions (a
    multiple of 32, at most SORT_UNIT, the last unit non-empty). One pass
    (`digit_bits` 0, `pass_buckets` = buckets) where buckets <=
    SORT_MAX_BUCKETS and the [units, buckets] count matrix holds at most
    SORT_MATRIX_INTS; its int32 scratch the matrix, the buckets' starts
    within their range and the ranges' sums (SORT_MAX_RANGES). Else
    `passes` = ceil(width / SORT_DIGIT_BITS) by digit (width: the bits of
    the largest bucket), over `tiles` tiles of `tile` positions
    (SORT_TILE from SORT_LARGE_TILES such tiles, else SORT_SMALL_TILE); its
    scratch the digit counts and tickets (SORT_COUNT_INTS), the look-back
    words (`status_ints`: an int64 per pass, tile and digit) and two pairs
    of (buckets, positions) (`keys_ints`), each padded to 16 bytes.
    `scratch_ints` in all."""
    buckets = sum(rows) + 2
    units = max(1, -(-n_positions // SORT_UNIT))
    per = -(-n_positions // units)
    unit = max(32, -(-per // 32) * 32)
    units = max(1, -(-n_positions // unit))
    plan = dict(buckets=buckets, units=units, unit=unit)
    if buckets <= SORT_MAX_BUCKETS and units * buckets <= SORT_MATRIX_INTS:
        hist, vec = -(-units * buckets // 4) * 4, -(-buckets // 4) * 4
        return dict(plan, digit_bits=0, passes=1, pass_buckets=buckets,
                    tile=0, tiles=0, hist_ints=hist, bucket_ints=vec,
                    scratch_ints=hist + vec + SORT_MAX_RANGES)
    width = (buckets - 1).bit_length()
    passes = -(-width // SORT_DIGIT_BITS)
    tile = SORT_TILE if -(-n_positions // SORT_TILE) >= SORT_LARGE_TILES \
        else SORT_SMALL_TILE
    tiles = -(-n_positions // tile)
    status = 2 * passes * tiles << SORT_DIGIT_BITS
    keys = 4 * (-(-n_positions // 4) * 4)
    return dict(plan, digit_bits=SORT_DIGIT_BITS, passes=passes,
                pass_buckets=1 << SORT_DIGIT_BITS, tile=tile, tiles=tiles,
                status_ints=status, keys_ints=keys,
                scratch_ints=SORT_COUNT_INTS + status + keys)


def scatter_path(n_updates: int, rows: Sequence[int],
                 widths: Sequence[int]) -> str:
    """Which launch the scatter takes: "small" (one launch, no sort) for
    one table of at most SMALL_MAX_WIDTH columns where n_updates <=
    SMALL_MAX_UPDATES and n_updates x rows <= SMALL_MAX_WORK; else
    "sorted" (the counting sort, then the sorted kernel)."""
    if (len(rows) == 1 and widths[0] <= SMALL_MAX_WIDTH
            and n_updates <= SMALL_MAX_UPDATES
            and n_updates * rows[0] <= SMALL_MAX_WORK):
        return "small"
    return "sorted"


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
    sizes the int32 list of them at the workspace's front
    (`workspace_ints`), which the counting sort writes."""
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
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for symbol in _SYMBOLS.values():
            fn = getattr(lib, symbol)
            fn.argtypes = ([p] * 6 + [i64] * 3 + [i] * 4 + [p] * 2
                           + [i64] + [i] * 2 + [i64] + [p] * 2)
            fn.restype = ctypes.c_int
        for symbol in _SMALL_SYMBOLS.values():
            fn = getattr(lib, symbol)
            fn.argtypes = [p, p, i64, i, p, i64, i, p]
            fn.restype = ctypes.c_int
        lib.scatter_sort.argtypes = ([p, i] + [i64] * 3 + [i] * 3 + [i64]
                                     + [i] * 2 + [p] * 6 + [i64, p])
        lib.scatter_sort.restype = ctypes.c_int
        lib.scatter_sort_digits.argtypes = ([p, i] + [i64] * 3 + [i] * 3
                                            + [i64, i, i64] + [p] * 6
                                            + [i64, p])
        lib.scatter_sort_digits.restype = ctypes.c_int
        config.argtypes, config.restype = [ctypes.c_void_p], None
        got = (ctypes.c_int * 13)()
        config(ctypes.cast(got, ctypes.c_void_p))
        got = (*got[:3], *got[5:])
        want = (SHORT_MAX, HOT_ROW_BYTES, RUN_ROWS, SMALL_MAX_UPDATES,
                SORT_MAX_RANGES, SORT_UNIT, SORT_MAX_BUCKETS, SORT_TILE,
                SORT_MAX_PASSES, SORT_BOUND_ITEMS, SORT_SMALL_TILE)
        if got != want:
            raise RuntimeError("scatter_accum.cu has kShort, kHotRowBytes, "
                               "kRun, kSmallMaxIds, kMaxRanges, kSortUnit, "
                               "kMaxBuckets, kSortTile, kMaxPasses, "
                               "kBoundItems, kSmallSortTile %s; the wrapper "
                               "plans for %s"
                               % (got, want))
    return lib


def _scatter(idx, gs, rows, out_dtype):
    """The op on CUDA tensors for len(gs) tables (1 or 3): the path
    ``scatter_path`` picks, one launch of the small kernel or the counting
    sort (which also lists the hot tiles) and the sorted kernel."""
    if idx.device.type != "cuda":
        raise ValueError("scatter_accum: no kernel for device %s" % idx.device)
    outs = [torch.empty((r, g.shape[-1]), dtype=out_dtype, device=idx.device)
            for g, r in zip(gs, rows)]
    if sum(rows) == 0:
        return outs
    idx = idx.contiguous()
    widths = [g.shape[-1] for g in gs]
    if scatter_path(idx.shape[0], rows, widths) == "small":
        launch_small(idx.reshape(-1), gs[0], outs[0])
        return outs
    launch_sorted(gs, outs, *sort_updates(idx, gs, rows))
    return outs


def sort_updates(idx, gs, rows):
    """The counting sort of idx [M, n] (contiguous int32, CUDA) into rows
    segments, with the hot tiles of the updates gs listed: (perm,
    offsets, workspace) for ``launch_sorted``."""
    vec = [rows_aligned(g) for g in gs]
    plan = scatter_plan(rows, [g.shape[-1] for g in gs], gs[0].element_size(),
                        idx.numel(), vec)
    return _sort(idx, rows, plan)


def _sort(idx, rows, plan=None):
    """Launch the counting sort of idx [M, n] into rows segments ->
    (perm, offsets, workspace): the workspace's front holds the hot tiles
    of `plan` (a ``scatter_plan``), where one is given."""
    n = len(rows)
    P = idx.numel()
    sp = sort_plan(P, rows)
    front = 0 if plan is None else -(-plan["workspace_ints"] // 4) * 4
    workspace = torch.empty(front + sp["scratch_ints"], dtype=torch.int32,
                            device=idx.device)
    perm = torch.empty(P, dtype=torch.int64, device=idx.device)
    offsets = torch.empty(sum(rows) + 1, dtype=torch.int64,
                          device=idx.device)
    base = workspace.data_ptr()
    scratch = base + 4 * front
    pad = 3 - n
    hot = list(plan["hot_tiles"]) if plan is not None else [0] * n
    cap = 0 if plan is None else plan["hot_cap"]
    lib = _library()
    dispatch.record(SORT_NAME, "cuda", "cuda tensors",
                    dict(positions=P, rows=tuple(rows), units=sp["units"],
                         tiles=sp["tiles"], passes=sp["passes"]))
    head = (idx.data_ptr(), n, *rows, *[0] * pad, *hot, *[0] * pad, P)
    if sp["digit_bits"] == 0:
        local = scratch + 4 * sp["hist_ints"]
        range_sum = local + 4 * sp["bucket_ints"]
        dispatch.launch(SORT_NAME, lib.scatter_sort, idx.device, (
            *head, sp["units"], sp["unit"], perm.data_ptr(),
            offsets.data_ptr(), scratch, local, range_sum, base, cap))
    else:
        status = scratch + 4 * SORT_COUNT_INTS
        keys = status + 4 * sp["status_ints"]
        dispatch.launch(SORT_NAME, lib.scatter_sort_digits, idx.device, (
            *head, sp["tile"], sp["tiles"], perm.data_ptr(),
            offsets.data_ptr(), scratch, status, keys, base, cap))
    return perm, offsets, workspace


def count_sort(idx: torch.Tensor, rows: Sequence[int]):
    """``sort_by_row``'s result from the hand-written counting sort: idx
    int32 [M, n] (contiguous, n = len(rows) = 1 or 3) -> (perm int64
    [M * n], offsets int64 [sum(rows) + 1]), bitwise equal (a stable sort
    is unique) for ids in range. CPU tensors take ``sort_by_row``."""
    rows = tuple(int(r) for r in rows)
    if len(rows) not in (1, 3) or idx.dtype != torch.int32 \
            or not idx.is_contiguous() or idx.numel() % len(rows):
        raise ValueError("count_sort takes a contiguous int32 [M, n] of n = "
                         "1 or 3 tables; got %s %s for %d tables"
                         % (idx.dtype, tuple(idx.shape), len(rows)))
    if sum(rows) + 2 >= 2**31 or idx.numel() >= 2**31:
        raise ValueError("count_sort: at most 2**31 - 3 rows and 2**31 - 1 "
                         "row ids")
    if not dispatch.route(SORT_NAME, "count_sort", idx.device,
                          dict(idx=tuple(idx.shape), rows=rows)):
        return sort_by_row(idx, rows)
    perm, offsets, _ = _sort(idx, rows)
    return perm, offsets


def launch_small(idx, g, out) -> None:
    """The one-launch path alone, one table: idx int32 [M] row ids, g
    [M, d] updates (float32 or bfloat16, contiguous), out [rows, d]
    preallocated contiguous float32 or bfloat16, on one CUDA device; M at
    most SMALL_MAX_UPDATES."""
    M = idx.numel()
    if M > SMALL_MAX_UPDATES:
        raise ValueError("launch_small stages at most %d update ids; got %d"
                         % (SMALL_MAX_UPDATES, M))
    if idx.dtype != torch.int32 or not (idx.is_contiguous()
                                        and g.is_contiguous()
                                        and out.is_contiguous()):
        raise ValueError("launch_small takes contiguous int32 ids, updates "
                         "and output")
    if g.numel() != M * out.shape[-1] or g.shape[-1] != out.shape[-1] \
            or out.dtype not in _OUT_DTYPES:
        raise ValueError("launch_small: %d ids, updates %s, output %s %s"
                         % (M, tuple(g.shape), tuple(out.shape), out.dtype))
    name = SMALL_NAMES[g.dtype]
    dispatch.record(name, "cuda", "cuda tensors", dict(
        updates=M, rows=out.shape[0], width=g.shape[-1],
        update_dtype=str(g.dtype), out_dtype=str(out.dtype)))
    dispatch.launch(name, getattr(_library(), _SMALL_SYMBOLS[g.dtype]),
                    g.device, (g.data_ptr(), out.data_ptr(), out.shape[0],
                               g.shape[-1], idx.data_ptr(), M,
                               int(out.dtype == torch.bfloat16)))


def launch_sorted(gs, outs, perm, offsets, workspace) -> None:
    """The kernel alone, on updates ordered by ``sort_updates`` (its perm,
    offsets and workspace, whose front lists the hot tiles): gs [M, d_t]
    updates (1 or 3 tables, one dtype, contiguous, on one CUDA device),
    outs [rows_t, d_t] preallocated contiguous float32 or bfloat16
    outputs."""
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
    if workspace.numel() < plan["workspace_ints"]:
        raise ValueError("launch_sorted: the workspace holds %d ints, the "
                         "plan %d" % (workspace.numel(),
                                      plan["workspace_ints"]))
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
