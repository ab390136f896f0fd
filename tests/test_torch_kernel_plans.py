"""The host half of the redesigned pool, scatter and probe kernels, on the
CPU: which tables are read in 16-byte vectors, how a pooled row is cut
into lanes, how the one-table kernels (triple pool, masked sum, packed
gather-sum) cut their rows into blocks and column slabs, how the scatter's
work is cut into warp items and hot tiles, how its counting sort cuts the
positions into units and sizes its scratch, which launch the scatter's
size rule picks, and how the run pool's runs are
cut into bulk-copy chunks of a ring. Each is held against a plain
enumeration, so that what surrounds the kernels stays covered where there
is no card (the kernels themselves are held on the card:
tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from lirec_tpu_torch.ops import gather_pool as gp
from lirec_tpu_torch.ops import probes
from lirec_tpu_torch.ops import scatter_accum as sa


def _view(dtype, n, d, offset):
    """A contiguous [n, d] view starting `offset` elements into a buffer."""
    flat = torch.zeros(n * d + 16, dtype=dtype)
    return flat[offset:offset + n * d].view(n, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_aligned_matches_an_enumeration_of_the_rows(dtype):
    """True exactly where every row is whole 16-byte vectors starting on
    16-byte boundaries (every row's first and last byte enumerated); the
    pool's and the scatter's wrappers decide with the same function."""
    assert sa.rows_aligned is gp.rows_aligned
    rows_aligned = gp.rows_aligned
    esize = torch.tensor([], dtype=dtype).element_size()
    seen = set()
    for d in (1, 3, 4, 8, 250, 256, 1000, 1024):
        for offset in range(9):
            t = _view(dtype, 5, d, offset)
            starts = [t.data_ptr() + r * d * esize for r in range(5)]
            want = all(s % 16 == 0 and (s + d * esize) % 16 == 0
                       for s in starts)
            assert rows_aligned(t) == want, (d, offset)
            seen.add(want)
    assert seen == {True, False}


def _pool_lanes(d_clip, d_tr, elem_size, vec_clip, vec_tr):
    """The 3-table kernel's lanes of one pooled row, enumerated as the
    kernel walks them: (table 0-2, first column in the table, columns); a
    table read in 16-byte vectors has lanes of 16 / elem_size columns, any
    other one column per lane."""
    lanes = []
    for t, (d, vec) in enumerate(((d_clip, vec_clip), (d_tr, vec_tr),
                                  (d_tr, vec_tr))):
        n = 16 // elem_size if vec else 1
        lanes += [(t, c, n) for c in range(0, d, n)]
    return lanes


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("d_clip,d_tr", [(1024, 256), (1000, 250), (40, 24),
                                         (3, 5)])
@pytest.mark.parametrize("vec_clip,vec_tr", [(True, True), (True, False),
                                             (False, False)])
def test_pool_lanes_cover_every_output_column_once(esize, d_clip, d_tr,
                                                   vec_clip, vec_tr):
    """Lanes of a pooled row: every column of the output row exactly once,
    a vector lane inside its table and starting at a multiple of its
    width; the plan counts the same lanes."""
    n = 16 // esize
    vec_clip = vec_clip and d_clip % n == 0  # the wrapper's precondition
    vec_tr = vec_tr and d_tr % n == 0
    lanes = _pool_lanes(d_clip, d_tr, esize, vec_clip, vec_tr)
    widths = (d_clip, d_tr, d_tr)
    start = (0, d_clip, d_clip + d_tr)
    hits = np.zeros(d_clip + 2 * d_tr, dtype=int)
    for t, c, k in lanes:
        assert k == (n if (vec_clip if t == 0 else vec_tr) else 1)
        assert c % k == 0 and c + k <= widths[t]
        hits[start[t] + c:start[t] + c + k] += 1
    assert (hits == 1).all()
    plan = gp.pool_plan(1280, 18, d_clip, d_tr, esize, vec_clip, vec_tr)
    assert plan["lanes"] == len(lanes)


@pytest.mark.parametrize("M,R", [(1280, 18), (7, 1), (41, 64), (3, 2048),
                                 (1, 2049), (64, 4096)]
                         # the rels-only eval's buckets
                         + [(64, r) for r in (2, 4, 8, 16, 32, 64, 128)])
@pytest.mark.parametrize("esize", [4, 2])
def test_pool_plan_blocks_cover_the_rows_within_shared_memory(M, R, esize):
    """Every lane of every pooled row in exactly one block; a block's
    staged indices and weights (16 bytes per entry of a chunk of
    min(R, CONTEXT_CHUNK) entries) within 48 KB at every R; at one chunk
    every lane of a row in one block and about three lanes per thread
    where the row is narrow enough; past one chunk one row a block, at
    most one lane per thread (a thread carries its chains across the
    chunks) and a block per SM (132)."""
    plan = gp.pool_plan(M, R, 1024, 256, esize, True, True)
    rows, slab_lanes, lanes = (plan["rows_per_block"], plan["slab_lanes"],
                               plan["lanes"])
    hits = np.zeros((M, lanes), dtype=int)
    for b in range(-(-M // rows)):
        for y in range(plan["slabs"]):
            hits[b * rows:(b + 1) * rows,
                 y * slab_lanes:(y + 1) * slab_lanes] += 1
    assert (hits == 1).all()
    assert plan["blocks"] == -(-M // rows) * plan["slabs"]
    C = gp.CONTEXT_CHUNK
    assert plan["chunk"] == min(R, C)
    assert rows * min(R, C) * 16 <= gp.POOL_SMEM_BYTES
    if R > C:
        assert rows == 1 and slab_lanes <= gp.POOL_THREADS
        assert plan["blocks"] >= gp.CARD_SMS
        return
    assert plan["slabs"] == 1
    if R <= 18:
        per_thread = rows * plan["lanes"] / gp.POOL_THREADS
        assert 1.5 <= per_thread <= gp.POOL_LANES_PER_THREAD


def _gather_hits(plan, M, width, esize, vec):
    """How many times the one-table kernel writes each output cell,
    enumerated as it walks them: block (x, y) takes pooled rows
    x * rows_per_block .. and lanes y * slab_lanes .. of each, item i of a
    block row i // slab, lane i % slab; a lane is 16 / esize columns where
    vec, else one."""
    hits = np.zeros((M, width), dtype=int)
    rows, slab_lanes, lanes = (plan["rows_per_block"], plan["slab_lanes"],
                               plan["lanes"])
    k = 16 // esize if vec else 1
    for bx in range(-(-M // rows)):
        m0 = bx * rows
        n_rows = min(rows, M - m0)
        for by in range(plan["slabs"]):
            lane0 = by * slab_lanes
            slab = min(slab_lanes, lanes - lane0)
            item = np.arange(n_rows * slab)
            g = item // slab
            lane = lane0 + item - g * slab
            for e in range(k):
                np.add.at(hits, (m0 + g, lane * k + e), 1)
    return hits


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("width", [1536, 1500, 1024, 1000])
@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("M", [1, 64, 1280])
def test_gather_plan_writes_every_output_column_once(M, esize, width,
                                                     offset):
    """Triple pool and masked sum: every column of every output row
    written exactly once, over 16-byte lanes where the rows are whole
    16-byte vectors on 16-byte boundaries (1500 bf16 columns are 3000
    bytes: scalar) and scalar columns for a table off a 16-byte boundary;
    the plan's block count is the grid's."""
    n = 16 // esize
    dtype = torch.float32 if esize == 4 else torch.bfloat16
    vec = gp.rows_aligned(_view(dtype, 4, width, n // 2 if offset else 0))
    assert vec == (not offset and width % n == 0)
    plan = gp.gather_plan(M, 18, width, esize, vec)
    assert plan["lanes"] == (width // n if vec else width)
    hits = _gather_hits(plan, M, width, esize, vec)
    assert (hits == 1).all()
    assert plan["blocks"] == -(-M // plan["rows_per_block"]) * plan["slabs"]


@pytest.mark.parametrize("width", [1536, 1500, 1024, 1000])
@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("R", [1, 9, 18, 64, 2048, 2049, 4096])
@pytest.mark.parametrize("M", [1, 64, 1280])
def test_gather_plan_blocks_cover_the_rows_and_fill_the_card(M, R, esize,
                                                             width):
    """Every pooled row in exactly one block row, every lane in exactly
    one slab; a block's staged indices and weights (8 bytes per entry of
    a chunk of min(R, CONTEXT_CHUNK) entries) within 48 KB; past one
    chunk one row per block and at most one lane per thread (a thread
    carries its chains across the chunks); else at least two lanes per
    thread where shared memory and the rows allow, and no row more than
    that needs; and at least one block per SM (132) wherever M x lanes
    allows it, as at M = 64."""
    vec = width * esize % 16 == 0
    plan = gp.gather_plan(M, R, width, esize, vec)
    rows, slab_lanes = plan["rows_per_block"], plan["slab_lanes"]
    covered = sorted(b * rows + i for b in range(-(-M // rows))
                     for i in range(rows) if b * rows + i < M)
    assert covered == list(range(M))
    slabs = [range(s * slab_lanes, min((s + 1) * slab_lanes, plan["lanes"]))
             for s in range(plan["slabs"])]
    assert [lane for s in slabs for lane in s] == list(range(plan["lanes"]))
    assert all(len(s) > 0 for s in slabs)
    C = gp.CONTEXT_CHUNK
    assert plan["chunk"] == min(R, C)
    assert rows * min(R, C) * 8 <= gp.POOL_SMEM_BYTES
    if R > C:
        assert rows == 1 and slab_lanes <= gp.POOL_THREADS
        if M * plan["lanes"] >= gp.CARD_SMS:
            assert plan["blocks"] >= gp.CARD_SMS
        return
    want = gp.POOL_THREADS * gp.GATHER_LANES_PER_THREAD
    per_block = rows * slab_lanes
    assert rows == 1 or (rows - 1) * slab_lanes < want
    assert (per_block >= want or plan["slabs"] > 1
            or (rows + 1) * R * 8 > gp.POOL_SMEM_BYTES)
    if M * plan["lanes"] >= gp.CARD_SMS:
        assert plan["blocks"] >= gp.CARD_SMS
    if M == 64:
        assert plan["blocks"] >= 132


@pytest.mark.parametrize("width", [1536, 1500, 1000, 40])
@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("M,R", [(1, 2049), (64, 4096), (7, 4097)])
def test_gather_plan_past_one_chunk_gives_each_thread_one_lane(M, R, esize,
                                                               width):
    """Past CONTEXT_CHUNK entries the one-table kernels carry each lane's
    chains in a thread's registers from chunk to chunk: the plan writes
    every output column of every row exactly once, with one pooled row a
    block and no more lanes a block than threads (the launch refuses
    more), and the chunk is CONTEXT_CHUNK."""
    vec = width * esize % 16 == 0
    plan = gp.gather_plan(M, R, width, esize, vec)
    assert plan["chunk"] == gp.CONTEXT_CHUNK < R
    assert plan["rows_per_block"] == 1
    assert plan["slab_lanes"] <= gp.POOL_THREADS
    assert (_gather_hits(plan, M, width, esize, vec) == 1).all()
    assert plan["blocks"] == M * plan["slabs"]


def _item_columns(plan, rows, widths, esize, vec, item):
    """Decode a short item as the kernel does: (table, rows, columns)."""
    t = 0
    first = 0
    runs = [-(-r // sa.RUN_ROWS) for r in rows]
    while item >= first + runs[t] * plan["tiles"][t]:
        first += runs[t] * plan["tiles"][t]
        t += 1
    run, tile = divmod(item - first, plan["tiles"][t])
    n = 16 // esize if vec[t] else 1
    cols = [tile * 32 * n + lane * n + e for lane in range(32)
            for e in range(n)]
    row0 = run * sa.RUN_ROWS
    return (t, list(range(row0, min(row0 + sa.RUN_ROWS, rows[t]))),
            [c for c in cols if c < widths[t]])


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("widths,vec", [((1024, 512, 512), (True,) * 3),
                                        ((1000, 250, 250),
                                         (True, False, False)),
                                        ((40,), (False,))])
def test_scatter_plan_covers_every_output_once(esize, widths, vec):
    """The warp items (runs of RUN_ROWS rows x a column tile) cover every
    (table, row, column) of the outputs exactly once, and each table's
    hot tiles cover its columns exactly once, one HOT_ROW_BYTES line of
    update row each."""
    rows = (17, 5, 8)[:len(widths)]
    plan = sa.scatter_plan(rows, widths, esize, 1000, vec)
    hits = [np.zeros((r, d), dtype=int) for r, d in zip(rows, widths)]
    for item in range(plan["items"]):
        t, rows_of, cols = _item_columns(plan, rows, widths, esize, vec,
                                         item)
        hits[t][np.ix_(rows_of, cols)] += 1
    assert all((h == 1).all() for h in hits)
    assert plan["hot_cols"] * esize == sa.HOT_ROW_BYTES
    for d, n_tiles in zip(widths, plan["hot_tiles"]):
        cols = [k * plan["hot_cols"] + i for k in range(n_tiles)
                for i in range(plan["hot_cols"]) if k * plan["hot_cols"] + i
                < d]
        assert cols == list(range(d))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_hot_cap_holds_every_hot_tile(seed):
    """The workspace holds the hot tiles of any updates: counted from the
    segments of sort_by_row on skewed random ids (a padding row with a
    quarter of the updates, and as many rows of SHORT_MAX + 1 updates as
    fit), never more than hot_cap."""
    rng = np.random.default_rng(seed)
    rows, widths = (300, 500, 500), (1024, 512, 512)
    M = 2000
    idx = rng.integers(1, 300, size=(M, 3)).astype(np.int32)
    idx[rng.random(M) < 0.25] = 0
    if seed == 2:  # every row at SHORT_MAX + 1 updates: the most long rows
        idx = np.repeat(np.arange(M // (sa.SHORT_MAX + 1)),
                        sa.SHORT_MAX + 1)[:, None].repeat(3, 1)
        M = len(idx)
    perm, offsets = sa.sort_by_row(torch.from_numpy(idx.astype(np.int32)),
                                   rows)
    lens = (offsets[1:] - offsets[:-1]).numpy()
    assert int(lens.sum()) == M * 3
    for esize in (4, 2):
        plan = sa.scatter_plan(rows, widths, esize, M * 3, (True,) * 3)
        table = np.repeat(np.arange(3), rows)
        hot = sum(plan["hot_tiles"][t] for t, n in zip(table, lens)
                  if n > sa.SHORT_MAX)
        assert 0 < hot <= plan["hot_cap"]
        assert plan["workspace_ints"] == 1 + 2 * plan["hot_cap"]


@pytest.mark.parametrize("P,rows", [
    (0, (9,)), (1, (9,)), (43, (9,)), (1024, (40,)), (1025, (40,)),
    (69120, (2816, 5376, 5376)), (69120, (12288, 24576, 24576)),
    (69120, (1 << 20,)), (3000, (0, 0, 0)), (70000, ((1 << 31) - 4,)),
    (1 << 21, (1 << 20,)), (1 << 21, (1 << 22,)), (100, (1 << 20,)),
    (10 ** 7, (100,)),
    (10 ** 7, (4000,))])
def test_sort_plan_cuts_every_position_into_one_unit(P, rows):
    """The counting sort's units cover positions 0 .. P - 1 once, in order,
    the last unit non-empty (a block per unit, none idle); a unit is a
    multiple of 32 positions (the walking warp's steps) and at most
    SORT_UNIT whatever the rows. One pass over the buckets where the
    [units, buckets] count matrix holds at most SORT_MATRIX_INTS, in at
    most SORT_MAX_BUCKETS; its scratch holds the matrix, the bucket vector
    and the ranges' sums. Else passes of SORT_DIGIT_BITS that cover every
    bit of the largest bucket, over tiles that cover every position once
    (the last non-empty), of SORT_TILE positions where there are at least
    SORT_LARGE_TILES such tiles, else of SORT_SMALL_TILE; its scratch
    holds the counts and
    tickets, an int64 look-back word per pass, tile and digit, and two
    pairs of (buckets, positions), each 16-byte aligned."""
    sp = sa.sort_plan(P, rows)
    units, unit, nb = sp["units"], sp["unit"], sp["buckets"]
    bits, passes, per = sp["digit_bits"], sp["passes"], sp["pass_buckets"]
    assert nb == sum(rows) + 2
    assert unit % 32 == 0 and 32 <= unit <= sa.SORT_UNIT
    assert units >= 1 and (units - 1) * unit < max(P, 1) <= units * unit
    width = (nb - 1).bit_length()
    one = nb <= sa.SORT_MAX_BUCKETS and units * nb <= sa.SORT_MATRIX_INTS
    assert (passes == 1 and bits == 0) == one
    if one:
        assert per == nb and sp["tiles"] == 0
        assert -(-per // 256) <= sa.SORT_MAX_RANGES
        assert sp["hist_ints"] >= units * per and sp["hist_ints"] % 4 == 0
        assert sp["bucket_ints"] >= per and sp["bucket_ints"] % 4 == 0
        assert sp["scratch_ints"] == (sp["hist_ints"] + sp["bucket_ints"]
                                      + sa.SORT_MAX_RANGES)
    else:
        assert bits == sa.SORT_DIGIT_BITS and per == 1 << bits
        assert (passes - 1) * bits < width <= passes * bits
        assert passes <= sa.SORT_MAX_PASSES
        tiles, tile = sp["tiles"], sp["tile"]
        large = -(-P // sa.SORT_TILE) >= sa.SORT_LARGE_TILES
        assert tile == (sa.SORT_TILE if large else sa.SORT_SMALL_TILE)
        assert tile % 256 == 0
        assert tiles == 0 if P == 0 else (tiles - 1) * tile < P <= tiles * tile
        assert sa.SORT_COUNT_INTS >= sa.SORT_MAX_PASSES * per \
            + sa.SORT_MAX_PASSES and sa.SORT_COUNT_INTS % 4 == 0
        assert sp["status_ints"] == 2 * passes * tiles * per
        assert sp["keys_ints"] == 4 * (-(-P // 4) * 4)
        assert sp["scratch_ints"] == (sa.SORT_COUNT_INTS + sp["status_ints"]
                                      + sp["keys_ints"])
    covered = np.zeros(P if P < 10 ** 6 else 0, dtype=int)
    for u in range(units if P < 10 ** 6 else 0):
        covered[u * unit:min(P, (u + 1) * unit)] += 1
    assert (covered == 1).all()


def test_sort_plan_at_the_train_steps_caps():
    """At the Localizer's caps (23,040 updates of 3 tables into 2,816 /
    5,376 / 5,376 rows): one pass, 68 units of 1,024 positions, whose
    counts fit a block's shared memory as 16-bit pairs (13,570 buckets, 27
    KB) and whose staged walk does too (12 KB of digits, bases and ranks,
    27 KB of counters)."""
    sp = sa.sort_plan(23040 * 3, (2816, 5376, 5376))
    assert (sp["units"], sp["unit"], sp["buckets"]) == (68, 1024, 13570)
    assert (sp["passes"], sp["digit_bits"]) == (1, 0)
    assert (sp["buckets"] + 1) // 2 * 4 <= 200 * 1024
    assert sp["unit"] * 12 + sp["buckets"] * 2 <= 200 * 1024


@pytest.mark.parametrize("P,rows,passes", [
    (69120, (12288, 24576, 24576), 1),   # split-scale tables, B = 64
    (138240, (12288, 24576, 24576), 2),  # B = 128
    (276480, (12288, 24576, 24576), 2),  # B = 256
    (1105920, (12288, 24576, 24576), 2),  # B = 1,024
    (69120, (20000, 25000, 25000), 3),
    (69120, (40000, 50000, 50000), 3),
    (69120, (1 << 17,), 3),
    (69120, (1 << 20,), 3),
    (1 << 21, (1 << 20,), 3),
    (1 << 21, (1 << 22,), 3),
    (3, ((1 << 31) - 4,), 4),
])
def test_sort_plan_past_one_pass_keeps_units_of_1024(P, rows, passes):
    """Past one pass the sort goes by digits of 8 bits: passes = ceil(width
    / 8) of the largest bucket's bits whatever the positions (two at the
    train step's split-scale tables from B = 128, three at 2**17 to 2**22
    rows, four at the most rows), and every position falls in exactly one
    tile; the one-pass units stay SORT_UNIT positions: the
    card tests' and phase 6's cases."""
    sp = sa.sort_plan(P, rows)
    width = (sum(rows) + 1).bit_length()
    assert sp["passes"] == passes
    assert sp["unit"] == min(sa.SORT_UNIT, -(-P // 32) * 32)
    if passes == 1:
        assert sp["units"] * sp["buckets"] <= sa.SORT_MATRIX_INTS
        return
    assert sp["passes"] == -(-width // 8) and sp["digit_bits"] == 8
    tiles = sp["tiles"]
    starts = np.arange(tiles) * sp["tile"]
    ends = np.minimum(starts + sp["tile"], P)
    assert starts[0] == 0 and ends[-1] == P and (ends > starts).all()
    assert (starts[1:] == ends[:-1]).all()


@pytest.mark.parametrize("updates,rows,widths,want", [
    ((43, (9,), (6,), "small")),     # the int_rels fixture's table
    ((17, (9,), (6,), "small")),     # phase 19(d)'s B = 8
    ((1089, (1025,), (15,), "small")),   # B = 64 into 1,024 hashes
    ((3137, (3073,), (15,), "small")),   # 3,072: one launch still faster
    ((4161, (4097,), (15,), "sorted")),  # 4,096: the sort faster
    ((8257, (8193,), (15,), "sorted")),  # B = 64 into 8,192 hashes
    ((0, (9,), (6,), "small")),
    ((43, (9,), (33,), "sorted")),   # wider than a warp's lanes
    ((43, (9,), (520,), "sorted")),
    ((43, (3, 3, 3), (6, 6, 6), "sorted")),  # three tables: the sort
    ((414, (50, 70, 70), (1040, 520, 520), "sorted")),
])
def test_scatter_path_picks_one_launch_for_few_narrow_updates(updates, rows,
                                                              widths, want):
    """The size rule: one launch (no sort) for one table of at most
    SMALL_MAX_WIDTH columns whose updates x rows is at most SMALL_MAX_WORK,
    the sort and the sorted kernel otherwise; at the int_rels shapes it
    picks what the card measured faster."""
    assert sa.scatter_path(updates, rows, widths) == want


def test_scatter_path_thresholds():
    """Each bound of the rule at the value and one past it: the work, the
    ids the one-launch kernel stages in shared memory, the width."""
    rows = 1024
    at = sa.SMALL_MAX_WORK // rows
    assert at * rows <= sa.SMALL_MAX_WORK < (at + 1) * rows
    assert at + 1 <= sa.SMALL_MAX_UPDATES
    assert sa.scatter_path(at, (rows,), (15,)) == "small"
    assert sa.scatter_path(at + 1, (rows,), (15,)) == "sorted"
    cap = sa.SMALL_MAX_UPDATES
    assert sa.scatter_path(cap, (1,), (15,)) == "small"
    assert sa.scatter_path(cap + 1, (1,), (15,)) == "sorted"
    w = sa.SMALL_MAX_WIDTH
    assert sa.scatter_path(8, (9,), (w,)) == "small"
    assert sa.scatter_path(8, (9,), (w + 1,)) == "sorted"


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("d_half", [512, 128, 3])
@pytest.mark.parametrize("M", [1, 64, 1280])
def test_gather_plan_on_packed_words_writes_every_column_once(M, d_half,
                                                              offset):
    """The packed gather-sum (kernel 10) on gather_plan's geometry at
    elem_size 4 over the D/2 packed words: a lane of 4 words (1 where the
    rows are not whole 16-byte vectors on 16-byte boundaries: 3 words, or
    a view off an aligned base) writes its low-half columns j .. and its
    high-half columns D/2 + j ..; every output column of every row is
    written exactly once, and the grid fills the card at M = 64."""
    vec = gp.rows_aligned(_view(torch.int32, 4, d_half, 2 if offset else 0))
    assert vec == (not offset and d_half % 4 == 0)
    plan = gp.gather_plan(M, 18, d_half, 4, vec)
    words = _gather_hits(plan, M, d_half, 4, vec)
    hits = np.concatenate([words, words], axis=1)  # low half, high half
    assert hits.shape == (M, 2 * d_half) and (hits == 1).all()
    if M == 64:
        assert plan["blocks"] >= gp.CARD_SMS


def _run_chunks(plan, R, d_clip, d_tr):
    """The run pool's bulk copies, enumerated in the order the producer
    issues them for one pooled row: (first run row, rows, table, byte
    offset in the stage, bytes), chunk by chunk, clip then tr1 then tr2."""
    k = plan["rows_per_chunk"]
    base = (0, k * d_clip * 4, k * (d_clip + d_tr) * 4)
    copies = []
    for c in range(plan["chunks_per_run"]):
        r0 = c * k
        rows = min(k, R - r0)
        for t, d in enumerate((d_clip, d_tr, d_tr)):
            copies.append((r0, rows, t, base[t], rows * d * 4))
    return copies


@pytest.mark.parametrize("d_clip,d_tr", [(1024, 256), (4, 4), (12, 8),
                                         (1600, 960)])
@pytest.mark.parametrize("R", [1, 2, 18, 37, 64, 2048])
def test_run_pool_plan_chunks_cover_every_run_row_once(R, d_clip, d_tr):
    """Each pooled row's three runs: every row of every run in exactly one
    chunk, the chunks in r order; each chunk one bulk copy of a multiple
    of 16 bytes, on a 16-byte boundary, inside its stage; at most one
    staged weight per header slot; the stages from a 128-byte boundary
    after the header of barriers, weights and flags; the ring and its
    header within a block's 232,448-byte opt-in; every pooled row in
    exactly one persistent block, at most one block per SM; the row's
    16-byte lanes within what the consumer threads own."""
    M = 1280
    plan = probes.run_pool_plan(M, R, d_clip, d_tr)
    seen = {t: [] for t in range(3)}
    for r0, rows, t, offset, n_bytes in _run_chunks(plan, R, d_clip, d_tr):
        assert rows >= 1 and n_bytes % 16 == 0 and offset % 16 == 0
        assert offset + n_bytes <= plan["stage_bytes"]
        seen[t] += range(r0, r0 + rows)
    assert all(seen[t] == list(range(R)) for t in range(3))
    width = d_clip + 2 * d_tr
    assert 1 <= plan["rows_per_chunk"] <= probes.RUN_MAX_CHUNK_ROWS
    assert probes.RUN_HEADER_BYTES % 128 == 0
    assert plan["stage_bytes"] == plan["rows_per_chunk"] * width * 4
    assert plan["stage_bytes"] <= probes.RUN_STAGE_BYTES
    assert plan["smem_bytes"] == (probes.RUN_HEADER_BYTES
                                  + plan["stages"] * plan["stage_bytes"])
    assert plan["smem_bytes"] <= probes.SMEM_OPTIN == 232448
    assert plan["stages"] <= probes.RUN_MAX_STAGES
    assert plan["grid"] == min(M, gp.CARD_SMS)
    walked = sorted(m for b in range(plan["grid"])
                    for m in range(b, M, plan["grid"]))
    assert walked == list(range(M))
    assert width // 4 <= probes.RUN_CONSUMERS * probes.RUN_MAX_LANES


def test_run_pool_plan_raises_where_a_row_exceeds_a_stage():
    """The ring's size depends on neither R nor the width: a row of the
    three tables is refused only where it exceeds a stage or the lanes the
    consumers keep in registers (9,216 columns), at any R up to
    the probes' own PROBE_MAX_CONTEXT; the shipped stage takes a pooled
    row's whole runs at the probe's R = 18, and the plan cuts longer runs
    into chunks."""
    cols = probes.RUN_CONSUMERS * probes.RUN_MAX_LANES * 4
    assert cols == 9216 and cols * 4 <= probes.RUN_STAGE_BYTES
    probes.run_pool_plan(1, probes.PROBE_MAX_CONTEXT, cols - 2048, 1024)
    with pytest.raises(ValueError, match="lanes"):
        probes.run_pool_plan(1, 1, cols - 2044, 1024)
    with pytest.raises(ValueError, match="exceeds a stage"):
        probes.run_pool_plan(1, 1, 4096, 1024, stage_bytes=16 * 1024)
    whole = probes.run_pool_plan(1280, 18, 1024, 256)
    assert whole["rows_per_chunk"] == 18 and whole["chunks_per_run"] == 1
    assert whole["stages"] == 2 and whole["smem_bytes"] <= probes.SMEM_OPTIN
    longer = probes.run_pool_plan(1, 64, 1024, 256)
    assert longer["grid"] == 1 and longer["chunks_per_run"] == 4
