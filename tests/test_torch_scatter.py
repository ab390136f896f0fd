"""The port's scatter-accumulate and gather_h1 against the JAX package's.

On the CPU the port's wrappers take their plain versions (``index_add_``,
which sums in update order); the JAX side runs its Pallas kernels 6, 7 and
8 of lirec_tpu/ops/scatter_accum.py in interpret mode, as
tests/test_scatter_accum.py does. Both accumulate in f32 in update order,
so they agree bitwise; the stated tolerance (rtol 1e-6) only allows for an
f32 sum order that is not pinned down. The same numpy inputs, made from a
seed, with heavy duplicate rows, go to both. The CUDA kernel is held
against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py); its host half (the stable sort into row segments) is
checked here by summing the segments in torch, and the counting sort that
orders the updates on the card is checked here as a numpy model of its
launches (units, their counts, the prefix over units, the scan, the
placing warp's steps, pass after pass, and the offsets' search) on
``sort_plan``'s geometry, bitwise against ``sort_by_row``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lirec_tpu.ops import scatter_accum as jsa
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.ops import scatter_accum as sa
from lirec_tpu_torch.ops.scatter_accum import (
    KERNEL_NAMES,
    count_sort,
    gather_h1,
    scatter_accum1,
    scatter_accum3,
    scatter_accum3_reference,
    sort_by_row,
    sort_plan,
)

NC, NT, DC, DT = 24, 40, 256, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _updates(N=16, R=6, seed=0, dup_rows=None):
    """idx [N, R, 3] and f32 updates; dup_rows sends every update to the
    first dup_rows rows of each table (heavy duplicates)."""
    rng = np.random.default_rng(seed)
    hi = [NC, NT, NT] if dup_rows is None else [dup_rows] * 3
    idx = rng.integers(0, hi, size=(N, R, 3)).astype(np.int32)
    gs = [rng.standard_normal((N, R, d)).astype(np.float32)
          for d in (DC, DT, DT)]
    return idx, gs


def _as(dtype, arrays):
    """numpy f32 -> (jax arrays, torch tensors) holding the same values in
    `dtype` (bf16 rounding done once, by torch, and handed to JAX)."""
    ts = [torch.from_numpy(a).to(dtype) for a in arrays]
    js = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32) for t in ts]
    return js, ts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dup_rows", [None, 3])
@pytest.mark.parametrize("layout", ["3d", "flat"])
def test_scatter_accum3_matches_pallas_kernels(dtype, dup_rows, layout):
    """Kernel 6 (_make_kernel3, [N, R, d] updates) and kernel 7
    (_make_kernel, updates flattened to [N*R, d]) in interpret mode."""
    idx, gs = _updates(dup_rows=dup_rows, seed=1)
    if layout == "flat":
        idx = idx.reshape(-1, 3)
        gs = [g.reshape(-1, g.shape[-1]) for g in gs]
    jg, tg = _as(dtype, gs)
    want = jsa.scatter_accum3(jnp.asarray(idx), *jg, NC, NT,
                              force="interpret")
    got = scatter_accum3(torch.from_numpy(idx), *tg, NC, NT)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table", [0, 1])
def test_single_table_entry_matches_pallas_kernel(dtype, table):
    """Kernel 8 (_make_kernel1) in interpret mode, duplicates included."""
    idx, gs = _updates(N=16, R=5, seed=2, dup_rows=None if table else 4)
    n_rows = (NC, NT)[table]
    jg, tg = _as(dtype, [gs[table]])
    want = jsa._pallas_call1(jnp.asarray(idx[..., table]), jg[0], n_rows,
                             interpret=True)
    got = scatter_accum1(torch.from_numpy(idx[..., table].copy()), tg[0],
                         n_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_out_dtype_rounds_the_f32_sum():
    """bf16 output = the f32 accumulator rounded to bf16 (as JAX's
    ``acc.astype(bf16)`` in gather_h1's backward)."""
    idx, gs = _updates(seed=3, dup_rows=5)
    tg = [torch.from_numpy(g).bfloat16() for g in gs]
    acc = scatter_accum3(torch.from_numpy(idx), *tg, NC, NT)
    out = scatter_accum3(torch.from_numpy(idx), *tg, NC, NT,
                         out_dtype=torch.bfloat16)
    for a, o in zip(acc, out):
        assert o.dtype == torch.bfloat16
        assert torch.equal(a.bfloat16(), o)


@pytest.mark.parametrize("dup_rows", [None, 2])
def test_row_segments_reproduce_the_in_order_sum(dup_rows):
    """The CUDA path's host half: sort_by_row's permutation and segments,
    summed segment by segment in order as the kernel does, give bitwise the
    plain version's sums; untouched rows are zero."""
    idx, gs = _updates(seed=4, dup_rows=dup_rows)
    tg = [torch.from_numpy(g) for g in gs]
    rows = (NC, NT, NT)
    perm, offsets = sort_by_row(torch.from_numpy(idx).reshape(-1, 3), rows)
    assert perm.dtype == torch.int64 and offsets.dtype == torch.int64
    assert offsets.shape == (sum(rows) + 1,) and int(offsets[-1]) == idx.size
    flat = [g.reshape(-1, g.shape[-1]) for g in tg]
    want = scatter_accum3_reference(torch.from_numpy(idx), *tg, NC, NT)
    seg = 0
    for t, n in enumerate(rows):
        got = torch.zeros_like(want[t])
        for r in range(n):
            members = perm[offsets[seg]:offsets[seg + 1]]
            assert bool((members % 3 == t).all())
            assert bool((members[1:] > members[:-1]).all())  # update order
            for p in members.tolist():
                got[r] += flat[t][p // 3]
            seg += 1
        assert torch.equal(got, want[t])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_h1_grads_match_jax(dtype):
    """gather_h1's forward and table gradients against jax.grad through
    the JAX package's gather_h1 with its kernel in interpret mode (set and
    restored here, as tests/test_scatter_accum.py does). The gradients come
    back in the tables' dtype. Forward: the same gathered values (exact);
    grads: rtol 1e-6 (f32 in-order sums on both sides), and for bf16 the
    same f32 sums rounded to bf16 (equal, or one bf16 ulp where the sum
    orders differ at a rounding boundary)."""
    rng = np.random.default_rng(5)
    idx, _ = _updates(N=8, R=4, seed=5, dup_rows=6)
    tabs = [rng.standard_normal((n, d)).astype(np.float32)
            for n, d in ((NC, DC), (NT, DT), (NT, DT))]
    ws = [rng.standard_normal((8, 4, d)).astype(np.float32)
          for d in (DC, DT, DT)]
    jt, tt = _as(dtype, tabs)
    jw = [jnp.asarray(w) for w in ws]
    tw = [torch.from_numpy(w) for w in ws]

    def jloss(c, a, b):
        outs = jsa.gather_h1(c, a, b, jnp.asarray(idx))
        return sum((o.astype(jnp.float32) * w).sum()
                   for o, w in zip(outs, jw))

    old = jsa._FORCE
    try:
        jsa._FORCE = "interpret"
        want = jax.grad(jloss, argnums=(0, 1, 2))(*jt)
    finally:
        jsa._FORCE = old
    leaves = [t.clone().requires_grad_(True) for t in tt]
    outs = gather_h1(*leaves, torch.from_numpy(idx))
    for o, t, i in zip(outs, tt, range(3)):
        assert torch.equal(o.detach(), t[torch.from_numpy(idx[..., i]).long()])
    sum((o.float() * w).sum() for o, w in zip(outs, tw)).backward()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == dtype
        np.testing.assert_allclose(
            leaf.grad.float().numpy(), np.asarray(w.astype(jnp.float32)),
            rtol=max(1e-6, ulp), atol=0)


def test_gather_h1_plain_and_kernel_paths_agree_on_cpu():
    """use_kernel=False (the comparison path) and the default give the
    same gradients on the CPU, where both take the plain scatter."""
    idx, gs = _updates(N=4, R=3, seed=6)
    rng = np.random.default_rng(6)
    tabs = [torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
            for n, d in ((NC, DC), (NT, DT), (NT, DT))]
    grads = []
    for use_kernel in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in tabs]
        outs = gather_h1(*leaves, torch.from_numpy(idx), use_kernel)
        sum((o * torch.from_numpy(g)).sum()
            for o, g in zip(outs, gs)).backward()
        grads.append([leaf.grad for leaf in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_version_and_checks_raise():
    idx, gs = _updates(N=2, R=3, seed=7)
    tg = [torch.from_numpy(g) for g in gs]
    ti = torch.from_numpy(idx)
    before = dispatch.launches()
    scatter_accum3(ti, *tg, NC, NT)
    assert dispatch.launches() == before  # no kernel launch on the CPU
    assert dispatch.last_dispatch(KERNEL_NAMES[torch.float32])["path"] == \
        "reference"
    with pytest.raises(ValueError, match="int32"):
        scatter_accum3(ti.long(), *tg, NC, NT)
    with pytest.raises(TypeError, match="one dtype"):
        scatter_accum3(ti, tg[0], tg[1].bfloat16(), tg[2], NC, NT)
    with pytest.raises(ValueError, match="contiguous"):
        scatter_accum3(ti, tg[0], tg[1].transpose(0, 1).contiguous()
                       .transpose(0, 1), tg[2], NC, NT)
    with pytest.raises(ValueError, match="update 0"):
        scatter_accum3(ti, tg[0][:1], tg[1], tg[2], NC, NT)
    with pytest.raises(TypeError, match="writes"):
        scatter_accum3(ti, *tg, NC, NT, out_dtype=torch.float16)


@pytest.mark.parametrize("n_rows,batch,width", [(9, 34, 6), (9, 8, 6),
                                                (25, 39, 15), (64, 64, 15)])
def test_single_table_at_int_rels_shapes_matches_pallas_kernel(n_rows, batch,
                                                               width):
    """Kernel 8 (_pallas_call1, interpret mode) at the int_rels sweep's
    score-table shapes (evaluation/packed.py): the table's own rows first,
    one update each, then `batch` score rows into hashed rows, some
    repeated, some rows untouched by them; [n, 1, d] updates (tile_n 1).
    f32, exact: both add in update order from zero."""
    rng = np.random.default_rng(n_rows * 100 + batch)
    table = rng.random((n_rows, width)).astype(np.float32)
    scores = rng.random((batch, width)).astype(np.float32)
    hashes = rng.integers(0, max(1, n_rows // 3), size=batch)
    idx = np.concatenate([np.arange(n_rows), hashes]).astype(np.int32)
    upd = np.concatenate([table, scores])
    want = jsa._pallas_call1(jnp.asarray(idx[:, None]),
                             jnp.asarray(upd[:, None, :]), n_rows,
                             interpret=True, tile_n=1)
    got = scatter_accum1(torch.from_numpy(idx), torch.from_numpy(upd), n_rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sa.scatter_path(len(idx), (n_rows,), (width,)) == "small"


def _ballot(pred):
    return sum(1 << lane for lane, p in enumerate(pred) if p)


def _popc(x):
    return bin(x).count("1")


def _multi_split(digits, valid):
    """A warp's step of 32: per lane its peers (the valid lanes of equal
    digit) from one ballot per digit bit, as sort_tile_kernel finds them."""
    peers = [_ballot(valid)] * 32
    for b in range(sa.SORT_DIGIT_BITS):
        bits = [(d >> b) & 1 for d in digits]
        m = _ballot(bits)
        peers = [p & (m if bit else ~m & 0xFFFFFFFF)
                 for p, bit in zip(peers, bits)]
    return peers


def _rank_tile(digit, n, per_lane):
    """sort_tile_kernel's ranking of a tile's n digits: each warp's counts
    of its keys w * 32 * per_lane + k * 32 + lane (order-free), the
    tile's count of each digit and its start in the tile, each warp's
    counter set to where its run of the digit starts; then step k after
    step k - 1, each lane's place the counter plus its peers below it, the
    lowest peer moving the counter past them. Returns (each key's place in
    the tile, the tile's count of each digit, their starts)."""
    nd = 1 << sa.SORT_DIGIT_BITS
    warps = 8
    warp_of = np.arange(n) // (32 * per_lane)
    count = np.zeros((warps, nd), dtype=np.int64)
    np.add.at(count, (warp_of, digit), 1)
    total = count.sum(0)
    own = np.cumsum(total) - total
    counter = own + np.cumsum(count, 0) - count
    at = np.full(n, -1, dtype=np.int64)
    for w in range(warps):
        for k in range(per_lane):
            i = [w * 32 * per_lane + k * 32 + lane for lane in range(32)]
            valid = [j < n for j in i]
            d = [int(digit[j]) if j < n else 0 for j in i]
            peers = _multi_split(d, valid)
            pre = [int(counter[w, d[lane]]) if valid[lane] else 0
                   for lane in range(32)]
            for lane in range(32):
                below = peers[lane] & ((1 << lane) - 1)
                if valid[lane]:
                    at[i[lane]] = pre[lane] + _popc(below)
                    if below == 0:
                        counter[w, d[lane]] = pre[lane] + _popc(peers[lane])
    return at, total, own


def _bounds_model(keys, S):
    """sort_bounds_kernel: the merge of the sorted buckets with 0 .. S in
    blocks of SORT_BOUND_ITEMS items; a block's cuts by a 32-way search (a
    probe a lane), then each of its 256 threads merges SORT_BOUND_ITEMS /
    256 items from its own diagonal (found by binary search), noting each
    k's count. Returns (offsets, the rows listed as hot)."""
    P = keys.size
    items = P + S + 1
    per = sa.SORT_BOUND_ITEMS // 256
    assert per * 256 == sa.SORT_BOUND_ITEMS
    offsets = np.full(S + 1, -1, dtype=np.int64)
    hot = []

    def cut(d):
        lo, hi = max(0, d - (S + 1)), min(d, P)
        while lo < hi:
            probe = [lo + (hi - 1 - lo) * lane // 31 for lane in range(32)]
            after = [keys[p] <= d - 1 - p for p in probe]
            c = sum(after)
            assert after == [True] * c + [False] * (32 - c)
            if c > 0:
                lo = probe[c - 1] + 1
            if c < 32:
                hi = probe[c]
        return lo

    for d0 in range(0, items, sa.SORT_BOUND_ITEMS):
        d1 = min(d0 + sa.SORT_BOUND_ITEMS, items)
        i0, i1 = cut(d0), cut(d1)
        j0 = d0 - i0
        n, nk = i1 - i0, d1 - i1 - j0
        part = keys[i0:i1]
        found = np.full(nk, -1, dtype=np.int64)
        for diag in range(0, n + nk, per):
            lo, hi = max(0, diag - nk), min(diag, n)
            while lo < hi:
                mid = (lo + hi) // 2
                if part[mid] <= j0 + diag - 1 - mid:
                    lo = mid + 1
                else:
                    hi = mid
            i, j = lo, diag - lo
            for _ in range(diag, min(diag + per, n + nk)):
                if i < n and (j >= nk or part[i] <= j0 + j):
                    i += 1
                else:
                    assert found[j] == -1
                    found[j] = i
                    j += 1
        assert (found >= 0).all() and (offsets[j0:j0 + nk] == -1).all()
        offsets[j0:j0 + nk] = i0 + found
    assert (offsets >= 0).all()
    for k in range(S):
        o = offsets[k]
        if o + sa.SHORT_MAX < P and keys[o + sa.SHORT_MAX] == k + 1:
            hot.append(k)
    return offsets, hot


def _digit_sort_model(buckets, S, sp, wave=3):
    """The sort by digits: every pass's digit counts from the ids and
    their starts; per pass, tiles counted and ranked into digit order,
    then their look-backs, `wave` tiles at a time, the tiles of a wave
    publishing their counts before any looks back and looking back last
    tile first (tile t walks back over the counts of tiles that have not
    found their prefix yet); each tile written out in digit order; then
    the offsets."""
    P = buckets.size
    nd = 1 << sa.SORT_DIGIT_BITS
    tile = sp["tile"]
    assert tile % 256 == 0 and sp["tiles"] == -(-P // tile)
    starts = []
    for p in range(sp["passes"]):
        c = np.bincount((buckets >> (8 * p)) & (nd - 1), minlength=nd)
        starts.append(np.cumsum(c) - c)
    keys, vals = buckets.copy(), np.arange(P)
    for p in range(sp["passes"]):
        digit = (keys >> (8 * p)) & (nd - 1)
        out_keys = np.full(P, -1, dtype=np.int64)
        out_vals = np.full(P, -1, dtype=np.int64)
        status = {}
        for t0 in range(0, sp["tiles"], wave):
            counted = {}
            for t in range(t0, min(t0 + wave, sp["tiles"])):
                lo = t * tile
                n = min(tile, P - lo)
                at, total, own = _rank_tile(digit[lo:lo + n], n, tile // 256)
                status[t] = ["P" if t == 0 else "A", total]
                counted[t] = (lo, n, at, total, own)
            for t in sorted(counted, reverse=True):
                lo, n, at, total, own = counted[t]
                before = np.zeros(nd, dtype=np.int64)
                for d in range(nd):
                    j = t - 1
                    while j >= 0:
                        flag, v = status[j]
                        before[d] += v[d]
                        if flag == "P":
                            break
                        j -= 1
                status[t] = ["P", before + total]
                assert sorted(at.tolist()) == list(range(n))
                tile_keys = np.empty(n, dtype=np.int64)
                tile_vals = np.empty(n, dtype=np.int64)
                tile_keys[at], tile_vals[at] = keys[lo:lo + n], vals[lo:lo + n]
                place = starts[p] + before - own
                dst = place[(tile_keys >> (8 * p)) & (nd - 1)] + np.arange(n)
                assert (out_keys[dst] == -1).all()
                out_keys[dst], out_vals[dst] = tile_keys, tile_vals
        keys, vals = out_keys, out_vals
        assert (vals >= 0).all()
    offsets, hot = _bounds_model(keys, S)
    return vals, offsets, hot


def _count_sort_model(idx, rows):
    """The CUDA counting sort's algorithm in numpy, on sort_plan's
    geometry -> (perm, offsets, the rows listed as hot). Buckets: 0 below
    the rows, 1 + the key for rows, S + 1 at or past them. One pass: each
    unit's bucket counts, their exclusive prefix over the units and the
    buckets' lengths; each range of 256 buckets scanned alone, the ranges'
    sums scanned, a bucket's start the two added; then each unit's inputs
    placed 32 at a time in order, a step's equal buckets ranked by lane
    (the warp's match), the rank carried from step to step by a counter
    per bucket; the starts are the offsets. By digits: ``_digit_sort_model``."""
    n = len(rows)
    S = sum(rows)
    sp = sort_plan(idx.size, rows)
    seg0 = np.concatenate([[0], np.cumsum(rows)])[:n]
    flat = idx.reshape(-1).astype(np.int64)
    key = flat + seg0[np.arange(flat.size) % n]
    keys = np.clip(key + 1, 0, S + 1)
    if sp["digit_bits"]:
        return _digit_sort_model(keys, S, sp)
    units, unit, nb = sp["units"], sp["unit"], sp["buckets"]
    assert (units - 1) * unit < max(idx.size, 1) <= units * unit
    hist = np.stack([np.bincount(keys[u * unit:(u + 1) * unit],
                                 minlength=nb) for u in range(units)])
    prefix = np.cumsum(hist, 0) - hist
    total = hist.sum(0)
    local = np.concatenate([np.cumsum(total[r:r + 256]) - total[r:r + 256]
                            for r in range(0, nb, 256)])
    range_sum = np.array([total[r:r + 256].sum() for r in range(0, nb, 256)])
    assert range_sum.size <= sa.SORT_MAX_RANGES
    range_start = np.cumsum(range_sum) - range_sum
    start = range_start[np.arange(nb) // 256] + local
    assert (start == np.cumsum(total) - total).all()
    perm = np.full(flat.size, -1, dtype=np.int64)
    for u in range(units):
        rel = np.zeros(nb, dtype=np.int64)
        for j in range(u * unit, min(flat.size, (u + 1) * unit), 32):
            step = keys[j:min(j + 32, (u + 1) * unit, flat.size)]
            for lane, s in enumerate(step):
                rank = int((step[:lane] == s).sum())
                perm[start[s] + prefix[u, s] + rel[s] + rank] = j + lane
            for s, c in zip(*np.unique(step, return_counts=True)):
                rel[s] += c
    hot = [s - 1 for s in range(1, S + 1) if total[s] > sa.SHORT_MAX]
    return perm, start[1:], hot


_SORT_CASES = {
    # case: (rows, updates a table, passes)
    "three_tables": ((30, 50, 50), 700, 1),
    "one_table": ((40,), 1500, 1),
    "into_one_row": ((30, 50, 50), 300, 1),
    "one_update": ((30, 50, 50), 1, 1),
    "no_updates": ((30, 50, 50), 0, 1),
    "rows_sum_0": ((0, 0, 0), 0, 1),
    "empty_tables": ((0, 7, 0), 90, 1),
    "skewed_many_units": ((600, 900, 900), 900, 1),
    "two_passes": ((600, 900, 900), 900, 2),
    "three_passes": ((40000, 50000, 50000), 900, 3),
    "two_passes_one_table": ((2000,), 2500, 2),
    "run_across_a_tile": ((1 << 17,), 9000, 3),
    "already_sorted": ((5000,), 9000, 2),
    "reverse_sorted": ((5000,), 9000, 2),
    "seventeen_bits": ((65535,), 3000, 3),
}


@pytest.mark.parametrize("case", list(_SORT_CASES))
def test_counting_sort_model_is_bitwise_sort_by_row(case, monkeypatch):
    """The counting sort (as a numpy model of its launches) gives
    sort_by_row's perm and offsets bit for bit, and lists as hot exactly
    the rows of over SHORT_MAX updates. One pass: 3 and 1 tables, every
    update into one row, a single update, no updates, sum(rows) = 0, empty
    tables (ids 0, which land in the next table's first row or past the
    last), and a padding row with a quarter of the updates over many units
    and ranges (SORT_UNIT cut to 64: 43 units, 2,402 buckets in 10
    ranges). By digits of 8 bits, small tiles of 512 positions
    (SORT_SMALL_TILE cut, the look-back over up to 6 tiles) and blocks of
    1,024 merged items in the offsets' launch (SORT_BOUND_ITEMS cut): the
    same skewed updates with the count matrix cut to 2**12 ints (two
    passes), 140,000 rows (three), one table of 2,000 rows (the matrix cut
    too); then at the shipped tiles: a run of one row across the first
    large tile's end (2**17 rows, three passes, SORT_LARGE_TILES cut to 1:
    tiles of 4,096), ids already sorted (a run of one row across the first
    small tile's end) and sorted in reverse (5,000 rows, two passes, the
    matrix cut), and a width of 17 bits (65,535 rows: the top bucket
    65,536) with ids -1 and 65,535 on both sides of the rows. On the CPU
    count_sort is
    sort_by_row itself."""
    rng = np.random.default_rng(len(case))
    rows, M, passes = _SORT_CASES[case]
    if case == "skewed_many_units":
        monkeypatch.setattr(sa, "SORT_UNIT", 64)
    if case in ("two_passes", "three_passes", "two_passes_one_table"):
        monkeypatch.setattr(sa, "SORT_SMALL_TILE", 512)
        monkeypatch.setattr(sa, "SORT_BOUND_ITEMS", 1024)
    if case in ("two_passes", "two_passes_one_table", "already_sorted",
                "reverse_sorted"):
        monkeypatch.setattr(sa, "SORT_MATRIX_INTS", 1 << 12)
    if case == "run_across_a_tile":
        monkeypatch.setattr(sa, "SORT_LARGE_TILES", 1)
    n = len(rows)
    idx = np.stack([rng.integers(0, max(r, 1), size=M) for r in rows],
                   1).astype(np.int32)
    if case == "into_one_row":
        idx[:] = [r - 1 for r in rows]
    if case in ("skewed_many_units", "two_passes", "three_passes"):
        idx[rng.random(M) < 0.25] = 0
    if case == "run_across_a_tile":
        idx[sa.SORT_TILE - 300:sa.SORT_TILE + 500] = 77
    if case == "already_sorted":
        idx.sort(axis=0)
        lo = sa.SORT_SMALL_TILE - 100
        idx[lo:lo + 1000] = idx[lo]
    if case == "reverse_sorted":
        idx[::-1].sort(axis=0)
    if case == "seventeen_bits":
        idx[rng.random(M) < 0.1] = -1
        idx[rng.random(M) < 0.1] = rows[0]
    want = sort_by_row(torch.from_numpy(idx), rows)
    perm, offsets, hot = _count_sort_model(idx, rows)
    assert sorted(perm.tolist()) == list(range(M * n))
    np.testing.assert_array_equal(perm, want[0].numpy())
    np.testing.assert_array_equal(offsets, want[1].numpy())
    lens = np.diff(want[1].numpy())
    assert sorted(hot) == np.flatnonzero(lens > sa.SHORT_MAX).tolist()
    got = count_sort(torch.from_numpy(idx.reshape(-1, n).copy()), rows)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    sp = sort_plan(M * n, rows)
    assert sp["passes"] == passes
    if case == "skewed_many_units":
        assert sp["units"] > 1
    if case == "run_across_a_tile":
        assert (sp["tile"], sp["tiles"]) == (sa.SORT_TILE, 3)
    if case in ("already_sorted", "reverse_sorted", "seventeen_bits"):
        assert (sp["tile"], sp["digit_bits"]) == (sa.SORT_SMALL_TILE, 8)
