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


def _count_sort_model(idx, rows):
    """The CUDA counting sort's algorithm in numpy, on sort_plan's
    geometry. A pass: each unit's digit counts, their exclusive prefix over
    the units and the digits' lengths; each range of 256 digits scanned
    alone, the ranges' sums scanned, a digit's start the two added; then
    each unit's inputs placed 32 at a time in order, a step's equal digits
    ranked by lane (the warp's match), the rank carried from step to step
    by a counter per digit. One pass: the digit is the bucket (bucket 0
    below the rows, S + 1 at or past them) and the starts are the offsets.
    Several (the low digit first): each pass carries the buckets and
    positions in its order to the next, and the offsets are the positions
    whose bucket is at most the row (the offsets kernel's binary
    search)."""
    n = len(rows)
    S = sum(rows)
    sp = sort_plan(idx.size, rows)
    units, unit, bits = sp["units"], sp["unit"], sp["digit_bits"]
    assert (units - 1) * unit < max(idx.size, 1) <= units * unit
    seg0 = np.concatenate([[0], np.cumsum(rows)])[:n]
    flat = idx.reshape(-1).astype(np.int64)
    key = flat + seg0[np.arange(flat.size) % n]
    keys = np.clip(key + 1, 0, S + 1)
    pos = np.arange(flat.size)
    for p in range(sp["passes"]):
        nb = sp["pass_buckets"]
        digit = (keys >> (p * bits)) & (nb - 1) if bits else keys
        hist = np.stack([np.bincount(digit[u * unit:(u + 1) * unit],
                                     minlength=nb) for u in range(units)])
        prefix = np.cumsum(hist, 0) - hist
        total = hist.sum(0)
        local = np.concatenate([np.cumsum(total[r:r + 256]) - total[r:r + 256]
                                for r in range(0, nb, 256)])
        range_sum = np.array([total[r:r + 256].sum()
                              for r in range(0, nb, 256)])
        assert range_sum.size <= sa.SORT_MAX_RANGES
        range_start = np.cumsum(range_sum) - range_sum
        start = range_start[np.arange(nb) // 256] + local
        assert (start == np.cumsum(total) - total).all()
        out_pos = np.full(flat.size, -1, dtype=np.int64)
        out_keys = np.full(flat.size, -1, dtype=np.int64)
        for u in range(units):
            rel = np.zeros(nb, dtype=np.int64)
            for j in range(u * unit, min(flat.size, (u + 1) * unit), 32):
                step = digit[j:min(j + 32, (u + 1) * unit, flat.size)]
                for lane, s in enumerate(step):
                    rank = int((step[:lane] == s).sum())
                    d = start[s] + prefix[u, s] + rel[s] + rank
                    out_pos[d], out_keys[d] = pos[j + lane], keys[j + lane]
                for s, c in zip(*np.unique(step, return_counts=True)):
                    rel[s] += c
        pos, keys = out_pos, out_keys
    if bits:
        return pos, np.searchsorted(keys, np.arange(S + 1), side="right")
    return pos, start[1:]


@pytest.mark.parametrize("case", ["three_tables", "one_table", "into_one_row",
                                  "one_update", "no_updates", "rows_sum_0",
                                  "empty_tables", "skewed_many_units",
                                  "two_passes", "three_passes",
                                  "two_passes_one_table"])
def test_counting_sort_model_is_bitwise_sort_by_row(case, monkeypatch):
    """The counting sort (as a numpy model of its launches) gives
    sort_by_row's perm and offsets bit for bit: 3 and 1 tables, every
    update into one row, a single update, no updates, sum(rows) = 0, empty
    tables (ids 0, which land in the next table's first row or past the
    last), and a padding row with a quarter of the updates over many units
    and ranges (SORT_UNIT cut to 64: 43 units, 2,402 buckets in 10 ranges);
    then the passes by digit, on the same skewed updates with the count
    matrix cut to 2**12 ints (two passes of 6 bits; to 2**11 with
    SORT_MIN_DIGIT 4, three of 4 bits) and on one table of 2,000 rows. On
    the CPU count_sort is sort_by_row itself."""
    rng = np.random.default_rng(len(case))
    rows, M = {"three_tables": ((30, 50, 50), 700),
               "one_table": ((40,), 1500),
               "into_one_row": ((30, 50, 50), 300),
               "one_update": ((30, 50, 50), 1),
               "no_updates": ((30, 50, 50), 0),
               "rows_sum_0": ((0, 0, 0), 0),
               "empty_tables": ((0, 7, 0), 90),
               "skewed_many_units": ((600, 900, 900), 900),
               "two_passes": ((600, 900, 900), 900),
               "three_passes": ((600, 900, 900), 900),
               "two_passes_one_table": ((2000,), 2500)}[case]
    passes = {"two_passes": 2, "three_passes": 3,
              "two_passes_one_table": 2}.get(case, 1)
    if case in ("skewed_many_units", "two_passes", "three_passes"):
        monkeypatch.setattr(sa, "SORT_UNIT", 64)
    if passes > 1:
        monkeypatch.setattr(sa, "SORT_MATRIX_INTS", 1 << (14 - passes))
    if case == "three_passes":
        monkeypatch.setattr(sa, "SORT_MIN_DIGIT", 4)
    n = len(rows)
    idx = np.stack([rng.integers(0, max(r, 1), size=M) for r in rows],
                   1).astype(np.int32)
    if case == "into_one_row":
        idx[:] = [r - 1 for r in rows]
    if case in ("skewed_many_units", "two_passes", "three_passes"):
        idx[rng.random(M) < 0.25] = 0
    want = sort_by_row(torch.from_numpy(idx), rows)
    perm, offsets = _count_sort_model(idx, rows)
    assert sorted(perm.tolist()) == list(range(M * n))
    np.testing.assert_array_equal(perm, want[0].numpy())
    np.testing.assert_array_equal(offsets, want[1].numpy())
    got = count_sort(torch.from_numpy(idx.reshape(-1, n).copy()), rows)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sort_plan(M * n, rows)["passes"] == passes
    if case == "skewed_many_units":
        assert sort_plan(M * n, rows)["units"] > 1
