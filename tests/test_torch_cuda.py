"""The CUDA kernels (ctx pools, masked gather-sum, scatter-accumulate)
against their plain PyTorch versions, one train step, and the one-dispatch
sweeps' CUDA graphs against their eager steps, on the card.

Marked ``cuda``: these skip without a CUDA device. The file imports no jax,
so it runs on a machine without it:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from lirec_tpu_torch.models.tabular import EmbeddedTables
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.ops import scatter_accum as sa
from lirec_tpu_torch.ops.gather_pool import (
    KERNEL_NAMES,
    fused_ctx_pool,
    fused_ctx_pool_reference,
    fused_ctx_pool_triple,
    fused_ctx_pool_triple_reference,
    gather_masked_sum,
    gather_masked_sum_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(device, dtype, M=37, R=18, Nc=50, Nt=70, Dc=40, Dt=24, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    emb = EmbeddedTables(*(
        torch.randn(n, d, device=device, generator=g).to(dtype)
        for n, d in ((Nc, Dc), (Nt, Dt), (Nt, Dt))
    ))
    idx = torch.stack(
        [torch.randint(0, n, (M, R), device=device, generator=g)
         for n in (Nc, Nt, Nt)], dim=-1,
    ).to(torch.int32).contiguous()
    mask = (torch.rand(M, R, device=device, generator=g) < 0.5).float()
    mask[:, 2] = 1.0
    mask[3] = 0.0
    return emb, idx, mask


@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-6),
                                        (torch.bfloat16, 1e-5)])
def test_kernel_matches_plain_version(cuda, dtype, atol, guard):
    """Ragged widths (40 / 24, not multiples of the block), an empty row.
    f32: one-ulp differences (1/div against a divide, sum order); bf16: the
    same bf16 values on both sides, f32 sums."""
    emb, idx, mask = _inputs(cuda, dtype)
    name = KERNEL_NAMES[("fused_ctx_pool", dtype)]
    before = dispatch.launches(name)
    got = fused_ctx_pool(emb, idx, mask, guard)
    torch.cuda.synchronize()
    assert dispatch.launches(name) == before + 1
    want = fused_ctx_pool_reference(emb, idx, mask, guard)
    assert torch.equal(got.isnan(), want.isnan())
    assert bool(got[3].isnan().all()) != guard
    torch.testing.assert_close(got, want, rtol=0, atol=atol, equal_nan=True)


def _off16(t):
    """A contiguous copy of `t` whose rows start off a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = flat[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


def _edge_inputs(device, dtype, R, Dc, Dt, M=41, Nc=60, Nt=80, seed=5):
    """Indices with heavy duplicates, 0/1 and fractional weights, and two
    rows without context (3 and the last)."""
    g = torch.Generator(device=device).manual_seed(seed)
    emb = EmbeddedTables(*(
        torch.randn(n, d, device=device, generator=g).to(dtype)
        for n, d in ((Nc, Dc), (Nt, Dt), (Nt, Dt))))
    idx = torch.stack(
        [torch.randint(0, n, (M, R), device=device, generator=g)
         for n in (Nc, Nt, Nt)], dim=-1).to(torch.int32).contiguous()
    mask = (torch.rand(M, R, device=device, generator=g) < 0.6).float()
    mask[1::3] *= 0.25 + torch.rand(M, R, device=device, generator=g)[1::3]
    mask[:, 0] = 1.0
    if M > 3:
        mask[3] = 0.0
    mask[-1] = 0.0
    return emb, idx, mask


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("widths", [(1024, 256), (1000, 250)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 7, 18, 19, 64])
def test_pool_edges_bitwise_the_triple_kernel(cuda, R, dtype, widths,
                                              offset):
    """The 3-table kernel's 16-byte lanes and their scalar tail: R around
    its load chunk (9), widths that are and are not whole 16-byte vectors
    (1000 / 250: vectors in clip, scalar columns in the tracks), tables
    whose rows start off a 16-byte boundary, guard on and off with empty
    rows. Bit for bit the triple kernel on the same rows (the same
    operations in the same order), and within one ulp of the plain
    version."""
    emb, idx, mask = _edge_inputs(cuda, dtype, R, *widths)
    fused, tidx = _triple_of(emb, idx)
    if offset:
        emb = EmbeddedTables(*(_off16(t) for t in emb))
    atol = 2e-6 if dtype == torch.float32 else 1e-5
    for guard in (True, False):
        got = fused_ctx_pool(emb, idx, mask, guard)
        tri = fused_ctx_pool_triple(fused, tidx, mask, guard)
        torch.cuda.synchronize()
        assert torch.equal(got.isnan(), tri.isnan())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(tri))
        assert bool(got[3].isnan().all()) != guard
        want = fused_ctx_pool_reference(emb, idx, mask, guard)
        torch.testing.assert_close(got, want, rtol=0, atol=atol,
                                   equal_nan=True)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize("M", [1, 7, 64])
@pytest.mark.parametrize("R", [2, 4, 8, 16, 32, 64, 128])
def test_pool_at_the_rels_only_buckets(cuda, R, M, dtype, atol):
    """Kernels 1 (f32 tables) and 2 (bf16) at the shapes the rels-only
    eval launches them: M pair rows of a bucket, R its power-of-two clip
    count, the embedded rows of the published widths (1024 / 256 wide).
    Pad clips have weight 0; the last row is all pad (a flush with n < B),
    and with the guard off (the eval's) it is NaN in both versions. Within
    the limits of the eval phases (1e-5 f32, 2e-3 bf16) of the plain
    version, the NaN rows equal, one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(R * 100 + M)
    emb = EmbeddedTables(*(
        torch.randn(n, d, device=cuda, generator=g).to(dtype)
        for n, d in ((300, 1024), (500, 256), (500, 256))))
    idx = torch.stack(
        [torch.randint(0, n, (M, R), device=cuda, generator=g)
         for n in (300, 500, 500)], dim=-1).to(torch.int32)
    mask = torch.zeros(M, R, device=cuda)
    lengths = torch.randint(1, R + 1, (M,), generator=g, device=cuda)
    for m in range(M):
        mask[m, : int(lengths[m])] = 1.0
    idx[mask == 0] = 0  # pad clips point at row 0, as the buckets do
    mask[-1] = 0.0
    idx = idx.contiguous()
    name = KERNEL_NAMES[("fused_ctx_pool", dtype)]
    for guard in (False, True):
        before = dispatch.launches(name)
        got = fused_ctx_pool(emb, idx, mask, guard)
        torch.cuda.synchronize()
        assert dispatch.launches(name) == before + 1
        want = fused_ctx_pool_reference(emb, idx, mask, guard)
        assert torch.equal(got.isnan(), want.isnan())
        assert bool(got[-1].isnan().all()) != guard
        assert not bool(got[:-1].isnan().any())
        torch.testing.assert_close(got, want, rtol=0, atol=atol,
                                   equal_nan=True)


def _loop_sum(table, idx, mask):
    """Kernel 5's function as an r-ordered eager loop of separate
    multiplies and adds from zeros, rounded to the table's dtype once: the
    kernel's operations in its order."""
    acc = torch.zeros(idx.shape[0], table.shape[1], device=table.device)
    for r in range(idx.shape[1]):
        acc = acc + mask[:, r, None] * table[idx[:, r].long()].float()
    return acc.to(table.dtype)


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("widths", [(1024, 256), (1000, 250)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 64, 1280])
@pytest.mark.parametrize("R", [1, 7, 9, 10, 18, 19, 64])
def test_one_table_kernel_edges_bitwise(cuda, R, M, dtype, widths, offset):
    """Kernels 4 and 5 (16-byte lanes, scalar columns, column slabs): R
    around the load chunk (9), fused widths 1536 / 1500 (1500 bf16 columns
    are 3,000 bytes: scalar columns), tables whose rows start off a
    16-byte boundary, M from one row (its lanes cut over many blocks) to
    the eval batch's 1,280, guard on and off with empty rows. Kernel 4 bit
    for bit kernel 1 on the corresponding index triples; kernel 5 bit for
    bit the r-ordered loop, on the fused table and on clip."""
    emb, idx, mask = _edge_inputs(cuda, dtype, R, *widths, M=M)
    fused, tidx = _triple_of(emb, idx)
    if offset:
        fused = _off16(fused)
        emb = EmbeddedTables(*(_off16(t) for t in emb))
    for guard in (True, False):
        three = fused_ctx_pool(emb, idx, mask, guard)
        tri = fused_ctx_pool_triple(fused, tidx, mask, guard)
        torch.cuda.synchronize()
        assert torch.equal(three.isnan(), tri.isnan())
        assert torch.equal(torch.nan_to_num(three), torch.nan_to_num(tri))
        assert bool(tri[-1].isnan().all()) != guard
    for table, ids in ((fused, tidx), (emb.clip, idx[..., 0].contiguous())):
        got = gather_masked_sum(table, ids, mask)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert torch.equal(got, _loop_sum(table, ids, mask))


@pytest.mark.parametrize("widths", [(1024, 256), (1000, 250)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-6),
                                        (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("M", [3, 64])
@pytest.mark.parametrize("R", [2048, 2049, 4096])
def test_pools_past_one_chunk_bitwise_one_pass(cuda, R, M, dtype, atol,
                                               widths, monkeypatch):
    """Kernels 1-2, 4 and 5 around and past the context chunk (2,048
    entries): at R = 2,048 one chunk, the one-pass kernel; at 2,049 and
    4,096 the chunked walk. Kernel 4 bit for bit kernel 1, kernel 5 bit
    for bit the r-ordered loop; each bit for bit its own output with other
    chunk sizes (one pass where 48 KB holds the row: kernels 4-5 at 4,096;
    kernel 1 cut into chunks of 700); kernels 1 and 4 within the card
    tests' tolerance of the plain version (f32 2e-6, bf16 1e-5), empty rows
    NaN without the guard; one launch per call."""
    from lirec_tpu_torch.ops import gather_pool as gp

    emb, idx, mask = _edge_inputs(cuda, dtype, R, *widths, M=M, Nc=500,
                                  Nt=700, seed=R + M)
    fused, tidx = _triple_of(emb, idx)
    one = idx[..., 0].contiguous()

    def run():
        out = {}
        for guard in (True, False):
            out["three", guard] = fused_ctx_pool(emb, idx, mask, guard)
            out["tri", guard] = fused_ctx_pool_triple(fused, tidx, mask,
                                                      guard)
        out["sum_fused"] = gather_masked_sum(fused, tidx, mask)
        out["sum_clip"] = gather_masked_sum(emb.clip, one, mask)
        torch.cuda.synchronize()
        return out

    names = [KERNEL_NAMES[(op, dtype)] for op in (
        "fused_ctx_pool", "fused_ctx_pool_triple", "gather_masked_sum")]
    before = [dispatch.launches(n) for n in names]
    got = run()
    assert [dispatch.launches(n) - b for n, b in zip(names, before)] == [
        2, 2, 2]
    for guard in (True, False):
        three, tri = got["three", guard], got["tri", guard]
        assert torch.equal(torch.nan_to_num(three), torch.nan_to_num(tri))
        assert torch.equal(three.isnan(), tri.isnan())
        assert bool(three[-1].isnan().all()) != guard
        want = fused_ctx_pool_reference(emb, idx, mask, guard)
        torch.testing.assert_close(three, want, rtol=0, atol=atol,
                                   equal_nan=True)
    assert torch.equal(got["sum_fused"], _loop_sum(fused, tidx, mask))
    assert torch.equal(got["sum_clip"], _loop_sum(emb.clip, one, mask))
    for chunk in (700, R if 8 * R <= gp.POOL_SMEM_BYTES else 3000):
        monkeypatch.setattr(gp, "CONTEXT_CHUNK", chunk)
        again = run()
        for key, t in got.items():
            assert torch.equal(torch.nan_to_num(again[key]),
                               torch.nan_to_num(t)), (chunk, key)


def test_kernel_raises_instead_of_falling_back(cuda):
    emb, idx, mask = _inputs(cuda, torch.float32)
    with pytest.raises(ValueError, match="int32"):
        fused_ctx_pool(emb, idx.long(), mask, True)
    with pytest.raises(ValueError, match="on cpu"):
        fused_ctx_pool(emb, idx.cpu(), mask, True)


@pytest.mark.parametrize("op", [
    lambda t, i, m: fused_ctx_pool_triple(t, i, m, True), gather_masked_sum])
def test_one_table_kernels_raise_instead_of_falling_back(cuda, op):
    """Kernels 4 and 5 on a CUDA table: a bad dtype, device or layout
    raises; nothing takes the plain version."""
    emb, idx, mask = _inputs(cuda, torch.float32)
    table, one = emb.clip, idx[..., 0].contiguous()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        op(table.half(), one, mask)
    with pytest.raises(ValueError, match="int32"):
        op(table, one.long(), mask)
    with pytest.raises(ValueError, match="on cpu"):
        op(table, one.cpu(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        op(table, idx[..., 0], mask)


def _triple_of(emb, idx):
    """The fused local table of idx's unique index triples and the
    positions of every entry in it (what the eval sweep's triple tier
    builds from data/localize.localize_eval_ctx_triples)."""
    tri, tidx = torch.unique(idx.reshape(-1, 3), dim=0, return_inverse=True)
    tri = tri.long()
    fused = torch.cat([emb.clip[tri[:, 0]], emb.tr1[tri[:, 1]],
                       emb.tr2[tri[:, 2]]], dim=-1).contiguous()
    return fused, tidx.reshape(idx.shape[:2]).to(torch.int32).contiguous()


@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-6),
                                        (torch.bfloat16, 1e-5)])
def test_triple_kernel_matches_plain_and_three_table_kernel(cuda, dtype,
                                                            atol, guard):
    """Against its plain version (one-ulp differences, as the 3-table
    kernel), and bit for bit against the 3-table kernel on the
    corresponding global index triples: the same values added in the same
    order."""
    emb, idx, mask = _inputs(cuda, dtype)
    fused, tidx = _triple_of(emb, idx)
    assert fused.shape[0] < idx.shape[0] * idx.shape[1]  # duplicates folded
    name = KERNEL_NAMES[("fused_ctx_pool_triple", dtype)]
    before = dispatch.launches(name)
    got = fused_ctx_pool_triple(fused, tidx, mask, guard)
    three = fused_ctx_pool(emb, idx, mask, guard)
    torch.cuda.synchronize()
    assert dispatch.launches(name) == before + 1
    assert torch.equal(got.isnan(), three.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(three))
    want = fused_ctx_pool_triple_reference(fused, tidx, mask, guard)
    torch.testing.assert_close(got, want, rtol=0, atol=atol, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_masked_sum_kernel_matches_plain_version(cuda, dtype):
    """Bit for bit the r-ordered loop; against the plain version's sums:
    f32 within 1e-5, bf16 output within one bf16 rounding of the sum."""
    emb, idx, mask = _inputs(cuda, dtype)
    table, one = emb.clip, idx[..., 0].contiguous()
    name = KERNEL_NAMES[("gather_masked_sum", dtype)]
    before = dispatch.launches(name)
    got = gather_masked_sum(table, one, mask)
    torch.cuda.synchronize()
    assert dispatch.launches(name) == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, _loop_sum(table, one, mask))
    want = gather_masked_sum_reference(table, one, mask)
    tol = dict(rtol=0, atol=1e-5) if dtype == torch.float32 else dict(
        rtol=2 ** -8, atol=1e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _updates(device, dtype, N=23, R=18, rows=(50, 70), widths=(1040, 520),
             dup_rows=None, seed=1):
    """idx [N, R, 3] int32 and updates [N, R, d]; widths not multiples of
    the kernel's 512-column pass; dup_rows sends everything to that many
    rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    hi = (rows[0], rows[1], rows[1]) if dup_rows is None else (dup_rows,) * 3
    idx = torch.stack([torch.randint(0, n, (N, R), device=device, generator=g)
                       for n in hi], dim=-1).to(torch.int32).contiguous()
    gs = [torch.randn(N, R, d, device=device, generator=g).to(dtype)
          for d in (widths[0], widths[1], widths[1])]
    return idx, gs


@pytest.mark.parametrize("dup_rows", [None, 4, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_kernel_matches_in_order_sum(cuda, dtype, dup_rows):
    """Three tables: bitwise the plain version's in-order sum on the CPU,
    within 1e-5 of scale of index_add_ on the card (whose atomics sum in
    another order), and bitwise equal over two launches; bf16 output is
    the f32 sum rounded. dup_rows=1 puts 414 updates into one row: a long
    segment summed in hot tiles through the shared-memory ring, with a
    width (520) that ends in a partial hot tile and a partial warp tile."""
    idx, gs = _updates(cuda, dtype, dup_rows=dup_rows)
    name = sa.KERNEL_NAMES[dtype]
    before = dispatch.launches(name)
    got = sa.scatter_accum3(idx, *gs, 50, 70)
    again = sa.scatter_accum3(idx, *gs, 50, 70)
    as_bf16 = sa.scatter_accum3(idx, *gs, 50, 70, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert dispatch.launches(name) == before + 3
    cpu = sa.scatter_accum3_reference(idx.cpu(), *(g.cpu() for g in gs),
                                      50, 70)
    plain = sa.scatter_accum3_reference(idx, *gs, 50, 70)
    for k, c, p, a, b in zip(got, cpu, plain, again, as_bf16):
        assert k.dtype == torch.float32 and torch.equal(k, a)
        assert torch.equal(k.cpu(), c)
        scale = float(c.abs().max())
        torch.testing.assert_close(k, p, rtol=0, atol=1e-5 * scale)
        assert torch.equal(b, k.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_table_kernel_matches_in_order_sum(cuda, dtype):
    idx, gs = _updates(cuda, dtype, dup_rows=3)
    one = idx[..., 1].contiguous()
    got = sa.scatter_accum1(one, gs[1], 9)
    torch.cuda.synchronize()
    want = sa.scatter_accum1_reference(one.cpu(), gs[1].cpu(), 9)
    assert torch.equal(got.cpu(), want)
    assert bool((got[3:] == 0).all())  # untouched rows are written as zeros


def _hot_updates(device, dtype, hot_len, n_rows=40, others=300, d=520,
                 seed=7):
    """One table: `hot_len` updates into row 0 at random positions among
    `others` into rows 1.. (short segments)."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = hot_len + others
    idx = torch.randint(1, n_rows, (n,), device=device, generator=g)
    idx[torch.randperm(n, device=device, generator=g)[:hot_len]] = 0
    upd = torch.randn(n, d, device=device, generator=g).to(dtype)
    return idx.to(torch.int32), upd


def _assert_in_order(got, idx, upd, n_rows):
    want = sa.scatter_accum1_reference(idx.cpu(), upd.cpu(), n_rows)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("hot_len", [31, 32, 33, 127, 128, 129, 255, 256,
                                     257, 767, 768, 769, 6543])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_long_segments_at_their_boundaries(cuda, dtype, hot_len):
    """A row whose update count straddles the kernel's boundaries: the
    longest short segment (32), a ring stage (128 update rows), a
    copier's cycle of update positions (two stages), the ring (six), and
    the padding row's 6,543. Width 520: a partial hot tile (32 f32 / 64 bf16
    columns) and a partial warp tile. Bitwise the in-order sum on the CPU,
    and two launches bitwise equal."""
    assert sa.SHORT_MAX == 32
    idx, upd = _hot_updates(cuda, dtype, hot_len)
    got = sa.scatter_accum1(idx, upd, 40)
    again = sa.scatter_accum1(idx, upd, 40)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_in_order(got, idx, upd, 40)


@pytest.mark.parametrize("per_row", [1, 2, 13, 14, 15, 16, 17, 31, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_short_runs_around_the_lane_ring(cuda, dtype, per_row):
    """Every row of 21 with the same number of updates, shuffled: a warp's
    run of 8 rows is one walk of 8 x per_row positions, around the depth of
    a lane's copy ring (14 ahead in 16 slots) and over several chunks of 32
    update positions (up to 256 at 32 per row). Bitwise the in-order sum
    on the CPU, and two launches bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(per_row)
    idx = torch.arange(21, device=cuda).repeat_interleave(per_row)
    idx = idx[torch.randperm(idx.numel(), device=cuda, generator=g)]
    upd = torch.randn(idx.numel(), 520, device=cuda, generator=g).to(dtype)
    idx = idx.to(torch.int32)
    got = sa.scatter_accum1(idx, upd, 21)
    again = sa.scatter_accum1(idx, upd, 21)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_in_order(got, idx, upd, 21)


@pytest.mark.parametrize("case", ["one_row", "no_updates", "sparse_rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_degenerate_segments(cuda, dtype, case):
    """Every update into one row (each table), no update at all, and a
    table of more rows than updates (most rows written as zeros)."""
    n, rows = {"one_row": (700, 5), "no_updates": (0, 9),
               "sparse_rows": (12, 3000)}[case]
    g = torch.Generator(device=cuda).manual_seed(8)
    if case == "one_row":
        idx = torch.full((n, 3), rows - 1, dtype=torch.int32, device=cuda)
    else:
        idx = torch.randint(0, rows, (n, 3), device=cuda,
                            generator=g).to(torch.int32)
    gs = [torch.randn(n, d, device=cuda, generator=g).to(dtype)
          for d in (1040, 520, 520)]
    got = sa.scatter_accum3(idx, *gs, rows, rows)
    again = sa.scatter_accum3(idx, *gs, rows, rows)
    torch.cuda.synchronize()
    want = sa.scatter_accum3_reference(idx.cpu(), *(x.cpu() for x in gs),
                                       rows, rows)
    for k, a, w in zip(got, again, want):
        assert torch.equal(k, a) and torch.equal(k.cpu(), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_unaligned_updates(cuda, dtype):
    """Updates that are not whole 16-byte vectors on 16-byte boundaries
    take the kernel's scalar loads: widths 1000 / 250 (the tracks'
    rows are not 16-byte multiples) and updates off a 16-byte boundary,
    with a long segment (every update of 4 rows)."""
    idx, gs = _updates(cuda, dtype, N=40, R=18, widths=(1000, 250),
                       dup_rows=4)
    gs = [_off16(x) for x in gs]
    got = sa.scatter_accum3(idx, *gs, 50, 70)
    again = sa.scatter_accum3(idx, *gs, 50, 70)
    as_bf16 = sa.scatter_accum3(idx, *gs, 50, 70, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    want = sa.scatter_accum3_reference(idx.cpu(), *(x.cpu() for x in gs),
                                       50, 70)
    for k, a, b, w in zip(got, again, as_bf16, want):
        assert torch.equal(k, a) and torch.equal(k.cpu(), w)
        assert torch.equal(b, k.to(torch.bfloat16))


def test_gather_h1_backward_launches_the_kernel(cuda):
    idx, gs = _updates(cuda, torch.bfloat16, N=6, R=5)
    tables = [torch.randn(n, d, device=cuda).bfloat16().requires_grad_(True)
              for n, d in ((50, 1040), (70, 520), (70, 520))]
    before = dispatch.launches(sa.KERNEL_NAMES[torch.bfloat16])
    outs = sa.gather_h1(*tables, idx)
    sum((o.float() * g.float()).sum() for o, g in zip(outs, gs)).backward()
    torch.cuda.synchronize()
    assert dispatch.launches(sa.KERNEL_NAMES[torch.bfloat16]) == before + 1
    want = sa.scatter_accum3_reference(idx.cpu(), *(g.cpu() for g in gs),
                                       50, 70)
    for t, w in zip(tables, want):
        assert t.grad.dtype == torch.bfloat16
        assert torch.equal(t.grad.cpu(), w.to(torch.bfloat16))


def test_scatter_raises_instead_of_falling_back(cuda):
    idx, gs = _updates(cuda, torch.float32, N=2, R=3)
    with pytest.raises(ValueError, match="int32"):
        sa.scatter_accum3(idx.long(), *gs, 50, 70)
    with pytest.raises(ValueError, match="on cpu"):
        sa.scatter_accum3(idx, gs[0].cpu(), *gs[1:], 50, 70)


def _sort_ids(device, M, rows, pad_share=0.25, seed=11):
    """idx int32 [M, len(rows)]: uniform rows, and a padding row 0 taking
    `pad_share` of the updates (the masked ctx slots)."""
    g = torch.Generator(device=device).manual_seed(seed)
    idx = torch.stack([torch.randint(0, n, (M,), device=device, generator=g)
                       for n in rows], 1)
    idx[torch.rand(M, device=device, generator=g) < pad_share] = 0
    return idx.to(torch.int32).contiguous()


@pytest.mark.parametrize("rows,M", [
    ((2816, 5376, 5376), 23040), ((12288, 24576, 24576), 23040),
    ((40000, 50000, 50000), 23040), ((1 << 17,), 23040),
    ((1 << 20,), 23040), ((2816,), 23040), ((1 << 22,), 1 << 21)])
def test_counting_sort_is_bitwise_sort_by_row(cuda, rows, M):
    """count_sort's perm and offsets against sort_by_row's, bit for bit, on
    M updates a table: one pass at the Localizer's caps (13,568 rows), at
    split-scale tables (61,440 rows) and on one table; two passes by digit
    at 140,000 and 2**17 rows (9 bits each) and at 2**20 rows (11 bits),
    each with units of 1,024 positions; three passes of 8 bits for 2**21
    updates into 2**22 rows; then every update into 8 rows, a single
    update and none. One launch count per sort."""
    idx = _sort_ids(cuda, M, rows)
    passes = sa.sort_plan(idx.numel(), rows)["passes"]
    assert passes == (1 if sum(rows) <= 61440 else 3 if M > 23040 else 2)
    before = dispatch.launches(sa.SORT_NAME)
    for case in (idx, (idx % 8).contiguous(), idx[:1].contiguous(),
                 idx[:0].contiguous()):
        want = sa.sort_by_row(case, rows)
        got = sa.count_sort(case, rows)
        torch.cuda.synchronize()
        assert got[0].dtype == got[1].dtype == torch.int64
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert dispatch.launches(sa.SORT_NAME) == before + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_after_several_passes_lists_the_hot_tiles(cuda, dtype):
    """scatter_accum3 into tables of 20,000 / 25,000 / 25,000 rows (the
    sort by digits, whose last launch finds the offsets and lists the hot
    tiles) with a quarter of the updates on row 0: bitwise the CPU's
    in-order sum, one sort and one scatter launch."""
    rows = (20000, 25000, 25000)
    assert sa.sort_plan(23040 * 3, rows)["passes"] == 2
    idx = _sort_ids(cuda, 23040, rows)
    g = torch.Generator(device=cuda).manual_seed(13)
    gs = [torch.randn(23040, d, device=cuda, generator=g).to(dtype)
          for d in (520, 256, 256)]
    before = dispatch.launches()
    got = sa.scatter_accum3(idx, *gs, rows[0], rows[1])
    torch.cuda.synchronize()
    delta = {k: n - before.get(k, 0) for k, n in dispatch.launches().items()
             if n != before.get(k, 0)}
    assert delta == {sa.KERNEL_NAMES[dtype]: 1, sa.SORT_NAME: 1}
    want = sa.scatter_accum3_reference(idx.cpu(), *(t.cpu() for t in gs),
                                       rows[0], rows[1])
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def _int_rels_table(device, n_rows, batch, width, dtype=torch.float32,
                    seed=12):
    """The int_rels score table's scatter: the table's own rows, then
    `batch` rows into hashed rows (evaluation/packed.py)."""
    g = torch.Generator(device=device).manual_seed(seed)
    ids = torch.cat([torch.arange(n_rows, device=device),
                     torch.randint(0, n_rows, (batch,), device=device,
                                   generator=g)]).to(torch.int32)
    upd = torch.rand(n_rows + batch, width, device=device,
                     generator=g).to(dtype)
    return ids, upd


@pytest.mark.parametrize("past", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_launch_path_at_its_threshold(cuda, dtype, past):
    """scatter_accum1 at the size rule's threshold (into half the square
    root of SMALL_MAX_WORK rows, the most updates whose updates x rows
    stays within it: one launch of the small kernel, no sort) and one
    update past it (the counting sort and the sorted kernel): bitwise the
    CPU's in-order sum either way, bf16 output the f32 sum rounded."""
    n_rows = math.isqrt(sa.SMALL_MAX_WORK) // 2
    batch = sa.SMALL_MAX_WORK // n_rows - n_rows + past
    assert n_rows + batch <= sa.SMALL_MAX_UPDATES
    ids, upd = _int_rels_table(cuda, n_rows, batch, 15, dtype)
    want_path = "sorted" if past else "small"
    assert sa.scatter_path(ids.numel(), (n_rows,), (15,)) == want_path
    before = dispatch.launches()
    got = sa.scatter_accum1(ids, upd, n_rows)
    as_bf16 = sa.scatter_accum1(ids, upd, n_rows, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    delta = {k: n - before.get(k, 0) for k, n in dispatch.launches().items()
             if n != before.get(k, 0)}
    if past:
        assert delta == {sa.KERNEL_NAMES[dtype]: 2, sa.SORT_NAME: 2}
    else:
        assert delta == {sa.SMALL_NAMES[dtype]: 2}
    _assert_in_order(got, ids, upd, n_rows)
    assert torch.equal(as_bf16, got.to(torch.bfloat16))


@pytest.mark.parametrize("shape", [(9, 34, 6), (9, 8, 6), (1025, 64, 15),
                                   (40, 300, 520), (3, 0, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_kernel_matches_in_order_sum(cuda, dtype, shape):
    """launch_small alone, bitwise the CPU's in-order sum: the int_rels
    table's shapes (43 and 17 updates into 9 rows of 6; 1,089 into 1,025
    of 15), a width past one warp's lanes (520: the ids walked once per 32
    columns) with rows of many updates, and a table of rows only (each
    row one update; a -0.0 update sums to +0.0 from the 0.0 start, as in
    index_add_ into zeros)."""
    n_rows, batch, width = shape
    ids, upd = _int_rels_table(cuda, n_rows, batch, width, dtype)
    if batch == 0:
        upd[0, 0] = -0.0
    out = torch.empty(n_rows, width, device=cuda)
    sa.launch_small(ids, upd, out)
    torch.cuda.synchronize()
    _assert_in_order(out, ids, upd, n_rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_launch_path_under_capture(cuda, dtype):
    """The int_rels score table's scatter (the one-launch path) captured in
    a CUDA graph: each replay on new updates gives the eager op's output
    bit for bit and counts one launch of the small kernel."""
    from lirec_tpu_torch.utils.graphs import StepGraph

    ids, upd = _int_rels_table(cuda, 9, 34, 6, dtype)
    name = sa.SMALL_NAMES[dtype]
    out = {}

    def step():
        out["table"] = sa.scatter_accum1(ids, upd, 9)

    graph = StepGraph(step, cuda)
    assert graph.launches == {name: 1}
    for seed in (2, 3):
        _, fresh = _int_rels_table(cuda, 9, 34, 6, dtype, seed=seed)
        upd.copy_(fresh)
        graph.replay()
        want = sa.scatter_accum1(ids, fresh, 9)
        torch.cuda.synchronize()
        assert torch.equal(out["table"], want)
        _assert_in_order(want, ids, fresh, 9)


LIBRARY_SORT_KERNELS = ("RadixSort", "radix_sort", "searchsorted",
                        "indexFunc", "index_add", "SegmentedSort",
                        "DeviceSort", "sort_by_key")


def _device_kernels(fn):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def test_scatter_launches_no_library_sort_or_index_add(cuda):
    """torch.profiler over scatter_accum3, scatter_accum1 (both paths) and
    gather_h1's backward on CUDA tensors: the device runs the port's own
    kernels (the counting sort, the scatter, the one-launch kernel) and no
    torch.sort, searchsorted or index_add_ kernel."""
    idx, gs = _updates(cuda, torch.float32, dup_rows=1)
    ids, upd = _int_rels_table(cuda, 9, 34, 6)
    tables = [torch.randn(n, d, device=cuda).requires_grad_(True)
              for n, d in ((50, 1040), (70, 520), (70, 520))]

    def backward():
        outs = sa.gather_h1(*tables, idx)
        sum((o * g).sum() for o, g in zip(outs, gs)).backward()

    cases = {
        "scatter_accum3": lambda: sa.scatter_accum3(idx, *gs, 50, 70),
        "scatter_accum1 sorted": lambda: sa.scatter_accum1(
            idx[..., 1].contiguous(), gs[1], 70),
        "scatter_accum1 small": lambda: sa.scatter_accum1(ids, upd, 9),
        "gather_h1 backward": backward,
    }
    for label, fn in cases.items():
        names = _device_kernels(fn)
        library = [n for n in names if any(k in n for k in
                                           LIBRARY_SORT_KERNELS)]
        assert not library, (label, library)
        ours = [n for n in names if "sort_place_kernel" in n
                or "scatter_small_kernel" in n]
        assert ours, (label, names)


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_one_train_step_on_the_card(cuda, compute):
    """int_rel_ch at small widths on the card: a finite loss, every
    parameter moved, one scatter launch per step."""
    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.utils.fake_batch import make_batch, make_tables
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.train.loop import make_train_step, step_generators
    from lirec_tpu_torch.train.optim import make_optimizer

    cfg = config_lib.preset("int_rel_ch").with_dims(
        text_dim=32, visual_dim=64, joint_dim=256).with_runtime(
        compute_dtype=compute)
    pb = create_model(cfg, 9, n_rels=6, device=cuda)
    before = {n: p.detach().clone() for n, p in pb.model.named_parameters()}
    tables = {k: torch.from_numpy(v).to(cuda)
              for k, v in make_tables(pb.spec, 64, 96).items()}
    step = make_train_step(pb, make_optimizer(pb.model.parameters(), 1e-3))
    name = sa.KERNEL_NAMES[torch.bfloat16 if compute == "bfloat16"
                           else torch.float32]
    launches = dispatch.launches(name)
    loss = step(make_batch(pb.spec, 4, 64, 96, seed=2), tables,
                step_generators(0, 1, cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert dispatch.launches(name) == launches + 1
    for n, p in pb.model.named_parameters():
        assert not torch.equal(p.detach(), before[n]), n


def _small_int_rel_ch(compute, device, **tasks):
    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.models.factory import create_model

    cfg = config_lib.preset("int_rel_ch").with_dims(
        text_dim=32, visual_dim=64, joint_dim=256).with_runtime(
        compute_dtype=compute)
    if tasks:
        cfg = cfg.with_tasks(**tasks)
    return cfg, create_model(cfg, 9, n_rels=6, seed=0, device=device)


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_prefetched_steps_are_bitwise_the_host_steps(cuda, compute):
    """data/pipeline.prefetch_to_device stages each batch in pinned memory
    and copies it on a side stream: three train steps on the staged
    batches give bitwise the losses and parameters of the same steps on
    host batches."""
    from lirec_tpu_torch.data.pipeline import prefetch_to_device
    from lirec_tpu_torch.train.loop import make_train_step, step_generators
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.utils.fake_batch import make_batch, make_tables

    batches = None
    runs = []
    for prefetch in (False, True):
        _, pb = _small_int_rel_ch(compute, cuda)
        if batches is None:
            batches = [make_batch(pb.spec, 4, 64, 96, seed=s)
                       for s in range(3)]
            tables = {k: torch.from_numpy(v).to(cuda)
                      for k, v in make_tables(pb.spec, 64, 96).items()}
        step = make_train_step(pb, make_optimizer(pb.model.parameters(),
                                                  1e-3))
        source = prefetch_to_device(iter(batches), cuda) if prefetch \
            else batches
        losses = []
        for i, batch in enumerate(source):
            if prefetch:
                assert all(t.is_cuda for t in batch.values())
            losses.append(step(batch, tables, step_generators(0, i, cuda)))
        torch.cuda.synchronize()
        runs.append((torch.stack(losses), {n: p.detach().clone() for n, p
                                           in pb.model.named_parameters()}))
    (want, want_p), (got, got_p) = runs
    assert torch.equal(got, want)
    for n, p in want_p.items():
        assert torch.equal(got_p[n], p), n


def test_prefetch_stages_from_pinned_memory(cuda, monkeypatch):
    """Every array is pinned before its copy, and the yielded tensors
    hold the host values."""
    import numpy as np

    from lirec_tpu_torch.data import pipeline

    pinned = []
    orig = torch.Tensor.pin_memory

    def spy(t, *a, **kw):
        out = orig(t, *a, **kw)
        pinned.append(out.is_pinned())
        return out

    monkeypatch.setattr(torch.Tensor, "pin_memory", spy)
    host = [{"a": np.arange(12, dtype=np.float32).reshape(3, 4) + i,
             "b": np.full(5, i, np.int32)} for i in range(4)]
    got = list(pipeline.prefetch_to_device(iter(host), cuda, size=2))
    assert pinned == [True] * 8
    for g, h in zip(got, host):
        for k in h:
            assert g[k].is_cuda
            np.testing.assert_array_equal(g[k].cpu().numpy(), h[k])


@pytest.mark.parametrize("compute,atol", [("float32", 1e-5),
                                          ("bfloat16", 2e-3)])
def test_dense_forward_matches_the_packed_forward(cuda, compute, atol):
    """The dense forward (reference-layout rows gathered on the card) and
    the packed eval forward (embed, then the pool kernel) on the same
    samples agree within 1e-5 (f32) / 2e-3 (bf16) of the logits' scale;
    the packed one launched the pool kernel."""
    from lirec_tpu_torch.models.tabular import embed_all
    from lirec_tpu_torch.utils.fake_batch import make_batch, make_tables

    _, pb = _small_int_rel_ch(compute, cuda)
    tables = {k: torch.from_numpy(v).to(cuda)
              for k, v in make_tables(pb.spec, 64, 96, seed=1).items()}
    batch = make_batch(pb.spec, 8, 64, 96, seed=3)
    packed = {k: torch.from_numpy(batch[k]).to(cuda)
              for k in ("feat_idx", "rels_mask")}
    idx = packed["feat_idx"].long()
    dense = {"features": torch.cat([tables["text"][idx[..., 0]],
                                    tables["visual"][idx[..., 0]],
                                    tables["track"][idx[..., 1]],
                                    tables["track"][idx[..., 2]]], dim=-1),
             "rels_mask": packed["rels_mask"]}
    dtype = torch.bfloat16 if compute == "bfloat16" else torch.float32
    name = KERNEL_NAMES[("fused_ctx_pool", dtype)]
    with torch.no_grad():
        embedded = embed_all(pb.model, pb.spec, tables)
        launches = dispatch.launches(name)
        want = pb.apply(pb.model, packed, tables=tables, embedded=embedded)
        torch.cuda.synchronize()
        assert dispatch.launches(name) == launches + 1
        got = pb.apply(pb.model, dense)
    for key in ("inters", "rels"):
        scale = float(want[key].abs().max())
        err = float((got[key] - want[key]).abs().max())
        assert err <= atol * max(scale, 1.0), (key, err, scale)


# ------------------------------------------------ the probes, kernels 9-10


def _run_inputs(device, M=37, R=18, Nc=60, Nt=80, Dc=40, Dt=24, seed=3):
    """f32 tables (widths multiples of 4, not of the block), run-safe
    starts in idx[:, 0, :], 0/1 weights with an empty row."""
    emb, idx, mask = _inputs(device, torch.float32, M, R, Nc, Nt, Dc, Dt,
                             seed)
    hi = torch.tensor([Nc - R, Nt - R, Nt - R], device=device,
                      dtype=torch.int32)
    idx = (idx % (hi + 1)).contiguous()
    return emb, idx, mask


def test_run_pool_kernel_matches_plain_and_the_row_kernel(cuda):
    """Kernel 9 against its plain version (one-ulp differences from the
    sum order), and bit for bit against kernel 1 on the explicit run
    indices with 0/1 weights; a run that leaves its table gives NaN."""
    from lirec_tpu_torch.ops import probes
    from lirec_tpu_torch.tools.probe_hbm_dma import run_indices

    emb, idx, mask = _run_inputs(cuda)
    name = probes.KERNEL_NAMES["run_pool"]
    before = dispatch.launches(name)
    got = probes.run_pool(emb, idx, mask)
    rows = fused_ctx_pool(emb, run_indices(torch, idx), mask, True)
    torch.cuda.synchronize()
    assert dispatch.launches(name) == before + 1
    assert torch.equal(got, rows)
    want = probes.run_pool_reference(emb, idx, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    bad = idx.clone()
    bad[2, 0, 1] = emb.tr1.shape[0] - 1  # the run leaves tr1
    out = probes.run_pool(emb, bad, mask)
    torch.cuda.synchronize()
    assert bool(out[2, 40:64].isnan().all())
    assert not bool(out[2, :40].isnan().any())
    assert not bool(out[2, 64:].isnan().any())
    assert torch.equal(torch.cat([out[:2], out[3:]]),
                       torch.cat([got[:2], got[3:]]))


@pytest.mark.parametrize("widths", [(1024, 256), (40, 24)])
@pytest.mark.parametrize("M", [1, 7, 1280])
@pytest.mark.parametrize("R", [1, 18, 40, 64])
def test_run_pool_edges_bitwise_the_row_kernel(cuda, R, M, widths):
    """The ring around its chunk size (18 rows of the probe's widths per
    stage: R = 40 and 64 take several chunks; 32 rows, the most a chunk
    takes, at 40 / 24 columns), one pooled row (one block), fewer rows
    than SMs, and the probe's 1,280 (about ten per persistent block): bit
    for bit kernel 1 on the run indices, and two launches equal."""
    from lirec_tpu_torch.ops import probes
    from lirec_tpu_torch.tools.probe_hbm_dma import run_indices

    g = torch.Generator(device=cuda).manual_seed(R + M)
    emb = EmbeddedTables(*(
        torch.randn(n, d, device=cuda, generator=g)
        for n, d in ((400, widths[0]), (300, widths[1]), (300, widths[1]))))
    idx = torch.stack([torch.randint(0, n - R + 1, (M, R), device=cuda,
                                     generator=g) for n in (400, 300, 300)],
                      dim=-1).to(torch.int32).contiguous()
    mask = (torch.rand(M, R, device=cuda, generator=g) < 0.6).float()
    mask[:, 0] = 1.0
    if M > 1:
        mask[-1] = 0.0  # a row without context: the divider's guard
    got = probes.run_pool(emb, idx, mask)
    again = probes.run_pool(emb, idx, mask)
    rows = fused_ctx_pool(emb, run_indices(torch, idx), mask, True)
    torch.cuda.synchronize()
    assert torch.equal(got, rows)
    assert torch.equal(got, again)


def test_run_pool_raises_instead_of_falling_back(cuda):
    """bf16 tables are refused; a row of 3,520 columns (14 KB) streams
    through the ring and matches kernel 1; a row wider than the ring takes
    (17,600 columns: more lanes than the consumers keep) is refused."""
    from lirec_tpu_torch.ops import probes
    from lirec_tpu_torch.tools.probe_hbm_dma import run_indices

    emb, idx, mask = _run_inputs(cuda)
    with pytest.raises(TypeError, match="float32"):
        probes.run_pool(EmbeddedTables(*(t.bfloat16() for t in emb)), idx,
                        mask)
    wide = EmbeddedTables(*(t.repeat(1, 40) for t in emb))  # 3,520 columns
    got = probes.run_pool(wide, idx, mask)
    rows = fused_ctx_pool(wide, run_indices(torch, idx), mask, True)
    torch.cuda.synchronize()
    assert got.shape == (idx.shape[0], 3520) and torch.equal(got, rows)
    wider = EmbeddedTables(*(t.repeat(1, 200) for t in emb))  # 17,600
    with pytest.raises(ValueError, match="lanes"):
        probes.run_pool(wider, idx, mask)


def _packed_case(device, n, d, m, R=18, seed=4):
    g = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn(n, d, device=device, generator=g)
    idx = torch.randint(0, n, (m, R), device=device, generator=g).to(
        torch.int32)
    mask = (torch.rand(m, R, device=device, generator=g) < 0.5).float()
    mask[::3] *= 0.25 + torch.rand(m, R, device=device, generator=g)[::3]
    return table, idx, mask


@pytest.mark.parametrize("n,d,m", [(50, 40, 37), (512, 1024, 64),
                                   (12288, 1024, 1280), (50, 6, 37),
                                   (50, 14, 37)])
def test_packed_gather_sum_kernel_matches_plain_version(cuda, n, d, m):
    """Kernel 10 against its plain version: the same bf16 values summed in
    f32, within 1e-5 (the TPU probe's bound), and bit for bit the
    r-ordered loop over the unpacked f32 table; D = 6 and 14 (3 and 7
    packed words) take the scalar path."""
    from lirec_tpu_torch.ops import probes

    table, idx, mask = _packed_case(cuda, n, d, m)
    packed = probes.pack_bf16(table)
    assert torch.equal(probes.unpack_bf16(packed), table.bfloat16())
    name = probes.KERNEL_NAMES["packed_gather_sum"]
    before = dispatch.launches(name)
    got = probes.packed_gather_sum(packed, idx, mask)
    torch.cuda.synchronize()
    assert dispatch.launches(name) == before + 1
    want = probes.packed_gather_sum_reference(packed, idx, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    unpacked = probes.unpack_bf16(packed).float()
    assert torch.equal(got, _loop_sum(unpacked, idx, mask))


@pytest.mark.parametrize("case", ["offset", "M1", "R1"])
def test_packed_gather_sum_edges_bitwise(cuda, case):
    """Kernel 10 on a table whose rows start off a 16-byte boundary (the
    scalar path), on one output row (its lanes over many blocks) and with
    R = 1: bit for bit the r-ordered loop."""
    from lirec_tpu_torch.ops import probes

    m, R = {"offset": (64, 18), "M1": (1, 18), "R1": (37, 1)}[case]
    table, idx, mask = _packed_case(cuda, 512, 1024, m, R=R)
    packed = probes.pack_bf16(table)
    if case == "offset":
        packed = _off16(packed)
    got = probes.packed_gather_sum(packed, idx, mask)
    torch.cuda.synchronize()
    unpacked = probes.unpack_bf16(packed).float()
    assert torch.equal(got, _loop_sum(unpacked, idx, mask))


# ------------------------------------------ the one-dispatch sweeps' graphs


def _param_copy(pb):
    return {n: p.detach().clone() for n, p in pb.model.named_parameters()}


def _launch_delta(before):
    now = dispatch.launches()
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n != before.get(k, 0)}


@pytest.mark.parametrize("tr_cat_distr", [False, True])
@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_graph_train_steps_are_bitwise_the_eager_steps(cuda, compute,
                                                       tr_cat_distr):
    """Three steps through the epoch sweep's CUDA graph (the first its
    warm-up, then two replays) against make_train_step's eager steps with
    the same generators, capturable Adam on both: the losses and
    parameters bit for bit, the same launch counts (one sort and one
    scatter a step),
    "graph" recorded, Adam's step count 3 on the card. With tr_cat_distr
    on, the graph draws its samples with torch.multinomial's own method."""
    from lirec_tpu_torch.train.loop import make_train_step, step_generators
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.train.sweep import EpochSweep
    from lirec_tpu_torch.utils.fake_batch import make_batch, make_tables

    runs = {}
    for graph in (False, True):
        _, pb = _small_int_rel_ch(compute, cuda, tr_cat_distr=tr_cat_distr)
        batches = [make_batch(pb.spec, 4, 64, 96, seed=s) for s in range(3)]
        tables = {k: torch.from_numpy(v).to(cuda)
                  for k, v in make_tables(pb.spec, 64, 96).items()}
        opt = make_optimizer(pb.model.parameters(), 1e-3)
        assert opt.param_groups[0]["capturable"]
        torch.cuda.synchronize()
        before = dispatch.launches()
        if graph:
            sweep = EpochSweep(pb, opt, tables, 0, 4, require_graph=True)
            losses = sweep.fetch(sweep.run(batches, 0))
            assert dispatch.last_dispatch("train_loop")["path"] == "graph"
            assert len(sweep.capture_s) == 1
        else:
            step = make_train_step(pb, opt)
            losses = [float(step(b, tables, step_generators(0, i, cuda)))
                      for i, b in enumerate(batches)]
        torch.cuda.synchronize()
        runs[graph] = (losses, _param_copy(pb), _launch_delta(before))
        for st in opt.state.values():
            assert st["step"].is_cuda and float(st["step"]) == 3.0
    (l_e, p_e, n_e), (l_g, p_g, n_g) = runs[False], runs[True]
    assert l_g == l_e
    for n, p in p_e.items():
        assert torch.equal(p_g[n], p), n
    name = sa.KERNEL_NAMES[torch.bfloat16 if compute == "bfloat16"
                           else torch.float32]
    assert n_g == n_e == {name: 3, sa.SORT_NAME: 3}


def _eval_split(spec, full=6, tail=3, B=4):
    import numpy as np

    from lirec_tpu_torch.utils.fake_batch import make_batch

    parts = [make_batch(spec, B, 64, 96, seed=s) for s in range(full)]
    parts.append(make_batch(spec, tail, 64, 96, seed=full))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


@pytest.mark.parametrize("tier", [False, "tables", "triple"])
@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_graph_eval_sweep_is_bitwise_the_eager_sweep(cuda, compute, tier):
    """sweep_carry over 6 full batches of 4 and a tail of 3, as a CUDA
    graph (batch 0 its warm-up, 5 replays, the tail eager) and as eager
    steps, in each ctx localisation tier: every carry entry bit for bit,
    the same launch counts (7 of the 3-table pool; the triple tier 6 of
    the triple pool and the tail's one), "graph" recorded."""
    import types

    import numpy as np

    from lirec_tpu_torch.evaluation import packed
    from lirec_tpu_torch.utils.fake_batch import make_tables

    cfg, pb = _small_int_rel_ch(compute, cuda)
    data = _eval_split(pb.spec)
    tables = make_tables(pb.spec, 64, 96)
    carries, counts = {}, {}
    for graph in (False, True):
        torch.cuda.synchronize()
        before = dispatch.launches()
        carries[graph] = packed.sweep_carry(
            types.SimpleNamespace(n_classes=9, n_rels=7, hashidx_rels=None),
            pb, pb.model, cfg, mode="test", data=data, tables=tables,
            batch_size=4, localize_ctx=tier, graph=graph)
        torch.cuda.synchronize()
        counts[graph] = _launch_delta(before)
        assert dispatch.last_dispatch("eval_sweep")["path"] == (
            "graph" if graph else "eager")
    assert carries[True].keys() == carries[False].keys()
    for k, v in carries[False].items():
        assert np.array_equal(carries[True][k], v), k
    assert int(carries[True]["n_batches"]) == 7
    dtype = torch.bfloat16 if compute == "bfloat16" else torch.float32
    three = KERNEL_NAMES[("fused_ctx_pool", dtype)]
    tri = KERNEL_NAMES[("fused_ctx_pool_triple", dtype)]
    want = {tri: 6, three: 1} if tier == "triple" else {three: 7}
    assert counts[True] == counts[False] == want


@pytest.mark.parametrize("tier", [False, "tables", "triple"])
@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_graph_eval_sweep_reuses_its_graph(cuda, compute, tier):
    """A second sweep of the same key (the model's weights changed in
    place; without localisation the split's rows also in another order,
    which keeps the key) replays the graph the first one captured: no
    capture, reason "cuda: the graph of this key", and every carry entry
    bit for bit the eager sweep's on the new weights and rows, with the
    same launch counts. A split of another size captures a graph of its
    own."""
    import types

    import numpy as np

    from lirec_tpu_torch.evaluation import packed
    from lirec_tpu_torch.utils.fake_batch import make_tables

    cfg, pb = _small_int_rel_ch(compute, cuda)
    tables = make_tables(pb.spec, 64, 96)
    stand_in = types.SimpleNamespace(n_classes=9, n_rels=7,
                                     hashidx_rels=None)

    def sweep(data, graph):
        torch.cuda.synchronize()
        before = dispatch.launches()
        carry = packed.sweep_carry(
            stand_in, pb, pb.model, cfg, mode="test", data=data,
            tables=tables, batch_size=4, localize_ctx=tier, graph=graph)
        torch.cuda.synchronize()
        return carry, _launch_delta(before)

    sweep(_eval_split(pb.spec), True)
    assert dispatch.last_dispatch("eval_sweep")["reason"] == \
        "cuda: a new graph"
    with torch.no_grad():
        for p in pb.model.parameters():
            p.mul_(1.03125)
    data = _eval_split(pb.spec)
    if not tier:
        data = {k: v[::-1].copy() for k, v in data.items()}
    got, got_counts = sweep(data, True)
    assert dispatch.last_dispatch("eval_sweep")["reason"] == \
        "cuda: the graph of this key"
    assert len(packed._GRAPHS[pb.model]) == 1
    want, want_counts = sweep(data, False)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    assert got_counts == want_counts
    sweep(_eval_split(pb.spec, full=5), True)
    assert dispatch.last_dispatch("eval_sweep")["reason"] == \
        "cuda: a new graph"
    assert len(packed._GRAPHS[pb.model]) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_fork_and_join_under_capture(cuda, dtype):
    """scatter_accum3 captured in a CUDA graph, with a row of 414 updates
    (the counting sort, which lists the hot tiles, then the hot tiles on
    the side stream, forked from and joined to the capture stream by the
    launch's events, beside the short items): each replay, on new updates
    copied into the static inputs, gives the eager launch's output on
    those updates bit for bit and adds one launch to the scatter's count
    (and one to the sort's)."""
    from lirec_tpu_torch.utils.graphs import StepGraph

    idx, gs = _updates(cuda, dtype, dup_rows=1)
    name = sa.KERNEL_NAMES[dtype]
    out = {}

    def step():
        out["accs"] = sa.scatter_accum3(idx, *gs, 50, 70)

    before = dispatch.launches(name)
    graph = StepGraph(step, cuda)  # the warm-up launches once
    assert graph.launches == {name: 1, sa.SORT_NAME: 1}
    assert dispatch.launches(name) == before + 1
    for seed in (2, 3):
        _, fresh = _updates(cuda, dtype, dup_rows=1, seed=seed)
        for g, f in zip(gs, fresh):
            g.copy_(f)
        graph.replay()
        want = sa.scatter_accum3(idx, *fresh, 50, 70)
        torch.cuda.synchronize()
        for got, w in zip(out["accs"], want):
            assert torch.equal(got, w)
    assert dispatch.launches(name) == before + 5


def test_checkpoints_after_graph_steps_read_back(cuda, tmp_path):
    """After three steps of the epoch sweep's graph (capturable Adam, its
    step counts on the card), the .pth.tar holds the non-capturable form
    (capturable off, step counts on the host, 3), which load_state puts
    back into a card optimizer (capturable, counts on the card) and a CPU
    one; the msgpack .ckpt holds the JAX package's count 3 and its
    moments, which load_train_state_any reads back into a card optimizer
    bitwise."""
    from lirec_tpu_torch.checkpoint import saver
    from lirec_tpu_torch.cli.common import load_train_state_any
    from lirec_tpu_torch.train.optim import load_state, make_optimizer
    from lirec_tpu_torch.train.sweep import EpochSweep
    from lirec_tpu_torch.utils.fake_batch import make_batch, make_tables

    _, pb = _small_int_rel_ch("float32", cuda)
    tables = {k: torch.from_numpy(v).to(cuda)
              for k, v in make_tables(pb.spec, 64, 96).items()}
    opt = make_optimizer(pb.model.parameters(), 1e-3)
    sweep = EpochSweep(pb, opt, tables, 0, 4, require_graph=True)
    sweep.fetch(sweep.run([make_batch(pb.spec, 4, 64, 96, seed=s)
                           for s in range(3)], 0))
    pth, ckpt = str(tmp_path / "s.pth.tar"), str(tmp_path / "s.ckpt")
    saver.save_train_state_any(pth, pb.model, opt, 0, "torch")
    saver.save_train_state_any(ckpt, pb.model, opt, 0, "msgpack")
    _, file_opt, _ = saver.load_train_state(pth)
    assert all(not g["capturable"] for g in file_opt["param_groups"])
    for st in file_opt["state"].values():
        assert st["step"].device.type == "cpu" and float(st["step"]) == 3.0
    for device in (cuda, torch.device("cpu")):
        _, other = _small_int_rel_ch("float32", device)
        other_opt = make_optimizer(other.model.parameters(), 1e-3)
        load_state(other_opt, file_opt)
        assert other_opt.param_groups[0]["capturable"] == (
            device.type == "cuda")
        for p, st in other_opt.state.items():
            assert st["step"].device == p.device
            assert float(st["step"]) == 3.0
    _, other = _small_int_rel_ch("float32", cuda)
    other_opt = make_optimizer(other.model.parameters(), 1e-3)
    state_dict, adam, _ = load_train_state_any(ckpt, other.model, other_opt)
    other.model.load_state_dict(state_dict)
    load_state(other_opt, adam)
    names = dict(pb.model.named_parameters())
    for n, p in other.model.named_parameters():
        assert torch.equal(p, names[n]), n
        st, want = other_opt.state[p], opt.state[names[n]]
        assert float(st["step"]) == 3.0 and st["step"].is_cuda
        assert torch.equal(st["exp_avg"], want["exp_avg"]), n
        assert torch.equal(st["exp_avg_sq"], want["exp_avg_sq"]), n


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_nccl_mesh_graph_steps_are_bitwise_the_eager_steps(cuda, compute,
                                                            tmp_path):
    """A process group of one over NCCL in this process: three steps of
    the mesh step (parallel/step.make_dp_train_step) through the epoch
    sweep's CUDA graph (recorded "graph" for "cuda: nccl mesh"), through
    its eager form and through make_train_step: the losses and parameters
    bit for bit, one sort and one scatter a step on each side."""
    import torch.distributed as td

    from lirec_tpu_torch.parallel import dist
    from lirec_tpu_torch.parallel.step import make_dp_train_step
    from lirec_tpu_torch.train.loop import make_train_step, step_generators
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.train.sweep import EpochSweep
    from lirec_tpu_torch.utils.fake_batch import make_batch, make_tables

    dist.initialize_distributed("file://" + str(tmp_path / "store"), 1, 0,
                                "cuda")
    try:
        mesh = dist.make_mesh((1, 1))
        runs = {}
        for side in ("plain", "mesh", "graph"):
            _, pb = _small_int_rel_ch(compute, cuda)
            batches = [make_batch(pb.spec, 4, 64, 96, seed=s)
                       for s in range(3)]
            tables = {k: torch.from_numpy(v).to(cuda)
                      for k, v in make_tables(pb.spec, 64, 96).items()}
            opt = make_optimizer(pb.model.parameters(), 1e-3)
            torch.cuda.synchronize()
            before = dispatch.launches()
            if side == "graph":
                sweep = EpochSweep(pb, opt, tables, 0, 4, mesh=mesh,
                                   require_graph=True)
                losses = sweep.fetch(sweep.run(batches, 0))
                last = dispatch.last_dispatch("train_loop")
                assert (last["path"], last["reason"]) == (
                    "graph", "cuda: nccl mesh")
                assert len(sweep.capture_s) == 1
            else:
                step = (make_train_step(pb, opt) if side == "plain"
                        else make_dp_train_step(pb, opt, mesh, 4))
                losses = [float(step(b, tables, step_generators(0, i, cuda)))
                          for i, b in enumerate(batches)]
            torch.cuda.synchronize()
            runs[side] = (losses, _param_copy(pb), _launch_delta(before))
    finally:
        td.destroy_process_group()
    name = sa.KERNEL_NAMES[torch.bfloat16 if compute == "bfloat16"
                           else torch.float32]
    losses, params, launched = runs["plain"]
    assert launched == {name: 3, sa.SORT_NAME: 3}
    for side in ("mesh", "graph"):
        assert runs[side][0] == losses, side
        assert runs[side][2] == launched, side
        for n, p in params.items():
            assert torch.equal(runs[side][1][n], p), (side, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_tier_matches_kernel_4(cuda, dtype):
    """fused_ctx_pool_triple(force="matmul") against kernel 4 on the same
    local table (repeated rows, an empty row): within 1e-5 of scale; the
    kernel launches and the tier does not. With TF32 on, the f32 tier
    refuses to run."""
    g = torch.Generator(device=cuda).manual_seed(4)
    M, R, U, width = 96, 18, 40, 1536
    fused = torch.randn(U, width, device=cuda, generator=g).to(dtype)
    tidx = torch.randint(0, U, (M, R), device=cuda, generator=g).to(
        torch.int32)
    mask = (torch.rand(M, R, device=cuda, generator=g) < 0.5).float()
    mask[0] = 0.0
    name = KERNEL_NAMES[("fused_ctx_pool_triple", dtype)]
    before = dispatch.launches(name)
    want = fused_ctx_pool_triple(fused, tidx, mask, True)
    got = fused_ctx_pool_triple(fused, tidx, mask, True, force="matmul")
    torch.cuda.synchronize()
    assert dispatch.launches(name) == before + 1
    assert dispatch.last_dispatch(name)["path"] == "matmul"
    assert got.dtype == torch.float32
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    if dtype == torch.float32:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with pytest.raises(RuntimeError, match="TF32"):
                fused_ctx_pool_triple(fused, tidx, mask, True,
                                      force="matmul")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32


def test_a_failed_capture_raises(cuda):
    """A step that reads the card from the host cannot be captured: the
    capture raises, and nothing is counted for it. (Last in the file: a
    refused capture may leave its stream's allocations with the dead
    graph's pool.)"""
    from lirec_tpu_torch.utils.graphs import StepGraph

    x = torch.ones(4, device=cuda)

    def step():
        x.add_(float(x.sum()))

    before = dispatch.launches()
    with pytest.raises(RuntimeError):
        StepGraph(step, cuda)
    assert dispatch.launches() == before
