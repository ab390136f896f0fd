"""The CUDA kernels (ctx pools, masked gather-sum, scatter-accumulate)
against their plain PyTorch versions, and one train step, on the card.

Marked ``cuda``: these skip without a CUDA device. The file imports no jax,
so it runs on a machine without it:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

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


def test_kernel_raises_instead_of_falling_back(cuda):
    emb, idx, mask = _inputs(cuda, torch.float32)
    with pytest.raises(ValueError, match="int32"):
        fused_ctx_pool(emb, idx.long(), mask, True)
    with pytest.raises(ValueError, match="on cpu"):
        fused_ctx_pool(emb, idx.cpu(), mask, True)


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
    """f32 sums in r order against the plain version's: f32 within 1e-5,
    bf16 output within one bf16 rounding of the sum."""
    emb, idx, mask = _inputs(cuda, dtype)
    table, one = emb.clip, idx[..., 0].contiguous()
    name = KERNEL_NAMES[("gather_masked_sum", dtype)]
    before = dispatch.launches(name)
    got = gather_masked_sum(table, one, mask)
    torch.cuda.synchronize()
    assert dispatch.launches(name) == before + 1
    assert got.dtype == dtype
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
    the f32 sum rounded. dup_rows=1 puts 414 updates into one row: past the
    row kernel's 128 and the long-row kernel's 256-update chunk, with a
    width (520) that ends in a partial 16-column tile."""
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
