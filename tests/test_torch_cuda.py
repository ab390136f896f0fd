"""The CUDA ctx-pool kernel against its plain PyTorch version, on the card.

Marked ``cuda``: these skip without a CUDA device. The file imports no jax,
so it runs on a machine without it:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from lirec_tpu_torch.models.tabular import EmbeddedTables
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.ops.gather_pool import (
    KERNEL_NAMES,
    fused_ctx_pool,
    fused_ctx_pool_reference,
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
    name = KERNEL_NAMES[dtype]
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
