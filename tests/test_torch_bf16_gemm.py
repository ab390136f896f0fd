"""The bf16 products (models/layers.matmul_bf16, product, linear) on CPU
tensors, where the function's GEMM is the f32 product of the bf16 values:
its forward and gradients against the cast chain ``x.to(bf16).float()``
that CPU tensors keep, the products its backward skips, the rounding of a
sharded layer's input gradient around the model group's sum, and the
routing that keeps CPU tensors and f32 compute off it; and the card's
bf16 masked sum of the training ctx pool (models/hybrid) against its
einsum. (tests/test_torch_train.py holds the function against the JAX
package.)
"""

import pytest
import torch

from lirec_tpu_torch.models import layers
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.parallel.mesh import COLUMN, ROW, Shard

BF16 = torch.bfloat16
SHAPES = [((64, 512), 101), ((4, 5, 96), 40), ((37, 50), 30)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _operands(x_shape, n_out, x_dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(x_shape, generator=g).to(x_dtype)
    w = torch.randn(n_out, x_shape[-1], generator=g) / 10
    return x, w


def _cast_chain(x, w):
    """Today's CPU product: both operands rounded to bf16, an f32 GEMM."""
    return torch.nn.functional.linear(x.to(BF16).float(), w.to(BF16).float())


def _grads(fn, x, w, g):
    x = x.detach().requires_grad_()
    w = w.detach().requires_grad_()
    y = fn(x, w)
    y.backward(g)
    return y.detach(), x.grad, w.grad


@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("x_shape,n_out", SHAPES)
def test_forward_is_the_cast_chain_product(x_shape, n_out, x_dtype):
    """Bit for bit the f32 product of the bf16-rounded operands, in the
    input's leading axes, f32."""
    x, w = _operands(x_shape, n_out, x_dtype)
    got = layers.matmul_bf16(x, w)
    assert got.dtype == torch.float32
    assert got.shape == x_shape[:-1] + (n_out,)
    assert torch.equal(got, _cast_chain(x, w))


@pytest.mark.parametrize("bf16_exact", [True, False])
@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("x_shape,n_out", SHAPES)
def test_gradients_are_the_cast_chain_gradients(x_shape, n_out, x_dtype,
                                                bf16_exact):
    """With an incoming gradient that bf16 holds exactly: both gradients
    bit for bit the cast chain's autograd gradients, in the inputs'
    dtypes. Otherwise the function takes it as two bf16 terms, which hold
    it to 2**-17: within 2**-10 of the cast chain's gradients relative, in
    norm (both are rounded to bf16 last, so an element the f32 sums leave
    near a rounding boundary differs by a bf16 step; rounding the incoming
    gradient to bf16 instead reads 2**-9 and more here)."""
    x, w = _operands(x_shape, n_out, x_dtype, seed=1)
    g = torch.randn(x_shape[:-1] + (n_out,),
                    generator=torch.Generator().manual_seed(2))
    if bf16_exact:
        g = g.to(BF16).float()
    _, gx, gw = _grads(layers.matmul_bf16, x, w, g)
    _, want_x, want_w = _grads(_cast_chain, x, w, g)
    assert gx.dtype == x_dtype and gw.dtype == torch.float32
    for got, want in ((gx, want_x), (gw, want_w)):
        assert torch.equal(got, got.to(BF16).to(got.dtype))  # bf16 values
        if bf16_exact:
            assert torch.equal(got, want)
        else:
            err = float((got.float() - want.float()).norm())
            assert err <= 2 ** -10 * float(want.float().norm())


@pytest.mark.parametrize("needs", [(True, True), (False, True),
                                   (True, False), (False, False)])
def test_backward_runs_only_the_products_it_needs(needs):
    """One GEMM forward, and two more backward (the incoming gradient's
    two bf16 terms) for each input that asks for a gradient (a first
    layer's table asks for none); no backward at all without either."""
    x, w = _operands((16, 24), 8, torch.float32)
    x.requires_grad_(needs[0])
    w.requires_grad_(needs[1])
    before = dispatch.launches(layers.GEMM_NAME)
    y = layers.matmul_bf16(x, w)
    assert dispatch.launches(layers.GEMM_NAME) == before + 1
    if any(needs):
        y.sum().backward()
    assert dispatch.launches(layers.GEMM_NAME) == before + 1 + 2 * sum(needs)
    assert (x.grad is not None, w.grad is not None) == needs


@pytest.mark.parametrize("compute,reason", [(BF16, "cpu tensors"),
                                            (None, "f32 compute")])
def test_linear_and_product_on_cpu_keep_the_cast_chain(compute, reason):
    """CPU tensors under bf16 compute, and f32 compute, never take the
    function: no bf16 GEMM counted, the decision "reference", and the
    results bit for bit the cast chain's (linear: ``F.linear`` with the
    bias; product: ``x @ w^T``)."""
    layer = layers.init_linear(96, 40, torch.Generator().manual_seed(3))
    x = torch.randn(7, 96, generator=torch.Generator().manual_seed(4))
    before = dispatch.launches(layers.GEMM_NAME)
    got = layers.linear(layer, x, compute)
    assert dispatch.last_dispatch(layers.GEMM_NAME)["path"] == "reference"
    assert dispatch.last_dispatch(layers.GEMM_NAME)["reason"] == reason
    got_p = layers.product(x, layer.weight, compute)
    assert dispatch.launches(layers.GEMM_NAME) == before
    xc, wc = x, layer.weight
    if compute is not None:
        xc, wc = x.to(compute).float(), wc.to(compute).float()
    assert torch.equal(got, torch.nn.functional.linear(xc, wc, layer.bias))
    assert torch.equal(got_p, xc @ wc.t())


class _GroupSum(torch.autograd.Function):
    """A stand-in for one process's side of a model group's collective:
    forward `x` plus the peers' `peer` (None: the identity), backward the
    gradient plus the peers' `peer_grad` (None: unchanged)."""

    @staticmethod
    def forward(ctx, x, peer, peer_grad):
        ctx.peer_grad = peer_grad
        return x.clone() if peer is None else x + peer

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.peer_grad is None else g + ctx.peer_grad), None, None


@pytest.mark.parametrize("kind", [COLUMN, ROW])
def test_sharded_linear_rounds_the_input_gradient_as_the_cast_chain(
        kind, monkeypatch):
    """A column-parallel layer through the function (the model group's
    sum of the input gradients stood in for by an f32 peer gradient)
    gives its input the gradient summed in f32 and then rounded to bf16,
    bit for bit the cast chain's; a row-parallel one (its partial
    products summed with a peer's) gives each process's input gradient
    rounded to bf16, bit for bit the cast chain's. The weight gradients
    bit for bit, the outputs within f32 sum order (the incoming gradient
    bf16-exact, as the function and the chain differ only in its split)."""
    gen = torch.Generator().manual_seed(7)
    layer = layers.init_linear(96, 40, gen)
    x = torch.randn(12, 96, generator=gen)
    dy = torch.randn(12, 40, generator=gen).to(BF16).float()
    peer = torch.randn(12, 40 if kind == ROW else 96, generator=gen)
    layer.tp_shard = Shard(kind, 2, 0, peer)
    monkeypatch.setattr(layers, "copy_to_model",
                        lambda x, group: _GroupSum.apply(x, None, group))
    monkeypatch.setattr(layers, "reduce_from_model",
                        lambda x, group: _GroupSum.apply(x, group, None))
    out = []
    for routed in (False, True):
        if routed:
            monkeypatch.setattr(layers, "on_tensor_cores",
                                lambda x, w, cdt: cdt == BF16)
        layer.zero_grad()
        xx = x.clone().requires_grad_()
        y = layers.linear(layer, xx, BF16)
        y.backward(dy)
        out.append((y.detach(), xx.grad, layer.weight.grad.clone(),
                    layer.bias.grad.clone()))
    (y0, gx0, gw0, gb0), (y, gx, gw, gb) = out
    assert torch.equal(gx, gx.to(BF16).float())
    assert torch.equal(gx, gx0)
    assert torch.equal(gw, gw0) and torch.equal(gb, gb0)
    terms = (x.to(BF16).float().abs()
             @ layer.weight.to(BF16).float().abs().t())
    assert bool(((y - y0).abs() <= 96 * 2.0 ** -23 * (
        terms + y0.abs())).all())


def _int_rel_ch_step(compute, seed=0):
    """One int_rel_ch train step at small widths on the CPU: (loss, the
    gradients Adam took)."""
    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.train.loop import make_train_step, step_generators
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.utils.fake_batch import make_batch, make_tables

    cfg = config_lib.preset("int_rel_ch").with_dims(
        text_dim=32, visual_dim=64, joint_dim=256).with_runtime(
        compute_dtype=compute)
    pb = create_model(cfg, 9, n_rels=6, seed=seed, device="cpu")
    tables = {k: torch.from_numpy(v)
              for k, v in make_tables(pb.spec, 64, 96).items()}
    step = make_train_step(pb, make_optimizer(pb.model.parameters(), 1e-3))
    grads = {}
    for n, p in pb.model.named_parameters():
        p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
    loss = step(make_batch(pb.spec, 4, 64, 96, seed=2), tables,
                step_generators(0, 0, torch.device("cpu")))
    return float(loss), grads


# the bf16 GEMMs of one int_rel_ch train step: 19 forward (8 first
# layers, 8 second layers, the gate, 2 heads); backward two a gradient,
# one gradient for each first layer (their tables ask for none), two for
# each of the other 11
GEMMS_PER_INT_REL_CH_STEP = 19 + 2 * (8 + 2 * 11)


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_a_cpu_train_step_takes_no_bf16_gemm(compute):
    """A whole int_rel_ch train step on CPU tensors counts no bf16 GEMM
    and records only "reference" decisions for it."""
    before = dispatch.launches(layers.GEMM_NAME)
    was = dispatch.decisions(layers.GEMM_NAME).get("cuda", 0)
    _int_rel_ch_step(compute)
    assert dispatch.launches(layers.GEMM_NAME) == before
    assert dispatch.decisions(layers.GEMM_NAME).get("cuda", 0) == was
    assert dispatch.last_dispatch(layers.GEMM_NAME)["path"] == "reference"


def test_the_function_through_a_whole_train_step(monkeypatch):
    """The function routed in on CPU tensors (what CUDA tensors take):
    GEMMS_PER_INT_REL_CH_STEP GEMMs a step, the step's loss within 1e-4
    of the cast chain's and every gradient within 4e-3 of it in norm (the
    f32 sums in another order, the bias added apart: 9.2e-4 at most on
    this step; rounding the incoming gradients to bf16 instead read
    6.4e-3)."""
    want_loss, want = _int_rel_ch_step("bfloat16")
    monkeypatch.setattr(layers, "on_tensor_cores",
                        lambda x, w, cdt: cdt == BF16)
    before = dispatch.launches(layers.GEMM_NAME)
    loss, got = _int_rel_ch_step("bfloat16")
    assert dispatch.launches(layers.GEMM_NAME) - before == \
        GEMMS_PER_INT_REL_CH_STEP
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    assert got.keys() == want.keys()
    for n, g in want.items():
        err = float((got[n] - g).norm())
        assert err <= 4e-3 * float(g.norm()) + 1e-7, (n, err)


def _pool_inputs(N=64, R=18, J=40, seed=5):
    g = torch.Generator().manual_seed(seed)
    h = torch.relu(torch.randn(N, R, J, generator=g)).to(BF16)
    m = (torch.rand(N, R, generator=g) < 0.6).float()
    m[0] = 0.0
    return h, m


def test_masked_sum_keeps_the_einsum_on_cpu_tensors():
    """hybrid.masked_sum of CPU tensors is the f32 einsum, bit for bit."""
    from lirec_tpu_torch.models.hybrid import masked_sum

    h, m = _pool_inputs()
    assert torch.equal(masked_sum(h, m),
                       torch.einsum("nrj,nr->nj", h.float(), m))


@pytest.mark.parametrize("shape", [(64, 18, 40), (5, 1, 520), (3, 64, 8)])
def test_bf16_masked_sum_against_the_einsum(shape):
    """The card's bf16 masked sum (no f32 copy of h, no f32 GEMM) against
    the einsum: the forward within an f32 sum-order bound (R 2**-23 of the
    sum of the terms' magnitudes), the gradient bit for bit, bf16."""
    from lirec_tpu_torch.models.hybrid import _masked_sum_bf16

    h, m = _pool_inputs(*shape)
    dy = torch.randn(shape[0], shape[2],
                     generator=torch.Generator().manual_seed(6))
    out = []
    for fn in (_masked_sum_bf16,
               lambda h, m: torch.einsum("nrj,nr->nj", h.float(), m)):
        hh = h.clone().requires_grad_()
        y = fn(hh, m)
        y.backward(dy)
        out.append((y.detach(), hh.grad))
    (y, gh), (want_y, want_gh) = out
    assert y.dtype == torch.float32 and gh.dtype == BF16
    bound = shape[1] * 2.0 ** -23 * torch.einsum(
        "nrj,nr->nj", h.float().abs(), m)
    assert bool(((y - want_y).abs() <= bound).all())
    assert torch.equal(gh, want_gh)
