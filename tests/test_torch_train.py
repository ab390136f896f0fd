"""The port's training slice against the JAX package, module by module and
whole: select, dropout, the hybrid forward and its gradients, the losses,
Adam and its state conversion, the epoch iterator, and train() itself.

Small widths (text 32, visual 64, joint 256), the presets' geometry (T = 20
hypotheses, R = 18 context clips), weights made by the JAX package and
converted with params_from_jax, inputs from numpy seeds, torch on one
thread. Dropout masks cannot match JAX's key stream, so parity runs with
deterministic=True (or dropout 0) and dropout is checked for its
distribution.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lirec_tpu import config as config_lib
from lirec_tpu.data import synthetic
from lirec_tpu.data.dataset import InteractionDataset
from lirec_tpu.data.localize import localize_batch
from lirec_tpu.data.pipeline import BatchIterator
from lirec_tpu.models import losses as jax_losses
from lirec_tpu.models.factory import create_model as jax_create_model
from lirec_tpu.ops.select import select_along_axis as jax_select
from lirec_tpu.train.loop import train as jax_train
from lirec_tpu.train.optim import make_optimizer as jax_make_optimizer
from lirec_tpu.utils.fake_batch import make_batch, make_tables
from lirec_tpu_torch import config as port_config
from lirec_tpu_torch.checkpoint import opt_state_from_jax, params_from_jax
from lirec_tpu_torch.data import synthetic as port_synthetic
from lirec_tpu_torch.data.dataset import InteractionDataset as PortDataset
from lirec_tpu_torch.data.pipeline import EpochIterator
from lirec_tpu_torch.models import layers, losses
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.ops.select import select_along_axis
from lirec_tpu_torch.train.loop import (
    _pad_batch,
    make_train_step,
    step_generators,
    train,
)
from lirec_tpu_torch.train.optim import make_optimizer

N_CLIPS, N_TRACKS = 64, 96
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(preset="int_rel_ch", compute="float32", **tasks):
    cfg = config_lib.preset(preset)
    cfg = cfg.with_dims(text_dim=32, visual_dim=64, joint_dim=256)
    if tasks:
        cfg = cfg.with_tasks(**tasks)
    return cfg.with_runtime(compute_dtype=compute)


def _pair(preset="int_rel_ch", compute="float32"):
    cfg = _cfg(preset, compute)
    jb = jax_create_model(cfg, 9, n_rels=6)
    pb = create_model(cfg, 9, n_rels=6, device="cpu")
    pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                          jb.params)))
    return jb, pb


def _batch(spec, preset, B=3, seed=2):
    """A make_batch batch cut to the preset's layout (as
    tests/test_hybrid.py does)."""
    batch = make_batch(spec, B, N_CLIPS, N_TRACKS, seed=seed)
    if preset == "int_rels":
        batch["feat_idx"] = batch["feat_idx"][:, 0]
        batch["rels_mask"] = batch["rels_mask"][:, 0][..., None]
        batch["labels"] = batch["labels"][:, None]
        batch["rels_label"] = batch["rels_label"][:, 0]
    elif preset == "int_ch":
        batch["feat_idx"] = batch["feat_idx"][:, :, :1, :]
        del batch["rels_mask"]
    return batch


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_close_scaled(got, want, rel, name, bf16_ulps=0):
    """|got - want| <= rel * (|want| + max|want|) + bf16_ulps bf16 ulps of
    |want|: the relative contract, with elements far below the tensor's
    scale held to that scale, and (for values rounded to bf16 at the end
    on both sides) room for that last rounding."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    assert not np.isnan(got).any(), name
    scale = float(np.abs(want).max()) if want.size else 0.0
    bound = rel * (np.abs(want) + scale)
    if bf16_ulps:
        exp = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
        bound = bound + bf16_ulps * 2.0 ** (exp - 7)
    bad = np.abs(got - want) > bound
    assert not bad.any(), "%s: %d of %d beyond the bound; worst |diff| %.3e" % (
        name, bad.sum(), bad.size, float(np.abs(got - want).max()))


# ------------------------------------------------------------- select


def test_select_along_axis_matches_jax():
    """Exact: the same element is picked, -inf passes through unharmed
    (no one-hot product), out-of-range indices clamp."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 5, 7)).astype(np.float32)
    x[0, 1, 3] = -np.inf
    for axis, idx in ((2, rng.integers(-2, 9, (4, 5))),
                      (1, rng.integers(0, 5, (4, 7))),
                      (2, np.array([[3], [0], [6], [9]]))):
        want = np.asarray(jax_select(jnp.asarray(x), jnp.asarray(idx), axis))
        got = select_along_axis(torch.from_numpy(x), torch.from_numpy(idx),
                                axis)
        assert not np.isnan(got.numpy()).any()
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- dropout


def test_dropout_keeps_and_scales():
    """Keeps about 1 - p (within 5 standard deviations of the binomial),
    scales kept values by 1/(1 - p); the same seed gives the same mask;
    deterministic or p = 0 is the identity and draws nothing."""
    x = torch.ones(200, 500)
    p = 0.3
    rng = layers.DropoutRng(torch.Generator().manual_seed(1))
    y = layers.dropout(x, p, rng, deterministic=False)
    kept = y != 0
    n = x.numel()
    assert abs(float(kept.float().mean()) - (1 - p)) < 5 * np.sqrt(
        p * (1 - p) / n)
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    again = layers.dropout(x, p, layers.DropoutRng(
        torch.Generator().manual_seed(1)), deterministic=False)
    assert torch.equal(y, again)
    other = layers.dropout(x, p, rng, deterministic=False)
    assert not torch.equal(y, other) and rng.calls == 2
    assert layers.dropout(x, p, rng, deterministic=True) is x
    assert layers.dropout(x, 0.0, rng, deterministic=False) is x
    assert rng.calls == 2
    bf = layers.dropout(x.bfloat16(), p, rng, deterministic=False)
    assert bf.dtype == torch.bfloat16


def test_train_forward_draws_masks_in_the_jax_call_order():
    """int_rel_ch draws 11 masks per forward, in the JAX package's order
    (4 ints MLPs, ints output, 4 ctx MLPs, ctx output, gate); the same
    generator seed gives the same outputs."""
    _, pb = _pair()
    _, pt = _tables(pb.spec)
    batch = {k: v for k, v in _batch(pb.spec, "int_rel_ch").items()
             if k in ("feat_idx", "rels_mask")}
    counts = []
    orig = layers.DropoutRng.__init__

    def spy(self, generator):
        orig(self, generator)
        counts.append(self)

    outs = []
    for _ in range(2):
        layers.DropoutRng.__init__ = spy
        try:
            outs.append(pb.apply(pb.model, batch, tables=pt,
                                 deterministic=False,
                                 rng=torch.Generator().manual_seed(5)))
        finally:
            layers.DropoutRng.__init__ = orig
    assert [c.calls for c in counts] == [11, 11]
    for key in ("inters", "rels"):
        assert torch.equal(outs[0][key], outs[1][key])
    det = pb.apply(pb.model, batch, tables=pt, use_tabular=False)
    assert not torch.equal(det["inters"], outs[0]["inters"])


# -------------------------------------------------- hybrid forward + grads


def _tables(spec, seed=1):
    np_tables = make_tables(spec, N_CLIPS, N_TRACKS, seed=seed)
    return ({k: jnp.asarray(v) for k, v in np_tables.items()},
            {k: torch.from_numpy(v) for k, v in np_tables.items()})


@pytest.mark.parametrize("compute,rel", [("float32", 2e-6),
                                         ("bfloat16", 4.1e-3)])
@pytest.mark.parametrize("preset", ["int_rel_ch", "int_ch", "int_rels"])
def test_hybrid_forward_and_step_grads_match_jax(preset, compute, rel):
    """The hybrid training forward (deterministic=True; JAX with
    use_tabular=False, as tests/test_hybrid.py) and the gradients of the
    preset's loss with respect to every parameter, against jax.grad. f32:
    rtol 2e-6 of each tensor's scale (f32 sums in another order). bf16
    compute: 4.1e-3 (each GEMM rounds its operands to bf16, the h1 tables
    are stored bf16, and the gradients flowing back through those casts are
    rounded to bf16 on both sides; a value one f32 ulp apart can round to
    the neighbouring bf16), and the weight gradients, which end in that
    rounding, one bf16 ulp more."""
    jb, pb = _pair(preset, compute)
    jt, pt = _tables(jb.spec)
    batch = _batch(jb.spec, preset)
    mb = {k: batch[k] for k in ("feat_idx", "rels_mask") if k in batch}

    def jloss(params):
        out = jb.apply(params, mb, tables=jt, deterministic=True,
                       use_tabular=False)
        return jb.loss(out, batch), out

    (want_loss, want_out), want_grads = jax.value_and_grad(
        jloss, has_aux=True)(jb.params)
    out = pb.apply(pb.model, mb, tables=pt, deterministic=True,
                   use_tabular=False)
    loss = pb.loss(out, _tensors(batch))
    loss.backward()
    for key in ("inters", "rels"):
        if want_out[key] is None:
            assert out[key] is None
            continue
        _assert_close_scaled(out[key].detach().numpy(), want_out[key], rel,
                             key)
    _assert_close_scaled(loss.item(), want_loss, rel, "loss")
    got = {n: p.grad for n, p in pb.model.named_parameters()}
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    assert set(got) == set(want)
    ulps = int(compute == "bfloat16")
    for name, g in got.items():
        _assert_close_scaled(g.numpy(), want[name].numpy(), rel, name, ulps)


def test_localized_batch_gives_the_full_table_forward():
    """A batch remapped to batch-local tables (uniq_clip / uniq_track)
    gives the same outputs and gradients as the full-table batch: the
    first layers are row-independent (f32 GEMMs over other row sets:
    rtol 2e-6 of scale)."""
    _, pb = _pair()
    _, pt = _tables(pb.spec)
    batch = _batch(pb.spec, "int_rel_ch")
    batch["feat_idx"] %= np.array([40, 70, 70], np.int32)
    loc = localize_batch(batch, cap_clip=48, cap_track=80,
                         n_clips=N_CLIPS, n_tracks=N_TRACKS)
    assert loc["uniq_clip"].shape == (48,)
    results = []
    for b in (batch, loc):
        pb.model.zero_grad()
        mb = {k: b[k] for k in ("feat_idx", "rels_mask", "uniq_clip",
                                "uniq_track") if k in b}
        out = pb.apply(pb.model, mb, tables=pt, use_tabular=False)
        pb.loss(out, _tensors(batch)).backward()
        results.append((out, {n: p.grad.clone()
                              for n, p in pb.model.named_parameters()}))
    for key in ("inters", "rels"):
        _assert_close_scaled(results[1][0][key].detach(),
                             results[0][0][key].detach(), 2e-6, key)
    for name, g in results[0][1].items():
        _assert_close_scaled(results[1][1][name], g, 2e-6, name)


# ------------------------------------------------------------- losses


def _loss_inputs(seed=3, B=5, T=20, C=9, NR=6):
    spec = create_model(_cfg(), C, n_rels=NR, device="cpu").spec
    batch = make_batch(spec, B, N_CLIPS, N_TRACKS, seed=seed)
    rng = np.random.default_rng(seed)
    outputs = {"inters": rng.standard_normal((B, T, C)).astype(np.float32),
               "rels": rng.standard_normal((B, T, NR)).astype(np.float32)}
    return batch, outputs


_LOSS_CASES = [
    ("margin_track_rels", dict(tr_correct=False)),
    ("margin_track_rels", dict(tr_correct=True)),
    ("margin_track_rels", dict(tr_correct=False, tr_max_neg=True,
                               tr_sum_max_flag=True)),
    ("margin_track_rels", dict(tr_correct=True, tr_max_neg=True,
                               tr_sum_max_flag=False)),
    ("margin", dict(tr_correct=False)),
    ("margin", dict(tr_correct=True)),
    ("margin", dict(tr_correct=False, tr_max_neg=True,
                    tr_sum_max_flag=True)),
    ("margin", dict(tr_correct=True, tr_max_neg=True,
                    tr_sum_max_flag=False)),
    ("multitask_max_margin", dict()),
    ("multitask_ce", dict()),
    ("max_margin_ce", dict()),
]


def _call_loss(lib, name, outputs, batch, kw, **extra):
    if name == "margin_track_rels":
        return lib.margin_track_rels_loss(outputs, batch, 6, tr_margin=0.101,
                                          lymbda=1.0, **kw, **extra)
    if name == "margin":
        return lib.margin_loss(outputs, batch, tr_margin=0.101, **kw, **extra)
    one = {"inters": outputs["inters"][:, 0]}
    if name == "multitask_max_margin":
        b = dict(batch, labels=batch["labels"][:, None],
                 rels_label=batch["rels_label"][:, 0])
        return lib.multitask_max_margin_loss(
            dict(one, rels=outputs["rels"][:, 0]), b, 6, margin=0.101,
            lymbda=1.0)
    if name == "multitask_ce":
        b = dict(batch, rels_label=batch["rels_label"][:, 0])
        return lib.multitask_ce_loss(dict(one, rels=outputs["rels"][:, 0]),
                                     b, 6)
    return lib.max_margin_ce_loss(one, batch, margin=0.101)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("name,kw", _LOSS_CASES)
def test_losses_match_jax(name, kw, padded):
    """Value and gradient with respect to the logits, rtol 2e-6 of scale
    (f32 sums in another order). padded: the batch is padded with
    loss_weight 0 rows, and both sides must also give the unpadded value."""
    batch, outputs = _loss_inputs()
    if padded:
        batch = _pad_batch(batch, 8)
        outputs = {k: np.concatenate([v, v[:3]]) for k, v in outputs.items()}

    def jfn(o):
        return _call_loss(jax_losses, name, o, batch, kw)

    want, want_grad = jax.value_and_grad(jfn)(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    tout = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in outputs.items()}
    got = _call_loss(losses, name, tout, _tensors(batch), kw)
    got.backward()
    _assert_close_scaled(got.item(), want, 2e-6, "loss")
    for k, t in tout.items():
        if t.grad is None:  # a head this loss does not read
            assert not np.asarray(want_grad[k]).any(), k
            continue
        _assert_close_scaled(t.grad.numpy(), want_grad[k], 2e-6, k)
    if padded:
        b5, o5 = _loss_inputs()
        ref = _call_loss(losses, name, _tensors(o5), _tensors(b5), kw)
        _assert_close_scaled(got.item(), ref.item(), 2e-6, "unpadded")


@pytest.mark.parametrize("name", ["margin_track_rels", "margin"])
def test_tr_cat_distr_samples_only_valid_hypotheses(name):
    """With one valid hypothesis per sample, the categorical draw must pick
    it, so the sampled loss equals the argmax one; a loss generator is
    required."""
    batch, outputs = _loss_inputs(seed=4)
    batch["mem_mask"][:] = 0
    batch["mem_mask"][np.arange(5), np.array([0, 3, 7, 1, 19])] = 1
    tb, to = _tensors(batch), _tensors(outputs)
    base = _call_loss(losses, name, to, tb, dict(tr_correct=False))
    for seed in range(3):
        got = _call_loss(losses, name, to, tb,
                         dict(tr_correct=False, tr_cat_distr=True),
                         rng=torch.Generator().manual_seed(seed))
        assert torch.equal(got, base)
    with pytest.raises(ValueError, match="generator"):
        _call_loss(losses, name, to, tb, dict(tr_correct=False,
                                              tr_cat_distr=True))


# ------------------------------------------------------------- Adam


def _grad_stream(jb, steps, seed=6):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), jb.params) for _ in range(steps)]


def _jax_adam(jb, grads, lr, wd):
    tx = jax_make_optimizer(lr, wd)
    params = jb.params
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return params, state


def _port_step(pb, opt, g):
    for name, t in params_from_jax(g).items():
        pb.model.get_parameter(name).grad = t
    opt.step()


def test_adam_matches_the_optax_chain():
    """5 steps on fixed gradients: torch's Adam(weight_decay) against
    make_optimizer's add_decayed_weights -> scale_by_adam -> lr chain.
    Each step's update may differ by 2e-5 of lr: optax computes the bias
    correction 1 - 0.999**t in f32, where the cancellation leaves ~1e-5
    relative error, torch in double."""
    jb, pb = _pair()
    grads = _grad_stream(jb, 5)
    want, _ = _jax_adam(jb, grads, 1e-3, 1e-2)
    opt = make_optimizer(pb.model.parameters(), 1e-3, 1e-2)
    for g in grads:
        _port_step(pb, opt, g)
    want = params_from_jax(jax.tree.map(np.asarray, want))
    for name, p in pb.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=5 * 2e-5 * 1e-3, err_msg=name)


def test_opt_state_from_jax_resumes_the_trajectory():
    """JAX runs 2 steps; its params and Adam state go to the port, whose
    3rd step lands where JAX's 3rd does (within 2e-5 of lr, as above)."""
    jb, pb = _pair()
    grads = _grad_stream(jb, 3, seed=7)
    p2, s2 = _jax_adam(jb, grads[:2], 1e-3, 1e-2)
    p3, _ = _jax_adam(jb, grads, 1e-3, 1e-2)
    pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, p2)))
    opt = make_optimizer(pb.model.parameters(), 1e-3, 1e-2)
    opt.load_state_dict(opt_state_from_jax(
        jax.tree.map(np.asarray, s2), pb.model, opt))
    st = opt.state[pb.model.get_parameter("txt_ints.weight")]
    assert float(st["step"]) == 2.0
    assert st["exp_avg"].shape == pb.model.txt_ints.weight.shape
    _port_step(pb, opt, grads[2])
    want = params_from_jax(jax.tree.map(np.asarray, p3))
    for name, p in pb.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=2e-5 * 1e-3, err_msg=name)
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        opt_state_from_jax((optax.EmptyState(),), pb.model, opt)


# ------------------------------------------------- data, step, train()


@pytest.fixture(scope="module")
def pinned_synth_root(tmp_path_factory):
    """The synthetic fixture written under a fixed string-hash seed.
    ``synthetic.generate`` orders some rows by set iteration, so its files
    change with PYTHONHASHSEED. In about one draw in four the margin loss
    then has a kink (a relu or a max) within f32 rounding of some step's
    parameters: both implementations give the same gradient at the same
    parameters, but the two trajectories reach that step a few ulps apart,
    take different sides and part by more than rounding. Pinned, every run
    compares the same data, a draw without such a kink."""
    root = str(tmp_path_factory.mktemp("mg_synth_pinned"))
    subprocess.run(
        [sys.executable, "-c", "import sys; from lirec_tpu.data import "
         "synthetic; synthetic.generate(sys.argv[1])", root],
        cwd=ROOT, check=True, env=dict(os.environ, PYTHONHASHSEED="7"))
    return root


def _synth_setup(synth_root, batch_size, dropout=0.0, port=False,
                 store_root="", splits=("train",)):
    """(cfg, train dataset) from the JAX package's host tier, or with
    port=True from the port's own copy of it; with more `splits`, (cfg,
    dataset per split), the eval splits sharing the first one's classes."""
    cfg_lib, synth, dataset = ((port_config, port_synthetic, PortDataset)
                               if port else
                               (config_lib, synthetic, InteractionDataset))
    base = synth.make_config(synth_root)
    cfg = cfg_lib.preset("int_rel_ch", data_root=synth_root)
    paths = base.paths
    if store_root:
        paths = dataclasses.replace(paths, store_root=store_root)
    cfg = cfg.replace(dims=base.dims, paths=paths).with_runtime(
        compute_dtype="float32"
    ).with_optim(batch_size=batch_size, epochs=2, save_model=False, lr=1e-3,
                 dropout=dropout)
    out = []
    for mode in splits:
        ds = dataset(cfg, mode=mode)
        if out:
            ds.n_classes = out[0].n_classes
        ds.cache()
        ds.init_relships()
        out.append(ds)
    return (cfg, out[0]) if len(splits) == 1 else (cfg, *out)


@pytest.mark.parametrize("plan", [True, False])
def test_epoch_iterator_is_bitwise_batch_iterator(synth_root, monkeypatch,
                                                  plan):
    """Two shuffled epochs of the port's dataset, with the assembly plan
    and per sample (LIREC_TPU_NO_PLAN), give bitwise BatchIterator's
    batches of the JAX package's."""
    if not plan:
        monkeypatch.setenv("LIREC_TPU_NO_PLAN", "1")
    _, ds = _synth_setup(synth_root, 5)
    _, port_ds = _synth_setup(synth_root, 5, port=True)
    want_it = BatchIterator(ds, 5, shuffle=True, seed=3)
    got_it = EpochIterator(port_ds, 5, seed=3)
    assert len(got_it) == len(want_it)
    assert (got_it.plan() is not None) == plan
    for _ in range(2):
        want, got = list(want_it), list(got_it)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_train_matches_jax_trajectory(pinned_synth_root):
    """Both per-batch train() loops (epoch_sweep=False; the sweeps are
    tests/test_torch_epoch_sweep.py's) on the synthetic fixture, f32,
    dropout 0, tr_cat_distr off, 2 epochs:
    batch 7 (22 samples: the size-1 leftover is skipped) and batch 8 (the
    port pads the last batch of 6 with loss_weight 0; JAX runs it
    unpadded). Per-epoch losses and final params within rtol 1e-5 of
    scale, as tests/test_train_sweep.py holds its two JAX loops."""
    for batch_size in (7, 8):
        cfg, ds = _synth_setup(pinned_synth_root, batch_size)
        n_rels = max(len(ds.rels_list) - 1, 0)
        jb = jax_create_model(cfg, ds.n_classes, n_rels=n_rels)
        want = jax_train(cfg, jb, ds, verbose=False, epoch_sweep=False)
        port_cfg, port_ds = _synth_setup(pinned_synth_root, batch_size,
                                         port=True)
        pb = create_model(port_cfg, ds.n_classes, n_rels=n_rels,
                          device="cpu")
        pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                              jb.params)))
        got = train(port_cfg, pb, port_ds, verbose=False, epoch_sweep=False)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        assert got["localized_tables"] == want["localized_tables"]
        final = params_from_jax(jax.tree.map(np.asarray, want["params"]))
        for name, p in got["model"].named_parameters():
            _assert_close_scaled(p.detach(), final[name], 1e-5, name)


def test_train_step_runs_with_dropout_and_moves_every_parameter():
    """One make_train_step step with dropout 0.3 and tr_cat_distr on: a
    finite loss, every parameter moved, and the same generators give the
    same step."""
    cfg = _cfg(tr_cat_distr=True)
    states = []
    for _ in range(2):
        pb = create_model(cfg, 9, n_rels=6, device="cpu")
        before = {n: p.detach().clone()
                  for n, p in pb.model.named_parameters()}
        _, pt = _tables(pb.spec)
        opt = make_optimizer(pb.model.parameters(), 1e-3)
        step = make_train_step(pb, opt)
        batch = make_batch(pb.spec, 4, N_CLIPS, N_TRACKS, seed=9)
        loss = step(batch, pt, step_generators(0, 5, "cpu"))
        assert torch.isfinite(loss)
        for n, p in pb.model.named_parameters():
            assert not torch.equal(p.detach(), before[n]), n
        states.append((loss, pb.model.state_dict()))
    assert torch.equal(states[0][0], states[1][0])
    for k, v in states[0][1].items():
        assert torch.equal(v, states[1][1][k]), k


def test_train_step_rejects_out_of_range_ids():
    pb = create_model(_cfg(), 9, n_rels=6, device="cpu")
    _, pt = _tables(pb.spec)
    step = make_train_step(pb, make_optimizer(pb.model.parameters(), 1e-3))
    batch = make_batch(pb.spec, 2, N_CLIPS, N_TRACKS, seed=1)
    batch["feat_idx"][1, 3, 4, 2] = N_TRACKS
    with pytest.raises(ValueError, match="track index"):
        step(batch, pt, step_generators(0, 0, "cpu"))


def test_step_generators_are_two_seeded_streams():
    a = step_generators(0, 100003, "cpu")
    b = step_generators(0, 100003, "cpu")
    c = step_generators(0, 100004, "cpu")
    draw = [torch.rand(4, generator=g) for g in a + b + c]
    assert torch.equal(draw[0], draw[2]) and torch.equal(draw[1], draw[3])
    assert not torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[4])


def test_train_raises_for_what_is_not_ported(synth_root, tmp_path):
    """A mesh with a 'model' axis is refused by name, naming its ROADMAP
    item; dense batches, cadence evaluation on a val_dataset and
    checkpoint writing, refused before, now run (dense parity with the JAX
    package: tests/test_torch_dense.py)."""
    from lirec_tpu_torch.parallel.dist import MODEL_AXIS_ITEM

    cfg, ds = _synth_setup(synth_root, 7, port=True,
                           store_root=str(tmp_path))
    pb = create_model(cfg, ds.n_classes,
                      n_rels=max(len(ds.rels_list) - 1, 0), device="cpu")
    with pytest.raises(NotImplementedError, match=MODEL_AXIS_ITEM):
        train(cfg, pb, ds, verbose=False, mesh=(1, 2))
    dense = train(cfg.with_optim(epochs=1), pb, ds, verbose=False,
                  dense=True)
    assert np.isfinite(dense["losses"]).all()
    assert dense["localized_tables"] is False
    out = train(cfg.with_optim(save_model=True, epochs=1), pb, ds,
                val_dataset=ds, checkpoint_every=1, verbose=False)
    assert out["final_path"] == str(tmp_path / "0.pth.tar")
    for name in ("0.pth.tar", "latest.pth.tar", "index.json"):
        assert (tmp_path / name).exists(), name
    assert list(out["saver"].eval["total"]) == [0]


def test_train_cadence_matches_jax(pinned_synth_root, tmp_path):
    """Both train() loops (the JAX one per batch) with val and test
    splits, save_model and a store root, dropout 0, 3 epochs at test_fr 2
    (cadences at epochs 0 and 2): the savers keep the same epochs with the
    same metric values per key, and write the same index.json; both end
    with the final <epochs-1> train state. Near-tie argmaxes do not flip
    on this pinned fixture at lr 1e-3."""
    results = {}
    for port in (False, True):
        store = str(tmp_path / ("port" if port else "jax"))
        cfg, ds, val, test = _synth_setup(
            pinned_synth_root, 8, port=port, store_root=store,
            splits=("train", "val", "test"))
        cfg = cfg.with_optim(epochs=3, test_fr=2, save_model=True)
        n_rels = max(len(ds.rels_list) - 1, 0)
        if port:
            pb = create_model(cfg, ds.n_classes, n_rels=n_rels, device="cpu")
            pb.model.load_state_dict(params_from_jax(
                jax.tree.map(np.asarray, jb.params)))
            out = train(cfg, pb, ds, val_dataset=val, test_dataset=test,
                        verbose=False)
        else:
            jb = jax_create_model(cfg, ds.n_classes, n_rels=n_rels)
            out = jax_train(cfg, jb, ds, val_dataset=val, test_dataset=test,
                            verbose=False, epoch_sweep=False)
        with open(os.path.join(store, "index.json")) as f:
            results[port] = (out, json.load(f))
    (want, want_index), (got, got_index) = results[False], results[True]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert set(got["saver"].eval) == set(want["saver"].eval)
    for key, kept in want["saver"].eval.items():
        assert list(got["saver"].eval[key]) == list(kept), key
        np.testing.assert_allclose(list(got["saver"].eval[key].values()),
                                   list(kept.values()), rtol=2e-6,
                                   err_msg=key)
    assert sorted(want["saver"].eval["total"]) == [0, 2]
    assert set(got_index) == set(want_index)
    for key in want_index:
        assert list(got_index[key]) == list(want_index[key])
    assert got["final_path"].endswith("2.pth.tar")
    assert want["final_path"].endswith("2.ckpt")
