"""The port writes the JAX package's msgpack checkpoints without flax or
msgpack: the encoder (checkpoint/msgpack.py) against ``msgpack.packb`` and
``flax.serialization.msgpack_serialize`` byte for byte, on hand-picked and
Hypothesis-drawn trees; ``params_to_jax`` / ``opt_state_to_jax`` against
the JAX package's param and optax state trees; the port's ``.ckpt`` files
read by the JAX package's ``load_train_state`` / ``load_params``; port ->
``.ckpt`` -> port round trips; and ``train()`` / the training CLI under
``--checkpoint-backend msgpack``, with ``--auto-resume`` taking the port's
own ``latest.ckpt``."""

import json
import os

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from lirec_tpu import checkpoint as jax_checkpoint
from lirec_tpu import config as config_lib
from lirec_tpu.models.factory import create_model as jax_create_model
from lirec_tpu.train.optim import make_optimizer as jax_make_optimizer
from lirec_tpu_torch import config as port_config
from lirec_tpu_torch.checkpoint import (
    load_jax_checkpoint, opt_state_to_jax, params_from_jax, params_to_jax,
)
from lirec_tpu_torch.checkpoint.msgpack import (
    MsgpackError, msgpack_restore, msgpack_serialize, packb, to_bytes,
)
from lirec_tpu_torch.checkpoint.saver import (
    BestNSaver, save_params, save_train_state_any,
)
from lirec_tpu_torch.cli import train as train_cli
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.train.loop import make_train_step, step_generators
from lirec_tpu_torch.train.optim import make_optimizer
from lirec_tpu_torch.utils.fake_batch import make_batch, make_tables
from tests.jax_cache_guard import isolated_xla_cache  # noqa: F401

DIM_ARGS = ["--text-dim", "16", "--visual-dim", "32", "--text-layers", "4",
            "--joint-dim", "16", "--compute-dtype", "float32"]
INTS = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1,
        2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
        -2**31 - 1, -2**63]
N_CLIPS, N_TRACKS = 24, 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the encoder


@pytest.mark.parametrize("value", (
    INTS + [None, True, False, 0.0, -0.0, 1.5, 1e300, float("inf")]
    + ["", "x" * 31, "x" * 32, "é" * 200, "y" * 65536]
    + [b"", b"a" * 255, b"a" * 256, b"a" * 65536]
    + [[1] * 15, [1] * 16, [1] * 65536, {"k%d" % i: i for i in range(15)},
       {"k%d" % i: i for i in range(16)}, {b"bytes": [None, {"a": 1.5}]}]))
def test_packb_is_msgpack_strict(value):
    """Every family at each side of its header boundaries: the bytes of
    msgpack.packb(value, strict_types=True)."""
    assert packb(value) == msgpack.packb(value, strict_types=True)


def test_packb_refuses_what_msgpack_strict_refuses():
    """A tuple (strict types pack lists only), an int past 64 bits, and
    an unknown object raise as they do in msgpack."""
    for value, err in (((1, 2), TypeError), (2**64, OverflowError),
                       (-2**63 - 1, OverflowError), (object(), TypeError)):
        with pytest.raises(err):
            msgpack.packb(value, strict_types=True)
        with pytest.raises(err):
            packb(value)


def _plain_trees():
    leaves = st.one_of(
        st.none(), st.booleans(),
        st.integers(min_value=-2**63, max_value=2**64 - 1),
        st.floats(allow_nan=False), st.text(max_size=40),
        st.binary(max_size=300))
    return st.recursive(
        leaves,
        lambda kids: st.one_of(
            st.lists(kids, max_size=20),
            st.dictionaries(st.one_of(st.text(max_size=8),
                                      st.binary(max_size=8)),
                            kids, max_size=20)),
        max_leaves=60)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(tree=_plain_trees())
def test_drawn_trees_pack_as_msgpack_does(tree):
    assert packb(tree) == msgpack.packb(tree, strict_types=True)


_DTYPES = ["float32", "float64", "int32", "int64", "uint8", "uint32",
           "bool", "float16", "complex64"]


def _arrays():
    return st.tuples(st.sampled_from(_DTYPES),
                     st.lists(st.integers(0, 4), max_size=3),
                     st.integers(0, 2**16)).map(
        lambda t: (np.random.default_rng(t[2]).standard_normal(t[1]) * 50
                   ).astype(t[0]))


def _flax_trees(lists=True):
    leaves = st.one_of(
        st.none(), st.booleans(),
        st.integers(min_value=-2**63, max_value=2**64 - 1),
        st.floats(allow_nan=False), st.text(max_size=20), _arrays(),
        _arrays().map(lambda a: a.reshape(-1)[0] if a.size else a),
        st.builds(complex, st.floats(allow_nan=False),
                  st.floats(allow_nan=False)),
        st.floats(allow_nan=False).map(np.float64))
    dicts = st.dictionaries(st.text(max_size=8), st.deferred(
        lambda: tree), max_size=8)
    tree = st.one_of(leaves, dicts, st.lists(st.deferred(lambda: tree),
                                             max_size=8)) if lists else \
        st.one_of(leaves, dicts)
    return st.dictionaries(st.text(max_size=8), tree, max_size=8)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(tree=_flax_trees())
def test_drawn_trees_serialize_as_flax_does(tree):
    """Nests of dicts (msgpack_serialize sorts their keys) and lists of
    Python scalars, numpy arrays of nine dtypes, numpy scalars (np.float64
    too, a float subclass) and complex numbers: flax's bytes, and the
    decoder reads them back."""
    data = msgpack_serialize(tree)
    assert data == serialization.msgpack_serialize(tree)
    msgpack_restore(data)


@settings(max_examples=100, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(tree=_flax_trees(lists=False))
def test_drawn_state_dicts_write_as_flax_to_bytes(tree):
    """State dicts (nested dicts, no lists: flax turns a list into a dict
    of its indices first), keys in their own order: to_bytes is the bytes
    of flax.serialization.to_bytes, as the JAX package's saver writes
    them."""
    assert to_bytes(tree) == serialization.to_bytes(tree)


def test_serialize_refuses_a_leaf_flax_would_chunk(monkeypatch):
    from lirec_tpu_torch.checkpoint import msgpack as port_msgpack

    monkeypatch.setattr(port_msgpack, "_MAX_LEAF_BYTES", 64)
    for encode in (msgpack_serialize, to_bytes):
        with pytest.raises(MsgpackError, match="chunks leaves over"):
            encode({"w": np.zeros(17, np.float32)})
    assert msgpack_serialize({"w": np.zeros(16, np.float32)}) == \
        serialization.msgpack_serialize({"w": np.zeros(16, np.float32)})


# ------------------------------------------------- the JAX package's trees


def _cfg(lib, preset="int_rel_ch", weight_decay=None):
    cfg = lib.preset(preset).with_dims(text_dim=16, visual_dim=32,
                                       joint_dim=16)
    cfg = cfg.with_runtime(compute_dtype="float32")
    if weight_decay is not None:
        cfg = cfg.with_optim(weight_decay=weight_decay)
    return cfg


def _trained_port(weight_decay=None, steps=2, preset="int_rel_ch"):
    """A port model and its Adam after `steps` steps on seeded batches,
    started from the JAX package's initial weights; with the JAX bundle
    and its optax chain."""
    jcfg, pcfg = _cfg(config_lib, preset, weight_decay), _cfg(
        port_config, preset, weight_decay)
    jb = jax_create_model(jcfg, 9, n_rels=6)
    pb = create_model(pcfg, 9, n_rels=6, device="cpu")
    pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                          jb.params)))
    opt = make_optimizer(pb.model.parameters(), 1e-3,
                         pcfg.optim.weight_decay)
    step = make_train_step(pb, opt)
    tables = {k: torch.from_numpy(v) for k, v in make_tables(
        pb.spec, N_CLIPS, N_TRACKS, seed=0).items()}
    for i in range(steps):
        step(make_batch(pb.spec, 4, N_CLIPS, N_TRACKS, seed=i), tables,
             step_generators(0, i, "cpu"))
    tx = jax_make_optimizer(jcfg.optim.lr, jcfg.optim.weight_decay)
    return pb, opt, jb, tx


@pytest.mark.parametrize("weight_decay", [None, 0.0])
def test_trees_have_the_jax_structure(weight_decay):
    """params_to_jax / opt_state_to_jax give the JAX package's param
    names and kernel shapes, and its optax chain's state-dict layout
    (with and without the add_decayed_weights link), leaf dtypes
    included; params_to_jax inverts params_from_jax bit for bit."""
    pb, opt, jb, tx = _trained_port(weight_decay)
    params = params_to_jax(pb.model.state_dict())
    want = jax.tree.map(np.asarray, jb.params)
    assert jax.tree.structure(params) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
    back = params_from_jax(params)
    for k, v in pb.model.state_dict().items():
        assert torch.equal(back[k], v), k
    opt_state = opt_state_to_jax(pb.model, opt)
    live = serialization.to_state_dict(tx.init(jb.params))
    assert jax.tree.structure(opt_state) == jax.tree.structure(
        jax.tree.map(np.asarray, live))
    adam = opt_state["1" if "2" in opt_state else "0"]
    assert adam["count"].dtype == np.int32 and int(adam["count"]) == 2
    for name, p in pb.model.named_parameters():
        state = opt.state[p]
        base, kind = name.rsplit(".", 1)
        base = "gates_ints" if base == "gates_ints.fc_out" else base
        leaf = "kernel" if kind == "weight" else "bias"
        for key, tree in (("exp_avg", adam["mu"]), ("exp_avg_sq",
                                                   adam["nu"])):
            want_m = state[key].numpy()
            np.testing.assert_array_equal(
                tree[base][leaf], want_m.T if kind == "weight" else want_m)


def test_a_fresh_optimizer_writes_zero_moments():
    pb = create_model(_cfg(port_config), 9, n_rels=6, device="cpu")
    opt = make_optimizer(pb.model.parameters(), 1e-3, 1e-5)
    state = opt_state_to_jax(pb.model, opt)
    assert int(state["1"]["count"]) == 0
    assert all(not np.any(x) for x in jax.tree.leaves(state["1"]["mu"]))


def test_jax_load_train_state_reads_the_port_file(tmp_path):
    """A port train state written as msgpack: the JAX package's
    load_train_state restores it against its own templates, with values
    equal to the port's, and flax's to_bytes of what it restored (its
    param tree, the live optax namedtuples), which is what the JAX
    package's save_train_state would write, is the file byte for byte."""
    pb, opt, jb, tx = _trained_port()
    path = str(tmp_path / "latest.ckpt")
    save_train_state_any(path, pb.model, opt, 7, backend="msgpack")
    params, opt_state, epoch = jax_checkpoint.load_train_state(
        path, jb.params, tx.init(jb.params))
    assert epoch == 7
    want = params_to_jax(pb.model.state_dict())
    for name, leaf in want.items():
        for k, v in leaf.items():
            np.testing.assert_array_equal(np.asarray(params[name][k]), v)
    adam = opt_state[1]
    assert int(adam.count) == 2
    port_adam = opt_state_to_jax(pb.model, opt)["1"]
    for field in ("mu", "nu"):
        for name, leaf in port_adam[field].items():
            for k, v in leaf.items():
                np.testing.assert_array_equal(
                    np.asarray(getattr(adam, field)[name][k]), v)
    with open(path, "rb") as f:
        data = f.read()
    assert data == serialization.to_bytes(
        {"params": params, "opt_state": opt_state, "epoch": epoch})
    tree = {"params": want, "opt_state": opt_state_to_jax(pb.model, opt),
            "epoch": 7}
    assert msgpack_serialize(tree) == serialization.msgpack_serialize(tree)


def test_round_trip_through_the_ckpt(tmp_path):
    """port -> save_train_state_any(msgpack) -> load_jax_checkpoint: the
    weights, the Adam state and the epoch bit for bit; an optimizer that
    loads them takes the same next step as the original."""
    pb, opt, _, _ = _trained_port()
    path = str(tmp_path / "s.ckpt")
    save_train_state_any(path, pb.model, opt, 3, backend="msgpack")
    other = create_model(_cfg(port_config), 9, n_rels=6, seed=5,
                         device="cpu")
    other_opt = make_optimizer(other.model.parameters(), 1e-3, 1e-5)
    state, adam, epoch = load_jax_checkpoint(path, other.model, other_opt)
    assert epoch == 3
    for k, v in pb.model.state_dict().items():
        assert torch.equal(state[k], v), k
    other.model.load_state_dict(state)
    other_opt.load_state_dict(adam)
    for p, q in zip(pb.model.parameters(), other.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], other_opt.state[q][key])
        assert float(opt.state[p]["step"]) == float(other_opt.state[q]["step"])
    tables = {k: torch.from_numpy(v) for k, v in make_tables(
        pb.spec, N_CLIPS, N_TRACKS, seed=0).items()}
    batch = make_batch(pb.spec, 4, N_CLIPS, N_TRACKS, seed=9)
    for bundle, o in ((pb, opt), (other, other_opt)):
        make_train_step(bundle, o)(batch, tables,
                                   step_generators(0, 9, "cpu"))
    for p, q in zip(pb.model.parameters(), other.model.parameters()):
        assert torch.equal(p, q)


def test_best_n_files_are_jax_params_files(tmp_path):
    """BestNSaver(backend='msgpack') writes v%.4f_ep%d.ckpt save_params
    files: the JAX package's load_params reads each with the kept epoch's
    weights, as does load_jax_checkpoint; save_params alone too."""
    pb, opt, jb, _ = _trained_port()
    saver = BestNSaver(path=str(tmp_path), n=2, backend="msgpack")
    kept = {}
    for epoch, val in ((0, 0.5), (1, 0.25), (2, 0.75)):
        with torch.no_grad():
            for p in pb.model.parameters():
                p.add_(0.01)
        state = {"state_dict": pb.model.state_dict(),
                 "optimizer": opt.state_dict(), "epoch": epoch}
        kept[epoch] = {k: v.clone() for k, v in pb.model.state_dict().items()}
        saver.update({"total": val}, state, epoch)
    saver.save()
    names = sorted(os.listdir(tmp_path / "total"))
    assert names == ["v0.5000_ep0.ckpt", "v0.7500_ep2.ckpt"]
    for name, epoch in zip(names, (0, 2)):
        path = str(tmp_path / "total" / name)
        params = jax_checkpoint.load_params(path, template=jb.params)
        want = params_to_jax(kept[epoch])
        for layer, leaf in want.items():
            for k, v in leaf.items():
                np.testing.assert_array_equal(np.asarray(params[layer][k]),
                                              v)
        with open(path, "rb") as f:
            assert msgpack_restore(f.read())["extra"] == {"epoch": epoch}
        state, adam, got_epoch = load_jax_checkpoint(path, pb.model, opt)
        assert adam is None and got_epoch == epoch
        for k, v in kept[epoch].items():
            assert torch.equal(state[k], v), k
    assert json.load(open(tmp_path / "index.json")) == {
        "total": {"0": 0.5, "2": 0.75}}
    plain = str(tmp_path / "plain.ckpt")
    save_params(plain, pb.model.state_dict())
    assert set(jax_checkpoint.load_params(plain)) == set(jb.params)


def test_training_cli_writes_msgpack_and_auto_resumes_from_it(synth_root,
                                                              tmp_path):
    """--checkpoint-backend msgpack: latest.ckpt, the final <epochs-1>.ckpt
    and the best-n .ckpt files, no .pth.tar; --auto-resume then takes the
    port's own latest.ckpt (weights, Adam state, epoch), which the JAX
    package's load_train_state reads too."""
    store = tmp_path / "store"
    base = ["--data-root", synth_root, "--store-root", str(store),
            "--batch-size", "8", "--device", "cpu", "--quiet",
            "--sanity-check", "--lr", "1e-3", "--checkpoint-backend",
            "msgpack", "--checkpoint-every", "1"] + DIM_ARGS
    first = train_cli.main(base + ["--epochs", "1"])
    assert first["train"]["final_path"] == str(store / "0.ckpt")
    files = sorted(os.listdir(store))
    assert "latest.ckpt" in files and "0.ckpt" in files
    assert not [f for f in files if f.endswith(".pth.tar")]
    assert [f for f in os.listdir(store / "total") if f.endswith(".ckpt")]
    with open(store / "latest.ckpt", "rb") as f:
        latest = msgpack_restore(f.read())
    assert latest["epoch"] == 0 and int(latest["opt_state"]["1"]["count"]) > 0
    resumed = train_cli.main(base + ["--epochs", "2", "--auto-resume"])
    assert resumed["train"]["start_epoch"] == 1
    assert len(resumed["train"]["losses"]) == 1
    assert np.isfinite(resumed["train"]["losses"][0])
    with open(store / "latest.ckpt", "rb") as f:
        assert msgpack_restore(f.read())["epoch"] == 1


def test_orbax_backend_stays_refused_by_name(synth_root, tmp_path):
    """--checkpoint-backend orbax: the port's training CLI writes
    latest.ckpt and the final 0.ckpt as Orbax directories and the best-n
    files as msgpack save_params files (as the JAX package does); the JAX
    package's eval CLI reads the final directory and gives the metrics the
    port's eval CLI gives on it (rtol 2e-6), and the JAX
    load_train_state_any reads its epoch and Adam step. (The name is from
    when the backend was refused.)"""
    from lirec_tpu.checkpoint import load_train_state_any
    from lirec_tpu.cli import common as jax_common
    from lirec_tpu_torch.cli import common as port_common

    store = tmp_path / "store"
    dims = ["--data-root", synth_root, "--batch-size", "8", "--quiet",
            "--sanity-check"] + DIM_ARGS
    first = train_cli.main(["modalities", "--store-root", str(store),
                            "--device", "cpu", "--lr", "1e-3", "--epochs",
                            "1", "--checkpoint-backend", "orbax",
                            "--checkpoint-every", "1"] + dims)
    final = store / "0.ckpt"
    assert first["train"]["final_path"] == str(final)
    assert final.is_dir() and (store / "latest.ckpt").is_dir()
    best = [store / "total" / f for f in os.listdir(store / "total")]
    assert best and all(f.suffix == ".ckpt" and f.is_file() for f in best)
    with open(best[0], "rb") as f:
        assert set(msgpack_restore(f.read())) == {"params", "extra"}
    args = dims + ["--resume-path", str(final)]
    want = jax_common.run_entry("modalities", args)
    got = port_common.run_entry("modalities", args + ["--device", "cpu"])
    for split in ("val", "test"):
        assert set(got[split]) == set(want[split])
        for key, v in want[split].items():
            np.testing.assert_allclose(got[split][key], v, rtol=2e-6,
                                       atol=1e-7, err_msg=key)
    cfg = jax_common.config_from_args("modalities", jax_common.build_parser(
        "modalities").parse_args(args))
    train_ds, _, _ = jax_common.build_datasets(cfg, "modalities")
    jb = jax_create_model(cfg, train_ds.n_classes)
    tx = jax_make_optimizer(cfg.optim.lr, cfg.optim.weight_decay)
    _, opt_state, epoch = load_train_state_any(str(final), jb.params,
                                               tx.init(jb.params))
    assert epoch == 0
    assert [int(s.count) for s in opt_state if hasattr(s, "mu")][0] > 0
