"""The port reads the JAX package's msgpack checkpoints without flax or
msgpack: the decoder (checkpoint/msgpack.py) against ``msgpack.unpackb``
and ``flax.serialization.msgpack_restore``, ``load_jax_checkpoint``
against ``params_from_jax`` / ``opt_state_from_jax`` of the live JAX
state, and the CLIs on the JAX package's ``.ckpt`` files: evaluation
gives the JAX package's metrics, ``--auto-resume`` resumes from its
``latest.ckpt``. The packages are used here only to write fixtures and
to decode them the reference way."""

import copy
import math
import os

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from lirec_tpu.checkpoint import save_params, save_train_state
from lirec_tpu.cli import common as jax_common
from lirec_tpu.models.factory import create_model as jax_create_model
from lirec_tpu.train.loop import train as jax_train
from lirec_tpu_torch.checkpoint import (
    load_jax_checkpoint, opt_state_from_jax, params_from_jax,
)
from lirec_tpu_torch.checkpoint.msgpack import (
    MsgpackError, msgpack_restore, unpackb,
)
from lirec_tpu_torch.cli import common
from lirec_tpu_torch.cli import train as train_cli
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.train.optim import make_optimizer
from tests.jax_cache_guard import isolated_xla_cache  # noqa: F401

DIM_ARGS = ["--text-dim", "16", "--visual-dim", "32", "--text-layers", "4",
            "--joint-dim", "16", "--compute-dtype", "float32"]
# lengths on each side of the 4-bit / 5-bit, 8-bit and 16-bit boundaries
# of the str, bin, array, map and ext families
STR_SIZES = [0, 31, 32, 255, 256, 65535, 65536]
BIN_SIZES = [0, 1, 255, 256, 65535, 65536]
SEQ_SIZES = [0, 15, 16, 65535, 65536]
EXT_SIZES = [1, 2, 3, 4, 8, 16, 17, 255, 256, 65535, 65536]
INTS = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1,
        2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
        -2**31 - 1, -2**63]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ext(code, data):
    return ("ext", code, data)


def _both(packed):
    """The decoder's and msgpack's decoding of the same bytes."""
    return (unpackb(packed, ext_hook=_ext),
            msgpack.unpackb(packed, ext_hook=_ext, raw=False))


# ------------------------------------------------------------ the decoder


@pytest.mark.parametrize("family,n", (
    [("str", n) for n in STR_SIZES] + [("bin", n) for n in BIN_SIZES]
    + [("array", n) for n in SEQ_SIZES] + [("map", n) for n in SEQ_SIZES]
    + [("ext", n) for n in EXT_SIZES]))
def test_every_length_family_at_its_boundaries(family, n):
    """fixstr/str8/16/32, bin8/16/32, fixarray/array16/32, fixmap/map16/32
    and fixext1-16/ext8/16/32, each on both sides of its length
    boundaries, decode as msgpack decodes them."""
    value = {
        "str": lambda: "éx" * (n // 3) + "y" * (n - 3 * (n // 3)),
        "bin": lambda: bytes(range(256)) * (n // 256) + b"\x07" * (n % 256),
        "array": lambda: [i % 300 - 40 for i in range(n)],
        "map": lambda: {"k%d" % i: i for i in range(n)},
        "ext": lambda: msgpack.ExtType(5, b"\x01" * n),
    }[family]()
    got, want = _both(msgpack.packb(value, use_bin_type=True))
    assert got == want
    if family == "ext":
        assert got == ("ext", 5, b"\x01" * n)


@pytest.mark.parametrize("value", INTS)
def test_integers_at_every_width(value):
    """positive and negative fixints, uint8-64 and int8-64."""
    got, want = _both(msgpack.packb(value))
    assert got == want == value and type(got) is int


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("value", [0.0, -0.0, 1.5, -2.75e-30, 3.4e38,
                                   1e300, math.inf, -math.inf, math.nan])
def test_floats_32_and_64(value, single):
    got, want = _both(msgpack.packb(value, use_single_float=single))
    assert type(got) is float
    assert (math.isnan(got) and math.isnan(want)) or got == want
    assert math.copysign(1, got) == math.copysign(1, want)


def _trees():
    sizes = st.sampled_from([0, 1, 15, 16, 31, 32, 255, 256])
    leaves = st.one_of(
        st.none(), st.booleans(),
        st.integers(min_value=-2**63, max_value=2**64 - 1),
        st.floats(allow_nan=False), st.text(max_size=40),
        st.binary(max_size=40),
        st.tuples(sizes, st.characters()).map(lambda t: t[1] * t[0]),
        st.tuples(sizes, st.integers(0, 255)).map(
            lambda t: bytes([t[1]]) * t[0]),
        st.tuples(st.integers(0, 127), st.sampled_from(EXT_SIZES[:9]))
        .map(lambda t: msgpack.ExtType(t[0], bytes(t[1]))),
    )
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
@given(tree=_trees(), single=st.booleans())
def test_drawn_trees_decode_as_msgpack_does(tree, single):
    """nil, bool, ints, float32/64, str, bin, ext, and nests of arrays and
    maps with str and bytes keys."""
    packed = msgpack.packb(tree, use_bin_type=True, use_single_float=single)
    got, want = _both(packed)
    assert got == want


@settings(max_examples=60, deadline=None)
@given(dtype=st.sampled_from(["float32", "float64", "int32", "int64",
                              "uint8", "uint32", "bool", "float16",
                              "complex64"]),
       shape=st.lists(st.integers(0, 4), max_size=3),
       seed=st.integers(0, 2**16))
def test_flax_arrays_scalars_and_complex_decode_as_flax_does(dtype, shape,
                                                             seed):
    """flax's ext types 1-3 (ndarray, native complex, numpy scalar) in a
    state dict, as flax.serialization.msgpack_serialize writes them."""
    rng = np.random.default_rng(seed)
    arr = (rng.standard_normal(shape) * 50).astype(dtype)
    tree = {"a": {"kernel": arr, "n": np.int32(seed)},
            "c": complex(seed, -1.5), "s": np.float32(0.25) * seed,
            "epoch": seed, "name": "x"}
    data = serialization.msgpack_serialize(tree)
    got, want = msgpack_restore(data), serialization.msgpack_restore(data)
    assert set(got) == set(want)
    for k in ("c", "epoch", "name"):
        assert got[k] == want[k] and type(got[k]) is type(want[k])
    assert type(got["s"]) is type(want["s"]) and got["s"] == want["s"]
    assert type(got["a"]["n"]) is type(want["a"]["n"])
    for g, w in ((got["a"]["kernel"], want["a"]["kernel"]),
                 (got["a"]["n"], want["a"]["n"])):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


def test_chunked_arrays_unknown_ext_and_bfloat16_are_refused():
    """flax's chunked arrays (leaves over 2**30 bytes), an ext code flax
    does not write and a dtype numpy lacks raise by name; so do cut or
    padded data and a byte that starts no object."""
    chunked = {"w": {"__msgpack_chunked_array__": True,
                     "shape": {"0": 2}, "chunks": {"0": np.zeros(2)}}}
    with pytest.raises(MsgpackError, match="chunked"):
        msgpack_restore(serialization.msgpack_serialize(chunked))
    with pytest.raises(MsgpackError, match="unknown msgpack ext code 9"):
        msgpack_restore(msgpack.packb({"x": msgpack.ExtType(9, b"ab")}))
    bf16 = serialization.msgpack_serialize(
        {"w": jax.numpy.ones((2,), jax.numpy.bfloat16)})
    assert serialization.msgpack_restore(bf16)["w"].dtype.name == "bfloat16"
    with pytest.raises(MsgpackError, match="'bfloat16'"):
        msgpack_restore(bf16)
    good = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(MsgpackError, match="truncated"):
        unpackb(good[:-1])
    with pytest.raises(MsgpackError, match="after the msgpack object"):
        unpackb(good + b"\x00")
    with pytest.raises(MsgpackError, match="0xc1"):
        unpackb(b"\xc1")
    with pytest.raises(MsgpackError, match="ext_hook"):
        unpackb(msgpack.packb(msgpack.ExtType(1, b"a")))


# ------------------------------------------------ the JAX package's files


@pytest.fixture(scope="module")
def jax_run(synth_root, tmp_path_factory):
    """One epoch of the JAX package's train() on the modalities preset
    (the CLI's config and datasets), writing its best-n save_params files,
    latest.ckpt and 0.ckpt; returns (cfg, live params, live opt_state,
    store root)."""
    store = str(tmp_path_factory.mktemp("jax_store"))
    args = jax_common.build_parser("modalities").parse_args(
        ["--data-root", synth_root, "--store-root", store, "--train",
         "--epochs", "1", "--batch-size", "8", "--lr", "1e-3"] + DIM_ARGS)
    cfg = jax_common.config_from_args("modalities", args)
    train_ds, val_ds, test_ds = jax_common.build_datasets(cfg, "modalities")
    bundle = jax_create_model(cfg, train_ds.n_classes)
    out = jax_train(cfg, bundle, train_ds, val_dataset=val_ds,
                    test_dataset=test_ds, verbose=False, checkpoint_every=1)
    return cfg, out["params"], out["opt_state"], store


def _port_pair(cfg, n_classes):
    bundle = create_model(cfg, n_classes, device="cpu")
    optimizer = make_optimizer(bundle.model.parameters(), cfg.optim.lr,
                               cfg.optim.weight_decay)
    return bundle, optimizer


def test_jax_files_decode_as_flax_decodes_them(jax_run):
    """The save_train_state files (latest.ckpt, 0.ckpt: params, the optax
    Adam chain, the epoch) and the save_params best-n files decode to
    flax's trees, leaf for leaf and dtype for dtype."""
    _, _, _, store = jax_run
    files = [os.path.join(store, "latest.ckpt"),
             os.path.join(store, "0.ckpt")]
    for d in sorted(os.listdir(store)):
        if os.path.isdir(os.path.join(store, d)):
            files += [os.path.join(store, d, f)
                      for f in os.listdir(os.path.join(store, d))]
    assert len(files) > 2

    def same(got, want, where):
        assert type(got) is type(want) or (
            isinstance(got, np.ndarray) and isinstance(want, np.ndarray)), \
            where
        if isinstance(want, dict):
            assert set(got) == set(want), where
            for k in want:
                same(got[k], want[k], where + "/" + k)
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, where
            np.testing.assert_array_equal(got, want, err_msg=where)
        else:
            assert got == want, where

    for path in files:
        with open(path, "rb") as f:
            data = f.read()
        same(msgpack_restore(data), serialization.msgpack_restore(data),
             os.path.basename(path))


def test_load_jax_checkpoint_is_the_live_state_converted(jax_run):
    """latest.ckpt -> the state_dict and the Adam state that
    params_from_jax / opt_state_from_jax give of the live JAX state, bit
    for bit, and its epoch; a save_params file gives the weights, no Adam
    state, and the epoch in its 'extra'."""
    cfg, params, opt_state, store = jax_run
    live_params = jax.tree.map(np.asarray, params)
    n_classes = live_params["out_ints"]["bias"].shape[0]
    bundle, optimizer = _port_pair(cfg, n_classes)
    state, adam, epoch = load_jax_checkpoint(
        os.path.join(store, "latest.ckpt"), bundle.model, optimizer)
    assert epoch == 0
    want = params_from_jax(live_params)
    assert set(state) == set(want)
    for k in want:
        assert torch.equal(state[k], want[k]), k
    want_adam = opt_state_from_jax(jax.tree.map(np.asarray, opt_state),
                                   bundle.model, optimizer)
    assert adam["param_groups"] == want_adam["param_groups"]
    assert set(adam["state"]) == set(want_adam["state"])
    for i, w in want_adam["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(adam["state"][i][k], w[k]), (i, k)
    assert float(want_adam["state"][0]["step"]) > 0
    assert any(bool(w["exp_avg"].abs().sum()) for w in
               want_adam["state"].values())
    optimizer.load_state_dict(adam)
    bundle.model.load_state_dict(state)

    best = os.path.join(store, "total",
                        os.listdir(os.path.join(store, "total"))[0])
    p_state, p_adam, p_epoch = load_jax_checkpoint(best, bundle.model,
                                                   optimizer)
    assert p_adam is None and p_epoch == 0
    for k in want:
        assert torch.equal(p_state[k], want[k]), k
    path = os.path.join(store, "plain.ckpt")
    save_params(path, params)
    assert load_jax_checkpoint(path)[1:] == (None, 0)


def test_eval_cli_on_a_jax_ckpt_gives_the_jax_metrics(jax_run, synth_root):
    """The port's eval CLI (packed sweep and --host-eval) on a best-n
    .ckpt that the JAX package's save_params wrote, and on its train state
    latest.ckpt: the JAX eval CLI's metrics on the same file."""
    _, _, _, store = jax_run
    best = os.path.join(store, "total",
                        os.listdir(os.path.join(store, "total"))[0])
    for path in (best, os.path.join(store, "latest.ckpt")):
        base = ["--data-root", synth_root, "--store-root", store,
                "--resume-path", path, "--batch-size", "8", "--quiet"] + \
            DIM_ARGS
        want = jax_common.run_entry("modalities", base)
        for extra in ([], ["--host-eval"]):
            got = common.run_entry("modalities",
                                   base + ["--device", "cpu"] + extra)
            for split in ("val", "test"):
                assert set(got[split]) == set(want[split])
                for key, v in want[split].items():
                    np.testing.assert_allclose(got[split][key], v,
                                               rtol=2e-6, atol=1e-7,
                                               err_msg=key)


def test_auto_resume_from_a_jax_latest_ckpt(jax_run, synth_root, tmp_path,
                                            monkeypatch):
    """A store root holding only the JAX package's latest.ckpt (epoch 0):
    --auto-resume starts at epoch 1 with the JAX weights and Adam state
    (opt_state_from_jax of the live state), and trains on."""
    import shutil

    from lirec_tpu_torch.train import loop

    cfg, params, opt_state, src = jax_run
    store = tmp_path / "store"
    store.mkdir()
    shutil.copy(os.path.join(src, "latest.ckpt"), store / "latest.ckpt")
    seen = {}
    orig = loop.train

    def spy(cfg, bundle, *args, optimizer=None, **kw):
        seen["state"] = {k: v.clone()
                         for k, v in bundle.model.state_dict().items()}
        seen["adam"] = copy.deepcopy(optimizer.state_dict())
        seen["model"], seen["optimizer"] = bundle.model, optimizer
        return orig(cfg, bundle, *args, optimizer=optimizer, **kw)

    monkeypatch.setattr(loop, "train", spy)
    out = train_cli.main(["modalities", "--data-root", synth_root,
                          "--store-root", str(store), "--batch-size", "8",
                          "--device", "cpu", "--quiet", "--lr", "1e-3",
                          "--epochs", "2", "--auto-resume"] + DIM_ARGS)
    assert out["train"]["start_epoch"] == 1
    assert len(out["train"]["losses"]) == 1
    assert np.isfinite(out["train"]["losses"][0])
    want = params_from_jax(jax.tree.map(np.asarray, params))
    for k, v in want.items():
        assert torch.equal(seen["state"][k], v), k
    want_adam = opt_state_from_jax(jax.tree.map(np.asarray, opt_state),
                                   seen["model"], seen["optimizer"])
    for i, w in want_adam["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(seen["adam"]["state"][i][k], w[k]), (i, k)
