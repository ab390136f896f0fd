"""The port's Orbax checkpoints (checkpoint/orbax_backend.py, on
checkpoint/ocdbt.py and native/zstd.cpp) against tensorstore and the JAX
package's orbax backend, which are used here only as oracles:

* zstd: every frame tensorstore writes as zarr chunks, for data chosen to
  reach each block, literals and sequences mode decodes bitwise, and the
  decoder's counts show each mode met; XXH64 and CRC-32C on known
  vectors; content checksums, skippable and concatenated frames; truncated
  and corrupted frames raise and return nothing;
* OCDBT: the reader's keys and values are tensorstore's, on the JAX
  backend's directories, on stores with interior nodes and on the port's
  own stores, which tensorstore opens and reads back;
* checkpoints: the JAX ``orbax_backend.save`` of int_rel_ch and
  modalities trees with optax Adam state (zero and non-zero moments, bf16
  and f32 leaves, the epoch) loads into the port as the msgpack file of
  the same tree does; multi-chunk arrays and chunks never written;
  the port's ``save_train_state_any(..., "orbax")`` restored by the JAX
  ``orbax_backend.restore``, full and params-only, bitwise, and its
  ``_METADATA`` tree the JAX writer's.
"""

import glob
import json
import os
import struct

import numpy as np
import pytest
import torch

ts = pytest.importorskip("tensorstore")
pytest.importorskip("orbax.checkpoint")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from lirec_tpu import config as config_lib  # noqa: E402
from lirec_tpu.checkpoint import orbax_backend as jax_orbax  # noqa: E402
from lirec_tpu.checkpoint import save_train_state  # noqa: E402
from lirec_tpu.models.factory import create_model as jax_create_model  # noqa: E402,E501
from lirec_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402,E501
from lirec_tpu_torch import config as port_config  # noqa: E402
from lirec_tpu_torch.checkpoint import (  # noqa: E402
    load_jax_checkpoint, opt_state_to_jax, params_from_jax, params_to_jax,
)
from lirec_tpu_torch.checkpoint import ocdbt, orbax_backend  # noqa: E402
from lirec_tpu_torch.checkpoint.saver import save_train_state_any  # noqa: E402,E501
from lirec_tpu_torch.models.factory import create_model  # noqa: E402
from lirec_tpu_torch.native import bindings  # noqa: E402
from lirec_tpu_torch.train.loop import make_train_step, step_generators  # noqa: E402,E501
from lirec_tpu_torch.train.optim import make_optimizer  # noqa: E402
from lirec_tpu_torch.utils.fake_batch import make_batch, make_tables  # noqa: E402,E501

# every mode of the decoder a zstd encoder can reach
MODES = ("block_raw", "block_rle", "block_compressed", "literals_raw",
         "literals_rle", "literals_compressed", "literals_treeless",
         "literals_1_stream", "literals_4_streams", "huffman_weights_fse",
         "huffman_weights_direct", "sequences_predefined", "sequences_rle",
         "sequences_fse", "sequences_repeat", "repeat_offsets",
         "sequences_none")
LEVELS = (1, 3, 19)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ zstd

def _corpus():
    """(name, array, chunk shape) for data that reaches every mode."""
    rng = np.random.default_rng(0)
    # a block whose literals are one repeated byte: random pieces of R
    # (matches) between single 'Q's (literals), at level 19
    r = rng.integers(0, 256, 4096, dtype=np.uint8)
    parts = [np.tile(r, 32)]
    for _ in range(300):
        o = int(rng.integers(0, 4096 - 2000))
        parts += [r[o:o + 2000], np.array([81], np.uint8)]
    return [
        ("zeros", np.zeros((1000, 256), np.float32), None),
        ("normal_f32", rng.standard_normal((512, 256)).astype(np.float32),
         None),
        ("normal_bf16", rng.standard_normal((512, 256)).astype(
            ml_dtypes.bfloat16), None),
        ("arange", np.arange(65536, dtype=np.int32), None),
        ("repeating", np.tile(np.arange(37, dtype=np.int32), 5000), None),
        ("three_values", rng.integers(0, 3, 50000).astype(np.uint8), None),
        ("noise", rng.integers(0, 256, 200000).astype(np.uint8), None),
        ("tiny", rng.standard_normal(3).astype(np.float32), None),
        ("chunked", rng.standard_normal((64, 60)).astype(np.float32),
         [16, 20]),
        ("one_literal", np.concatenate(parts), None),
    ]


def _zarr_dtype(arr):
    return "bfloat16" if arr.dtype == ml_dtypes.bfloat16 else arr.dtype.str


@pytest.fixture(scope="module")
def ts_frames(tmp_path_factory):
    """[(label, frame, the chunk's bytes)] of every chunk tensorstore's
    zarr writer makes for the corpus at levels 1, 3 and 19."""
    root = tmp_path_factory.mktemp("zarr_frames")
    out = []
    for level in LEVELS:
        for name, arr, chunks in _corpus():
            chunks = chunks or list(arr.shape)
            path = str(root / ("%s_%d" % (name, level)))
            t = ts.open({"driver": "zarr", "kvstore": {"driver": "file",
                                                       "path": path},
                         "metadata": {"dtype": _zarr_dtype(arr),
                                      "shape": list(arr.shape),
                                      "chunks": chunks,
                                      "compressor": {"id": "zstd",
                                                     "level": level}}},
                        create=True, delete_existing=True).result()
            t.write(arr).result()
            for f in sorted(glob.glob(os.path.join(path, "[0-9]*"))):
                index = [int(x) for x in os.path.basename(f).split(".")]
                at = tuple(slice(i * c, (i + 1) * c)
                           for i, c in zip(index, chunks))
                with open(f, "rb") as fh:
                    frame = fh.read()
                out.append(("%s@%d/%s" % (name, level, os.path.basename(f)),
                            frame, np.ascontiguousarray(arr[at]).tobytes()))
    return out


def test_tensorstore_frames_decode_bitwise_through_every_mode(ts_frames):
    """Each chunk decodes to the array's bytes; over the corpus the
    decoder met every block, literals and sequences mode, and a frame
    over 128 KiB was met (several blocks)."""
    bindings.zstd_reset_counts()
    for label, frame, want in ts_frames:
        got = bindings.zstd_decompress(frame, len(want))
        assert got.tobytes() == want, label
    counts = bindings.zstd_counts()
    assert {m: counts[m] for m in MODES if counts[m] == 0} == {}
    assert counts["frames"] == len(ts_frames)
    assert max(len(w) for _, _, w in ts_frames) > 128 * 1024


def test_xxh64_and_crc32c_on_known_vectors():
    assert bindings.xxh64(b"") == 0xEF46DB3751D8E999
    assert bindings.xxh64(b"abc") == 0x44BC2CF5AD770999
    assert bindings.crc32c(b"123456789") == 0xE3069283
    assert bindings.crc32c(b"") == 0
    xxhash = pytest.importorskip("xxhash")
    data = np.random.default_rng(1).integers(0, 256, 300, np.uint8).tobytes()
    for n in range(0, 300, 7):
        for seed in (0, 1, 2**64 - 1):
            assert bindings.xxh64(data[:n], seed) == xxhash.xxh64(
                data[:n], seed=seed).intdigest(), (n, seed)


def test_the_committed_level1_frame():
    """native/normal_f32_level1.zst (chip_smoke phase 22(d) times the
    decoder on it): a level-1 frame of Huffman-compressed literals in four
    streams holding 40,960 f32 draws of default_rng(0).standard_normal."""
    path = os.path.join(os.path.dirname(bindings.__file__),
                        "normal_f32_level1.zst")
    with open(path, "rb") as f:
        frame = f.read()
    want = np.random.default_rng(0).standard_normal(40960).astype(
        np.float32)
    bindings.zstd_reset_counts()
    got = bindings.zstd_decompress(frame, want.nbytes)
    assert got.tobytes() == want.tobytes()
    counts = bindings.zstd_counts()
    assert counts["literals_4_streams"] > 0 and counts["block_raw"] == 0
    assert len(frame) < want.nbytes


def _with_checksum(data: bytes) -> bytes:
    """A raw-block frame of `data` with the content-checksum flag and the
    low 32 bits of its XXH64."""
    frame = bytearray(bindings.zstd_frame(data))
    frame[4] |= 0x04
    return bytes(frame) + struct.pack("<I", bindings.xxh64(data) & 0xFFFFFFFF)


def test_checksums_skippable_and_concatenated_frames():
    """A checked frame, a skippable frame and a second frame in one input
    decode to the two frames' data; the raw-block frames the writer makes
    state their size and are read by tensorstore's zstd too."""
    a = bytes(range(256)) * 700  # two raw blocks
    b = b"second frame"
    skip = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    src = _with_checksum(a) + skip + bindings.zstd_frame(b)
    assert bindings.zstd_content_size(src) == len(a) + len(b)
    bindings.zstd_reset_counts()
    assert bindings.zstd_decompress(src).tobytes() == a + b
    counts = bindings.zstd_counts()
    assert counts["checksums"] == 1 and counts["skippable_frames"] == 1
    assert counts["frames"] == 2 and counts["block_raw"] == 3
    assert bindings.zstd_decompress(bindings.zstd_frame(b"")).size == 0


def test_malformed_frames_raise_and_return_nothing(ts_frames):
    """Every truncation of a frame raises with its byte offset; a bit
    flipped in a checked frame raises (a structure or the checksum); a
    dictionary ID, a reserved block type and a buffer too small are
    refused by name."""
    frames = [f for label, f, _ in ts_frames
              if label.startswith(("normal_f32@1/", "repeating@19/",
                                   "zeros@3/"))]
    assert len(frames) == 3
    for frame in frames:
        for cut in range(0, len(frame), max(1, len(frame) // 97)):
            with pytest.raises(ValueError, match=r"zstd: .* \(at byte \d+\)"):
                bindings.zstd_decompress(frame[:cut], 1 << 20)
    data = np.random.default_rng(2).standard_normal(40000).astype(
        np.float32).tobytes()
    checked = _with_checksum(data)
    rng = np.random.default_rng(3)
    for _ in range(200):
        bad = bytearray(checked)
        bad[int(rng.integers(6, len(bad)))] ^= 1 << int(rng.integers(0, 8))
        if bytes(bad) == checked:
            continue
        with pytest.raises(ValueError, match="zstd: "):
            bindings.zstd_decompress(bytes(bad), len(data))
    zstandard = pytest.importorskip("zstandard")
    enc = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        data)
    for _ in range(200):
        bad = bytearray(enc)
        bad[int(rng.integers(6, len(bad)))] ^= 1 << int(rng.integers(0, 8))
        with pytest.raises(ValueError, match="zstd: "):
            bindings.zstd_decompress(bytes(bad), len(data))
    # a dictionary ID (one byte, 7), single segment, 1-byte size 0
    with pytest.raises(ValueError, match="dictionary 7"):
        bindings.zstd_decompress(
            struct.pack("<I", 0xFD2FB528) + bytes([0x21, 7, 0, 1, 0, 0]), 8)
    reserved = bytearray(bindings.zstd_frame(b"abc"))
    reserved[14] |= 0x06  # block type 3
    with pytest.raises(ValueError, match="reserved block type"):
        bindings.zstd_decompress(bytes(reserved), 3)
    with pytest.raises(ValueError, match="past the buffer"):
        bindings.zstd_decompress(bindings.zstd_frame(b"abcdef"), 5)


# ------------------------------------------------------------------ OCDBT

def _ts_items(path):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": "file://%s/" % os.path.abspath(path)}
                         ).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


def _jax_tree(preset="int_rel_ch", moments="nonzero", bf16=False,
              weight_decay=None):
    """A JAX params tree and optax Adam state of `preset` at small widths;
    `moments`: "zero" (tx.init) or "nonzero" (one update on seeded
    gradients); `bf16`: the output kernel and its moments in bfloat16."""
    cfg = _cfg(config_lib, preset, weight_decay)
    params = jax_create_model(cfg, 9, n_rels=6).params
    tx = jax_make_optimizer(cfg.optim.lr, cfg.optim.weight_decay)
    opt_state = tx.init(params)
    if moments == "nonzero":
        keys = jax.random.split(jax.random.PRNGKey(5),
                                len(jax.tree.leaves(params)))
        grads = jax.tree.unflatten(jax.tree.structure(params), [
            jax.random.normal(k, p.shape, p.dtype)
            for k, p in zip(keys, jax.tree.leaves(params))])
        _, opt_state = tx.update(grads, opt_state, params)
    if bf16:
        layer = "out_ints"

        def cast(tree):
            return {k: ({kk: vv.astype(jnp.bfloat16) if kk == "kernel" else vv
                         for kk, vv in v.items()} if k == layer else v)
                    for k, v in tree.items()}

        params = cast(params)
        opt_state = tuple(
            s._replace(mu=cast(s.mu), nu=cast(s.nu)) if hasattr(s, "mu")
            else s for s in opt_state)
    return cfg, params, opt_state


def _cfg(lib, preset="int_rel_ch", weight_decay=None):
    cfg = lib.preset(preset).with_dims(text_dim=16, visual_dim=32,
                                       joint_dim=16)
    cfg = cfg.with_runtime(compute_dtype="float32")
    if weight_decay is not None:
        cfg = cfg.with_optim(weight_decay=weight_decay)
    return cfg


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """An Orbax checkpoint the JAX backend wrote (int_rel_ch, non-zero
    Adam moments, a bf16 kernel, epoch 3)."""
    _, params, opt_state = _jax_tree(bf16=True)
    path = str(tmp_path_factory.mktemp("jax_orbax") / "ck")
    jax_orbax.save(path, params, opt_state=opt_state, epoch=3)
    return path


def test_reader_lists_and_reads_what_tensorstore_does(jax_dir):
    """The JAX backend's directory (a top-level tree over
    ocdbt.process_0/'s data files): the same keys and values."""
    assert os.path.isdir(os.path.join(jax_dir, "ocdbt.process_0"))
    want = _ts_items(jax_dir)
    reader = ocdbt.Reader(jax_dir)
    assert reader.keys() == sorted(want)
    assert dict(reader.items()) == want
    assert any(len(v) > ocdbt.MAX_INLINE_VALUE_BYTES for v in want.values())


@pytest.mark.parametrize("node_bytes", [300, 100_000_000])
def test_interior_nodes_both_ways(tmp_path, node_bytes):
    """A store tensorstore writes with small nodes (interior nodes, key
    prefixes, values in and out of line) reads as tensorstore reads it;
    the port's store of the same items, with nodes of `node_bytes`, opens
    in tensorstore with the same keys and values, and tensorstore can
    commit more writes on top of it, which the reader then sees."""
    rng = np.random.default_rng(4)
    items = {b"key/%03d/abc" % i: rng.integers(
        0, 256, int(rng.integers(0, 60)), np.uint8).tobytes()
        for i in range(80)}
    theirs = str(tmp_path / "theirs")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://%s/" % theirs,
                          "config": {"max_decoded_node_bytes": node_bytes,
                                     "max_inline_value_bytes": 16}}
                         ).result()
    txn = ts.Transaction()
    for k, v in items.items():
        kv.with_transaction(txn).write(k, v).result()
    txn.commit_async().result()
    assert dict(ocdbt.Reader(theirs).items()) == items
    ours = str(tmp_path / "ours")
    ocdbt.write_store(ours, items, max_inline_value_bytes=16,
                      max_decoded_node_bytes=node_bytes)
    assert _ts_items(ours) == items
    assert dict(ocdbt.Reader(ours).items()) == items
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": "file://%s/" % ours}).result()
    kv.write(b"key/zzz", b"x" * 100).result()
    items[b"key/zzz"] = b"x" * 100
    assert dict(ocdbt.Reader(ours).items()) == items


def test_reader_checks_every_checksum(tmp_path):
    ours = str(tmp_path / "s")
    ocdbt.write_store(ours, {b"a": b"1" * 2000, b"b": b"2"})
    data = glob.glob(os.path.join(ours, "d", "*"))[0]
    raw = bytearray(open(data, "rb").read())
    raw[-10] ^= 1  # inside the leaf node, after the out-of-line value
    open(data, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        ocdbt.Reader(ours)


# ------------------------------------------------------------ checkpoints

def _port_pair(preset, weight_decay=None):
    pcfg = _cfg(port_config, preset, weight_decay)
    bundle = create_model(pcfg, 9, n_rels=6, device="cpu")
    opt = make_optimizer(bundle.model.parameters(), 1e-3,
                         pcfg.optim.weight_decay)
    return bundle, opt


def _widened(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32)
                        if x.dtype == jnp.bfloat16 else x, tree)


@pytest.mark.parametrize("preset", ["int_rel_ch", "modalities"])
@pytest.mark.parametrize("moments,bf16", [("zero", False),
                                          ("nonzero", False),
                                          ("nonzero", True)])
def test_jax_orbax_loads_as_the_msgpack_file_of_the_tree(tmp_path, preset,
                                                         moments, bf16):
    """load_jax_checkpoint of the JAX orbax_backend.save directory: the
    state_dict, Adam state and epoch of the JAX save_train_state msgpack
    file of the same tree (bf16 leaves widened: exact), bit for bit; and
    a params-only load reads no optax key."""
    cfg, params, opt_state = _jax_tree(preset, moments, bf16)
    orbax_dir = str(tmp_path / "latest.ckpt")
    jax_orbax.save(orbax_dir, params, opt_state=opt_state, epoch=4)
    msgpack_file = str(tmp_path / "msgpack.ckpt")
    save_train_state(msgpack_file, _widened(params), _widened(opt_state), 4)
    bundle, opt = _port_pair(preset)
    got = load_jax_checkpoint(orbax_dir, bundle.model, opt)
    want = load_jax_checkpoint(msgpack_file, bundle.model, opt)
    assert got[2] == want[2] == 4
    assert set(got[0]) == set(want[0])
    for k, v in want[0].items():
        assert got[0][k].dtype == torch.float32
        assert torch.equal(got[0][k], v), k
    assert got[1]["param_groups"] == want[1]["param_groups"]
    for i, w in want[1]["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got[1]["state"][i][k], w[k]), (i, k)
    moved = any(bool(w["exp_avg"].abs().sum()) for w in
                 want[1]["state"].values())
    assert moved == (moments == "nonzero")
    opt.load_state_dict(got[1])
    bundle.model.load_state_dict(got[0])
    read = []
    orig = ocdbt.Reader.read

    def spy(self, key):
        read.append(key)
        return orig(self, key)

    ocdbt.Reader.read = spy
    try:
        state, adam, epoch = load_jax_checkpoint(orbax_dir)
    finally:
        ocdbt.Reader.read = orig
    assert adam is None and epoch == 4
    assert read and not [k for k in read if k.startswith(b"opt_state")]
    for k, v in want[0].items():
        assert torch.equal(state[k], v), k


def test_multi_chunk_arrays_and_missing_chunks(jax_dir, tmp_path):
    """An array rewritten through tensorstore in 3 x 5 chunks with fill
    value 0, the all-zero chunks never stored: the port reads what
    tensorstore reads, and the bf16 leaf as its words."""
    import shutil

    path = str(tmp_path / "ck")
    shutil.copytree(jax_dir, path)
    params, _, _ = orbax_backend.restore(path, opt_state=False)
    kernel = np.array(params["gates_ints"]["kernel"])
    kernel[:6] = 0  # whole chunk rows of zeros: not stored
    spec = {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": "file://%s/" % path,
                        "path": "params.gates_ints.kernel/"},
            "metadata": {"dtype": "<f4", "shape": list(kernel.shape),
                         "chunks": [3, 5], "fill_value": 0,
                         "compressor": {"id": "zstd", "level": 1}}}
    t = ts.open(spec, create=True, delete_existing=True).result()
    t.write(kernel).result()
    keys = ocdbt.Reader(path).keys()
    chunks = [k for k in keys if k.startswith(b"params.gates_ints.kernel/")
              and not k.endswith(b".zarray")]
    n_grid = -(-kernel.shape[0] // 3) * -(-kernel.shape[1] // 5)
    assert 1 < len(chunks) < n_grid
    got, _, _ = orbax_backend.restore(path, opt_state=False)
    np.testing.assert_array_equal(got["gates_ints"]["kernel"],
                                  ts.open(spec).result().read().result())
    np.testing.assert_array_equal(got["gates_ints"]["kernel"], kernel)
    bf16 = got["out_ints"]["kernel"]
    assert bf16.dtype == torch.bfloat16
    want = _ts_items(path)[b"params.out_ints.kernel/0.0"]
    assert bf16.view(torch.int16).numpy().tobytes() == \
        bindings.zstd_decompress(want, bf16.numel() * 2).tobytes()


def _trained_port(preset="int_rel_ch", weight_decay=None, steps=2):
    """A port model and its Adam after `steps` steps on seeded batches;
    with the JAX params tree and optax chain of the same preset."""
    jcfg = _cfg(config_lib, preset, weight_decay)
    jb = jax_create_model(jcfg, 9, n_rels=6)
    bundle, opt = _port_pair(preset, weight_decay)
    bundle.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                              jb.params)))
    step = make_train_step(bundle, opt)
    tables = {k: torch.from_numpy(v) for k, v in make_tables(
        bundle.spec, 24, 40, seed=0).items()}
    for i in range(steps):
        step(make_batch(bundle.spec, 4, 24, 40, seed=i), tables,
             step_generators(0, i, "cpu"))
    tx = jax_make_optimizer(jcfg.optim.lr, jcfg.optim.weight_decay)
    return bundle, opt, jb.params, tx


@pytest.mark.parametrize("weight_decay", [None, 0.0])
def test_jax_restores_the_port_checkpoint(tmp_path, weight_decay):
    """save_train_state_any(..., "orbax"): the JAX orbax_backend.restore
    against its own templates gives the port's weights, Adam state and
    epoch bit for bit, and params-only the weights; _METADATA's tree is
    the one the JAX writer gives what it restored; the port reads its own
    directory back bitwise."""
    bundle, opt, jparams, tx = _trained_port(weight_decay=weight_decay)
    path = str(tmp_path / "latest.ckpt")
    save_train_state_any(path, bundle.model, opt, 7, backend="orbax")
    save_train_state_any(path, bundle.model, opt, 7, backend="orbax")
    assert sorted(os.listdir(tmp_path)) == ["latest.ckpt"]  # replaced
    params, opt_state, epoch = jax_orbax.restore(path, jparams,
                                                 tx.init(jparams))
    assert epoch == 7
    want_p = params_to_jax(bundle.model.state_dict())
    want_o = opt_state_to_jax(bundle.model, opt)
    got_p = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(got_p) == jax.tree.structure(want_p)
    for g, w in zip(jax.tree.leaves(got_p), jax.tree.leaves(want_p)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    from flax import serialization

    live = jax.tree.map(np.asarray, serialization.to_state_dict(opt_state))
    assert jax.tree.structure(live) == jax.tree.structure(want_o)
    for g, w in zip(jax.tree.leaves(live), jax.tree.leaves(want_o)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    only, none, epoch = jax_orbax.restore(path, jparams)
    assert none is None and epoch == 7
    for g, w in zip(jax.tree.leaves(jax.tree.map(np.asarray, only)),
                    jax.tree.leaves(want_p)):
        np.testing.assert_array_equal(g, w)
    again = str(tmp_path / "jax_again")
    jax_orbax.save(again, params, opt_state=opt_state, epoch=7)
    with open(os.path.join(path, "_METADATA")) as f:
        ours = json.load(f)
    with open(os.path.join(again, "_METADATA")) as f:
        theirs = json.load(f)
    assert ours == theirs
    state, adam, epoch = load_jax_checkpoint(path, bundle.model, opt)
    assert epoch == 7
    for k, v in bundle.model.state_dict().items():
        assert torch.equal(state[k], v), k


def test_jax_restores_bf16_leaves_bitwise(tmp_path):
    """orbax_backend.save of a tree with torch.bfloat16 leaves: the JAX
    restore against a bf16 template holds the same words."""
    _, params, opt_state = _jax_tree(moments="nonzero", bf16=True)
    port_params = {
        k: {kk: (torch.from_numpy(np.array(vv).view(np.int16)).view(
            torch.bfloat16) if vv.dtype == jnp.bfloat16 else np.asarray(vv))
            for kk, vv in v.items()} for k, v in params.items()}
    path = str(tmp_path / "bf16.ckpt")
    orbax_backend.save(path, port_params, epoch=2)
    got, _, epoch = jax_orbax.restore(path, params)
    assert epoch == 2
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g).view(np.uint8),
                                      np.asarray(w).view(np.uint8))
    mine, _, _ = orbax_backend.restore(path)
    assert torch.equal(mine["out_ints"]["kernel"],
                       port_params["out_ints"]["kernel"])


def test_tree_metadata_is_the_jax_writers(tmp_path, jax_dir):
    """tree_metadata of the JAX tree in the state-dict form (sequences
    as "0".."n", empty states {}) is what the JAX writer wrote."""
    from flax import serialization

    _, params, opt_state = _jax_tree(bf16=True)
    payload = {"params": jax.tree.map(np.asarray, params),
               "opt_state": jax.tree.map(
                   np.asarray, serialization.to_state_dict(opt_state)),
               "epoch": 3}
    with open(os.path.join(jax_dir, "_METADATA")) as f:
        assert orbax_backend.tree_metadata(payload) == json.load(f)[
            "tree_metadata"]
