"""The port's ingest artifact (lirec_tpu_torch/data/artifact.py, cli/ingest.py
and the eval CLIs' ``--ingest-cache``) against the JAX package's, on the
synthetic fixture: the cases of tests/test_ingest_artifact.py, plus the
files the two packages share.

- One artifact serves both packages: the two ingest CLIs write the same
  members (arrays and the decoded ``__meta__``; the zip members' times
  differ, so the files' bytes are never compared).
- A JAX-written artifact evaluated by the port's CLI gives the JAX CLI's
  metrics on it, and a port-written one evaluated by the JAX CLI the
  port's (accuracies exactly, the loss within rtol 2e-6); the port loads
  the JAX package's artifact in a process where importing jax raises.
- Under ``--mesh 2x1 --device cpu`` only rank 0 writes the artifact, and
  the two ranks give the one-process metrics.

Torch runs on one thread, as in the port's other parity tests.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from lirec_tpu import config as jax_config
from lirec_tpu.cli import common as jax_common
from lirec_tpu.cli import ingest as jax_ingest
from lirec_tpu_torch import config as config_lib
from lirec_tpu_torch.cli import common, ingest
from lirec_tpu_torch.data.artifact import PackedSplit, load_ingest
from lirec_tpu_torch.models.factory import create_model
from tests.jax_cache_guard import isolated_xla_cache  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM_ARGS = ["--text-dim", "16", "--visual-dim", "32", "--text-layers", "4",
            "--joint-dim", "16", "--compute-dtype", "float32"]
INGEST_DIMS = ["--text-dim", "16", "--visual-dim", "32",
               "--text-layers", "4", "--joint-dim", "16"]
ACCURACIES = ("total", "ints", "rels", "tracks", "joint")
PROCESS_TIMEOUT = 300  # seconds for a process or a cluster of ranks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(lib, preset, root):
    return lib.preset(preset, data_root=root).with_dims(
        text_dim=16, visual_dim=32, text_layers=4, joint_dim=16)


def _checkpoint(root, preset, path):
    """A reference-format .pth.tar of seeded weights for `preset` on the
    fixture (the counts the datasets give)."""
    cfg = _cfg(config_lib, preset, root)
    train_ds, _, _ = common.build_datasets(cfg, preset)
    model = create_model(cfg, train_ds.n_classes,
                         n_rels=max(len(train_ds.rels_list) - 1, 0),
                         seed=3, device="cpu").model
    torch.save({"state_dict": model.state_dict(), "epoch": 0}, path)
    return path


def _eval_args(root, tmp_path, ckpt, extra=()):
    return (["--data-root", root, "--store-root", str(tmp_path / "st"),
             "--resume-path", ckpt, "--batch-size", "8", "--quiet"]
            + DIM_ARGS + list(extra))


def _same_metrics(got, want):
    """Accuracies (ratios of integer counters) exactly, the loss within
    rtol 2e-6."""
    for split in ("val", "test"):
        assert set(got[split]) == set(want[split]), split
        for key, v in want[split].items():
            if key in ACCURACIES:
                assert got[split][key] == v, (split, key)
            else:
                np.testing.assert_allclose(got[split][key], v, rtol=2e-6,
                                           atol=1e-7, err_msg=key)


def _members(path):
    with np.load(path, allow_pickle=False) as z:
        out = {k: z[k] for k in z.files}
    out["__meta__"] = json.loads(bytes(out["__meta__"]).decode("utf-8"))
    return out


# ------------------------------------------------- the JAX package's cases


def test_ingest_artifact_roundtrip_metrics(synth_root, tmp_path):
    """Eval through a loaded artifact gives the metric dict of a fresh
    ingest (which also writes the artifact), exactly; the host eval loop
    drives PackedSplit through BatchIterator's materialized path."""
    ckpt = _checkpoint(synth_root, "int_rel_ch", str(tmp_path / "w.pth.tar"))
    art = str(tmp_path / "ingest.npz")
    resume = _eval_args(synth_root, tmp_path, ckpt,
                        ["--device", "cpu", "--ingest-cache", art])
    fresh = common.run_entry("int_rel_ch", resume)  # ingests + writes
    assert os.path.exists(art)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    cached = common.run_entry("int_rel_ch", resume)  # loads, no mining
    for split in ("val", "test"):
        assert fresh[split] == cached[split], split
    hosted = common.run_entry("int_rel_ch", resume + ["--host-eval"])
    for split in ("val", "test"):
        for key, val in fresh[split].items():
            np.testing.assert_allclose(
                hosted[split][key], val, rtol=1e-5, atol=1e-6,
                err_msg="%s/%s" % (split, key),
            )


@pytest.mark.parametrize("preset", ["int_rel_ch", "int_rels"])
def test_ingest_cli_command_matches_live_datasets(synth_root, tmp_path,
                                                  preset):
    """`lirec-tpu-torch-ingest` output round-trips bit for bit to the live
    datasets' materialized arrays and tables."""
    art = str(tmp_path / "ingest_cmd.npz")
    assert ingest.main(["--data-root", synth_root, "--preset", preset,
                        "--out", art] + INGEST_DIMS) == art
    cfg = _cfg(config_lib, preset, synth_root)
    splits = load_ingest(art, cfg)
    live = dict(zip(("train", "val", "test"),
                    common.build_datasets(cfg, preset)))
    for role, ds in live.items():
        packed = splits[role]
        assert packed.mode == ds.mode
        assert packed.n_classes == ds.n_classes
        assert packed.n_rels == ds.n_rels
        assert packed.rels_list == list(ds.rels_list)
        assert packed.test_rels_multi_clip is False
        assert len(packed.hashidx_rels) == len(
            getattr(ds, "hashidx_rels", ()) or ()
        )
        a, b = packed.materialize(), ds.materialize()
        assert set(a) == set(b) and len(packed) == len(ds)
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        ta, tb = packed.tables.as_dict(), ds.tables.as_dict()
        for key in ta:
            np.testing.assert_array_equal(ta[key], tb[key], err_msg=key)


def test_ingest_artifact_rejects_mismatched_config(synth_root, tmp_path):
    art = str(tmp_path / "ingest_fp.npz")
    ingest.main(["--data-root", synth_root, "--preset", "modalities",
                 "--out", art] + INGEST_DIMS)
    other = config_lib.preset("modalities", data_root=synth_root).with_dims(
        text_dim=32, visual_dim=32, text_layers=4, joint_dim=16
    )
    with pytest.raises(ValueError, match="different config"):
        load_ingest(art, other)
    assert set(load_ingest(art)) == {"train", "val", "test"}


def test_ingest_cache_refused_for_training(synth_root, tmp_path):
    """With the JAX package's message, before any dataset is built."""
    art = tmp_path / "x.npz"
    with pytest.raises(SystemExit, match="serves the eval paths"):
        common.run_entry(
            "int_rel_ch",
            ["--data-root", str(tmp_path / "no_data"), "--train", "--quiet",
             "--device", "cpu", "--ingest-cache", str(art)] + DIM_ARGS,
        )
    assert not art.exists()


# ------------------------------------------ the artifact the packages share


@pytest.mark.parametrize("preset", ["int_rel_ch", "int_ch", "int_rels",
                                    "modalities"])
def test_both_packages_write_the_same_artifact(synth_root, tmp_path,
                                               preset):
    """The two ingest CLIs on one fixture: the same members, arrays bit
    for bit (dtype included) and the same decoded metadata; each package
    loads the other's file under its own config."""
    paths = {}
    for name, cli in (("jax", jax_ingest), ("port", ingest)):
        paths[name] = str(tmp_path / ("%s.npz" % name))
        cli.main(["--data-root", synth_root, "--preset", preset, "--out",
                  paths[name]] + INGEST_DIMS)
    want, got = _members(paths["jax"]), _members(paths["port"])
    assert sorted(got) == sorted(want)
    assert got.pop("__meta__") == want.pop("__meta__")
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
    from lirec_tpu.data.artifact import load_ingest as jax_load_ingest

    assert set(load_ingest(paths["jax"], _cfg(config_lib, preset,
                                                 synth_root))) == \
        set(jax_load_ingest(paths["port"], _cfg(jax_config, preset,
                                                 synth_root)))


@pytest.fixture(scope="module")
def jax_artifact(synth_root, tmp_path_factory):
    """{preset: (seeded .pth.tar, the JAX-written artifact, the JAX eval
    CLI's metrics from that artifact)}."""
    out = {}
    for preset in ("int_rel_ch", "int_rels"):
        tmp = tmp_path_factory.mktemp("jax_art_" + preset)
        ckpt = _checkpoint(synth_root, preset, str(tmp / "w.pth.tar"))
        art = str(tmp / "jax.npz")
        jax_ingest.main(["--data-root", synth_root, "--preset", preset,
                         "--out", art] + INGEST_DIMS)
        want = jax_common.run_entry(preset, _eval_args(
            synth_root, tmp, ckpt, ["--ingest-cache", art]))
        out[preset] = (ckpt, art, want)
    return out


@pytest.mark.parametrize("preset", ["int_rel_ch", "int_rels"])
def test_a_jax_artifact_gives_the_jax_metrics(jax_artifact, synth_root,
                                              tmp_path, preset):
    """The port's eval CLI (packed sweep and --host-eval) on the JAX
    package's artifact: the JAX eval CLI's metrics on it; int_rels sums its
    relationship score table with the single-table scatter (kernel 8's
    plain version here)."""
    ckpt, art, want = jax_artifact[preset]
    for extra in ([], ["--host-eval"]):
        got = common.run_entry(preset, _eval_args(
            synth_root, tmp_path, ckpt,
            ["--device", "cpu", "--ingest-cache", art] + extra))
        _same_metrics(got, want)


def test_a_port_artifact_gives_the_jax_cli_the_port_metrics(synth_root,
                                                            tmp_path):
    """The reverse: the port's eval CLI writes the artifact, the JAX eval
    CLI reads it (its own fingerprint check) and gives the port's
    metrics."""
    ckpt = _checkpoint(synth_root, "int_rel_ch", str(tmp_path / "w.pth.tar"))
    art = str(tmp_path / "port.npz")
    got = common.run_entry("int_rel_ch", _eval_args(
        synth_root, tmp_path, ckpt,
        ["--device", "cpu", "--ingest-cache", art]))
    assert os.path.exists(art)
    want = jax_common.run_entry("int_rel_ch", _eval_args(
        synth_root, tmp_path, ckpt, ["--ingest-cache", art]))
    _same_metrics(got, want)


_LOAD_WITHOUT_JAX = r"""
import importlib.abc, json, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "msgpack", "lirec_tpu", "tools"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import torch
torch.set_num_threads(1)
from lirec_tpu_torch.cli import common
out = common.run_entry("int_rel_ch", json.loads(sys.argv[1]))
print("METRICS " + json.dumps(out))
"""


def test_the_port_loads_a_jax_artifact_without_jax(jax_artifact, synth_root,
                                                   tmp_path):
    """In a process where importing jax or lirec_tpu raises, the port's
    eval CLI loads the JAX-written artifact (np.load, allow_pickle=False)
    and gives the JAX CLI's metrics."""
    ckpt, art, want = jax_artifact["int_rel_ch"]
    argv = _eval_args(synth_root, tmp_path, ckpt,
                      ["--device", "cpu", "--ingest-cache", art])
    res = subprocess.run(
        [sys.executable, "-c", _LOAD_WITHOUT_JAX, json.dumps(argv)],
        cwd=ROOT, capture_output=True, text=True, timeout=PROCESS_TIMEOUT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr[-4000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("METRICS ")]
    _same_metrics(json.loads(line[-1][len("METRICS "):]), want)


# ------------------------------------------------------ data parallelism


def test_only_rank_0_writes_the_artifact(synth_root, tmp_path):
    """A rank other than 0 that finds no artifact uses the datasets it
    built and writes nothing; rank 0 writes; an artifact that exists is
    loaded by every rank."""
    art = str(tmp_path / "ranks.npz")
    argv = ["--data-root", synth_root, "--resume-path", "x.pth.tar",
            "--ingest-cache", art] + DIM_ARGS
    args = common.build_parser("int_rel_ch").parse_args(argv)
    cfg = common.config_from_args("int_rel_ch", args)
    built = common._datasets(cfg, "int_rel_ch", args,
                             types.SimpleNamespace(rank=1), False)
    assert not os.path.exists(art)
    assert not any(isinstance(ds, PackedSplit) for ds in built)
    common._datasets(cfg, "int_rel_ch", args, types.SimpleNamespace(rank=0),
                     False)
    assert os.path.exists(art)
    for rank in (0, 1):
        loaded = common._datasets(cfg, "int_rel_ch", args,
                                  types.SimpleNamespace(rank=rank), False)
        assert all(isinstance(ds, PackedSplit) for ds in loaded)
        for ds, live in zip(loaded, built):
            np.testing.assert_array_equal(ds.materialize()["labels"],
                                          live.materialize()["labels"])


def test_mesh_2x1_with_an_ingest_cache(synth_root, tmp_path, monkeypatch):
    """--mesh 2x1 --device cpu --ingest-cache: two gloo ranks write one
    artifact (no temporary file left), then load it; both runs give the
    one-process metrics (rtol 2e-6)."""
    monkeypatch.setattr(common, "SPAWN_TIMEOUT", PROCESS_TIMEOUT)
    ckpt = _checkpoint(synth_root, "int_rel_ch", str(tmp_path / "w.pth.tar"))
    art = tmp_path / "art" / "mesh.npz"
    art.parent.mkdir()
    base = _eval_args(synth_root, tmp_path, ckpt, ["--device", "cpu"])
    want = common.run_entry("int_rel_ch", base)
    for _ in range(2):
        got = common.run_entry("int_rel_ch", base + [
            "--mesh", "2x1", "--ingest-cache", str(art)])
        assert os.listdir(art.parent) == ["mesh.npz"]
        for split in ("val", "test"):
            assert set(got[split]) == set(want[split])
            for key, v in want[split].items():
                np.testing.assert_allclose(got[split][key], v, rtol=2e-6,
                                           atol=1e-7, err_msg=key)
