"""The port's eval and training CLIs take every flag of the JAX package's
(lirec_tpu/cli/common.py): the PRNG flags parse and change nothing,
--coordinator and --process-id alone are accepted and change nothing (as
in the JAX package; with --num-processes they form a process group:
tests/test_torch_dist_cli.py), --profile and --assembly-workers are
accepted (what they do: tests/test_torch_profiling.py,
tests/test_torch_assembly_pool.py and the training CLI case below), so is
--ingest-cache (what it does: tests/test_torch_ingest.py), and
--auto-resume resumes a store root whose only train state is the JAX
training CLI's Orbax latest.ckpt, with its weights and Adam state (its
msgpack latest.ckpt: tests/test_torch_jax_checkpoints.py).
"""

import copy
import os

import numpy as np
import pytest
import torch

from lirec_tpu_torch.cli import common
from lirec_tpu_torch.cli import train as train_cli
from tests.jax_cache_guard import isolated_xla_cache  # noqa: F401

DIM_ARGS = ["--text-dim", "16", "--visual-dim", "32", "--text-layers", "4",
            "--joint-dim", "16", "--compute-dtype", "float32"]

# flag, value (None: store_true), the refusal's item title (None: accepted;
# every flag of the JAX package's CLIs is ported)
JAX_FLAGS = [
    ("--fast-prng", None, None),
    ("--strict-prng", None, None),
    ("--profile", "trace_dir", None),
    ("--assembly-workers", "2", None),
    ("--coordinator", "localhost:1234", None),
    ("--process-id", "0", None),
    ("--ingest-cache", "x.npz", None),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(flag, value):
    return [flag] if value is None else [flag, value]


@pytest.mark.parametrize("preset", ["int_rel_ch", "int_ch", "int_rels"])
@pytest.mark.parametrize("flag,value,item", JAX_FLAGS)
def test_jax_flags_parse(preset, flag, value, item):
    """Each flag of the JAX package's CLIs parses for every preset."""
    parser = common.build_parser(preset)
    args = parser.parse_args(["--data-root", "/nonexistent"]
                             + _argv(flag, value))
    dest = flag[2:].replace("-", "_")
    assert getattr(args, dest) != parser.get_default(dest)


@pytest.mark.parametrize("flag,value,item", JAX_FLAGS)
def test_jax_flags_accepted_or_refused_by_name(tmp_path, flag, value, item):
    """The PRNG flags pass the entry's checks before any data is read
    (the port has one dropout stream), and so do --profile,
    --assembly-workers, --coordinator and --process-id without
    --num-processes, and --ingest-cache: one process, no mesh. The JAX
    defaults ("", "", -1) given explicitly are not refused. (No flag is
    refused any more: the last refusal, Orbax checkpoints, went when the
    port came to read and write them.)"""
    assert item is None
    base = ["--data-root", str(tmp_path / "no_data"), "--train"]
    parser = common.build_parser("int_rel_ch")
    assert common.mesh_shape(parser.parse_args(base + _argv(flag, value)),
                             "int_rel_ch") is None
    defaults = base + ["--profile", "", "--coordinator", "",
                       "--process-id", "-1"]
    assert common.mesh_shape(parser.parse_args(defaults),
                             "int_rel_ch") is None


@pytest.mark.parametrize("preset", ["int_rel_ch", "int_ch", "int_rels",
                                    "modalities"])
def test_mesh_help_describes_the_ported_model_axis(preset, capsys):
    """--help describes --mesh as the DATAxMODEL mesh that shards training
    (the model axis is ported), as the JAX package's help does, and
    says nowhere that something is not ported."""
    with pytest.raises(SystemExit) as exc:
        common.build_parser(preset).parse_args(["--help"])
    assert exc.value.code == 0
    text = " ".join(capsys.readouterr().out.split())
    assert "not ported" not in text
    assert "DATAxMODEL" in text and "tp over joint_dim" in text


@pytest.mark.parametrize("as_dir", [True])
def test_auto_resume_refuses_a_jax_latest_ckpt(synth_root, tmp_path,
                                               monkeypatch, as_dir):
    """A store root whose only train state is the latest.ckpt the JAX
    training CLI wrote under --checkpoint-backend orbax (a directory, epoch
    0): --auto-resume in the port starts at epoch 1 with the JAX run's
    weights and Adam state (as orbax itself restores them, mapped by
    params_from_jax / opt_state_from_jax), bit for bit, and trains on.
    (The name is from when the port refused the directory.)"""
    import shutil

    import jax
    import orbax.checkpoint as ocp

    from lirec_tpu.cli import train as jax_train_cli
    from lirec_tpu_torch.checkpoint import (
        opt_state_from_jax, params_from_jax,
    )
    from lirec_tpu_torch.train import loop

    store = tmp_path / "store"
    argv = ["modalities", "--data-root", synth_root, "--store-root",
            str(store), "--batch-size", "8", "--lr", "1e-3", "--quiet"]
    jax_train_cli.main(argv + ["--epochs", "1", "--checkpoint-every", "1",
                               "--checkpoint-backend", "orbax"] + DIM_ARGS)
    latest = store / "latest.ckpt"
    assert latest.is_dir() == as_dir
    for name in os.listdir(store):  # latest.ckpt alone is left
        if name != "latest.ckpt":
            path = store / name
            shutil.rmtree(path) if path.is_dir() else path.unlink()
    tree = jax.tree.map(np.asarray,
                        ocp.PyTreeCheckpointer().restore(str(latest)))
    assert tree["epoch"] == 0
    seen = {}
    orig = loop.train

    def spy(cfg, bundle, *args, optimizer=None, **kw):
        seen["state"] = {k: v.clone()
                         for k, v in bundle.model.state_dict().items()}
        seen["adam"] = copy.deepcopy(optimizer.state_dict())
        seen["model"], seen["optimizer"] = bundle.model, optimizer
        return orig(cfg, bundle, *args, optimizer=optimizer, **kw)

    monkeypatch.setattr(loop, "train", spy)
    out = train_cli.main(argv + ["--device", "cpu", "--epochs", "2",
                                 "--auto-resume"] + DIM_ARGS)
    assert out["train"]["start_epoch"] == 1
    assert len(out["train"]["losses"]) == 1
    assert np.isfinite(out["train"]["losses"][0])
    want = params_from_jax(tree["params"])
    assert set(seen["state"]) == set(want)
    for k, v in want.items():
        assert torch.equal(seen["state"][k], v), k
    want_adam = opt_state_from_jax(tree["opt_state"], seen["model"],
                                   seen["optimizer"])
    assert float(want_adam["state"][0]["step"]) > 0
    for i, w in want_adam["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(seen["adam"]["state"][i][k], w[k]), (i, k)


def test_auto_resume_takes_latest_pth_tar(synth_root, tmp_path):
    """latest.pth.tar still resumes under --auto-resume, also with a JAX
    latest.ckpt beside it; an empty store root starts at epoch 0."""
    store = tmp_path / "store"
    base = ["--data-root", synth_root, "--store-root", str(store),
            "--batch-size", "8", "--device", "cpu", "--quiet",
            "--sanity-check", "--lr", "1e-3", "--auto-resume"] + DIM_ARGS
    first = train_cli.main(base + ["--epochs", "1", "--checkpoint-every",
                                   "1"])
    assert first["train"]["start_epoch"] == 0
    assert os.path.exists(store / "latest.pth.tar")
    (store / "latest.ckpt").write_bytes(b"\x80")
    resumed = train_cli.main(base + ["--epochs", "2"])
    assert resumed["train"]["start_epoch"] == 1
    assert len(resumed["train"]["losses"]) == 1
    assert np.isfinite(resumed["train"]["losses"][0])


@pytest.mark.parametrize("mesh", [[], ["--mesh", "2x1"]])
def test_train_cli_with_assembly_workers(synth_root, tmp_path, monkeypatch,
                                         mesh):
    """--assembly-workers 2 with no assembly plan (LIREC_TPU_NO_PLAN=1):
    the training CLI's losses are the in-process run's, in one process
    bitwise, and under --mesh 2x1 (each rank runs its own pool: the ranks
    are not daemonic) within the data-parallel contract's rtol 1e-5."""
    monkeypatch.setenv("LIREC_TPU_NO_PLAN", "1")
    monkeypatch.setattr(common, "SPAWN_TIMEOUT", 300)
    base = ["--data-root", synth_root, "--batch-size", "8", "--device",
            "cpu", "--quiet", "--sanity-check", "--lr", "1e-3", "--epochs",
            "2"] + DIM_ARGS
    want = train_cli.main(base + ["--store-root", str(tmp_path / "a")])
    got = train_cli.main(base + ["--store-root", str(tmp_path / "b"),
                                 "--assembly-workers", "2"] + mesh)
    if mesh:
        np.testing.assert_allclose(got["train"]["losses"],
                                   want["train"]["losses"], rtol=1e-5)
    else:
        assert got["train"]["losses"] == want["train"]["losses"]
