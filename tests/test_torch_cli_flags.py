"""The port's eval and training CLIs take every flag of the JAX package's
(lirec_tpu/cli/common.py): the PRNG flags parse and change nothing,
--coordinator and --process-id alone are accepted and change nothing (as
in the JAX package; with --num-processes they form a process group:
tests/test_torch_dist_cli.py), --profile and --assembly-workers are
accepted (what they do: tests/test_torch_profiling.py,
tests/test_torch_assembly_pool.py and the training CLI case below), so is
--ingest-cache (what it does: tests/test_torch_ingest.py), and
--auto-resume refuses a
store root whose only train state is the JAX package's Orbax latest.ckpt
instead of starting over beside it (its msgpack latest.ckpt resumes:
tests/test_torch_jax_checkpoints.py).
"""

import os

import numpy as np
import pytest
import torch

from lirec_tpu_torch.cli import common
from lirec_tpu_torch.cli import train as train_cli

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
    """The PRNG flags pass the refusal (the port has one dropout stream),
    and so do --profile, --assembly-workers, --coordinator and --process-id
    without --num-processes, and --ingest-cache. The JAX defaults ("", "",
    -1) given explicitly are not refused."""
    assert item is None
    base = ["--data-root", str(tmp_path / "no_data"), "--train"]
    parser = common.build_parser("int_rel_ch")
    common._refuse_unported(parser.parse_args(base + _argv(flag, value)))
    defaults = base + ["--profile", "", "--coordinator", "",
                       "--process-id", "-1"]
    common._refuse_unported(parser.parse_args(defaults))


@pytest.mark.parametrize("as_dir", [True])
def test_auto_resume_refuses_a_jax_latest_ckpt(tmp_path, as_dir):
    """A store root with the JAX package's latest.ckpt as an Orbax
    directory and no latest.pth.tar: --auto-resume exits naming the file
    and why Orbax is not read (its zstd compression), before any data is
    read."""
    store = tmp_path / "store"
    store.mkdir()
    latest = store / "latest.ckpt"
    latest.mkdir()
    argv = ["--data-root", str(tmp_path / "no_data"), "--store-root",
            str(store), "--auto-resume", "--device", "cpu"]
    with pytest.raises(SystemExit, match="latest.ckpt") as err:
        train_cli.main(argv)
    assert "Orbax" in str(err.value) and "zstd" in str(err.value)


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
