"""The port's CLIs over data-parallel processes on the CPU, with the JAX
package's flags (lirec_tpu/cli/common.py:244-296): ``--mesh 2x1 --device
cpu`` spawns two gloo ranks in-process, and two ``--num-processes 2
--coordinator file://... --process-id r`` processes form one group. Each
writes one set of checkpoint files (rank 0's), with the losses and the
metrics of the single-process run; only rank 0 prints. The refusals of
the JAX package's messages, and of a ``model`` axis by its ROADMAP item,
come before any data is read.

The fixture is written under a fixed string-hash seed (every run compares
the same data); the ranks run torch on one thread, and each cluster has a
time limit (``cli.common.SPAWN_TIMEOUT`` for the ranks ``--mesh``
spawns).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lirec_tpu_torch.cli import common, int_rel_ch
from lirec_tpu_torch.cli import train as train_cli
from lirec_tpu_torch.parallel.dist import MODEL_AXIS_ITEM
from tests import torch_dist_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM_ARGS = ["--text-dim", "16", "--visual-dim", "32", "--text-layers", "4",
            "--joint-dim", "16", "--compute-dtype", "float32"]
PROCESS_TIMEOUT = 300  # seconds for each process of a cluster


@pytest.fixture
def cluster_limit(monkeypatch):
    """A time limit for the ranks a --mesh run spawns."""
    monkeypatch.setattr(common, "SPAWN_TIMEOUT", PROCESS_TIMEOUT)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pinned_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mg_cli_pinned"))
    subprocess.run(
        [sys.executable, "-c", "import sys; from lirec_tpu.data import "
         "synthetic; synthetic.generate(sys.argv[1])", root],
        cwd=ROOT, check=True, env=dict(os.environ, PYTHONHASHSEED="7"))
    return root


def _train_args(root, store, backend):
    return ["--data-root", root, "--store-root", store, "--batch-size", "8",
            "--lr", "1e-3", "--epochs", "3", "--checkpoint-every", "1",
            "--checkpoint-backend", backend] + DIM_ARGS


def _files(store):
    return sorted(os.path.relpath(os.path.join(d, f), store)
                  for d, _, names in os.walk(store) for f in names)


@pytest.fixture(scope="module")
def single(pinned_root, tmp_path_factory):
    """The single-process training CLI runs (both backends) and the eval
    CLI on the final msgpack checkpoint."""
    out = {}
    for backend in ("torch", "msgpack"):
        store = str(tmp_path_factory.mktemp("single_" + backend))
        run = train_cli.main(_train_args(pinned_root, store, backend)
                             + ["--device", "cpu", "--quiet"])
        out[backend] = (run["train"], store)
    final = os.path.join(out["msgpack"][1], "2.ckpt")
    out["eval"] = int_rel_ch.main(["--data-root", pinned_root,
                                   "--resume-path", final, "--batch-size",
                                   "4", "--device", "cpu", "--quiet"]
                                  + DIM_ARGS)
    return out


def _same_run(got, got_store, want, want_store):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert _files(got_store) == _files(want_store)
    with open(os.path.join(got_store, "index.json")) as f:
        got_index = json.load(f)
    with open(os.path.join(want_store, "index.json")) as f:
        want_index = json.load(f)
    assert set(got_index) == set(want_index)
    for key, epochs in want_index.items():
        assert set(got_index[key]) == set(epochs), key
        for epoch, v in epochs.items():
            np.testing.assert_allclose(got_index[key][epoch], v, rtol=1e-6,
                                       atol=1e-9, err_msg=key)


@pytest.mark.parametrize("backend", ["torch", "msgpack"])
def test_mesh_2x1_on_the_cpu_trains_as_one_process(single, pinned_root,
                                                   tmp_path, backend,
                                                   cluster_limit):
    """--mesh 2x1 --device cpu: two gloo ranks train 3 epochs with cadence
    evaluation (the sharded sweep) and a train state every epoch; the one
    store holds the single-process run's file names, its best-n metrics
    and its losses (rtol 1e-5), in either backend."""
    store = str(tmp_path / "store")
    got = train_cli.main(_train_args(pinned_root, store, backend)
                         + ["--device", "cpu", "--quiet", "--mesh", "2x1"])
    want, want_store = single[backend]
    _same_run(got["train"], store, want, want_store)
    assert got["train"]["final_path"] == os.path.join(
        store, "2.ckpt" if backend == "msgpack" else "2.pth.tar")


def test_mesh_2x1_eval_cli_gives_the_single_process_metrics(single,
                                                             pinned_root,
                                                             cluster_limit):
    """The eval CLI under --mesh 2x1 --device cpu on the final .ckpt: the
    val and test metrics of the single-process sweep (rtol 2e-6)."""
    final = os.path.join(single["msgpack"][1], "2.ckpt")
    got = int_rel_ch.main(["--data-root", pinned_root, "--resume-path",
                           final, "--batch-size", "4", "--device", "cpu",
                           "--quiet", "--mesh", "2x1"] + DIM_ARGS)
    for split in ("val", "test"):
        assert set(got[split]) == set(single["eval"][split])
        for key, v in single["eval"][split].items():
            np.testing.assert_allclose(got[split][key], v, rtol=2e-6,
                                       atol=1e-7, err_msg=key)


def test_two_processes_with_a_coordinator(single, pinned_root, tmp_path):
    """Two processes of the training CLI, --num-processes 2 --coordinator
    file://<path> --process-id 0 / 1 (no --mesh: a data-only mesh of 2):
    one set of files with the single-process run's metrics; rank 0 prints
    the epochs, rank 1 prints nothing."""
    store = str(tmp_path / "store")
    rendezvous = "file://" + str(tmp_path / "rendezvous")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lirec_tpu_torch.cli.train"]
        + _train_args(pinned_root, store, "msgpack")
        + ["--device", "cpu", "--num-processes", "2", "--coordinator",
           rendezvous, "--process-id", str(r)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROCESS_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stderr[-4000:]
    assert "epoch 2 loss" in outs[0][0]
    assert outs[1][0] == ""
    want, want_store = single["msgpack"]
    losses = [float(line.split()[3]) for line in outs[0][0].splitlines()
              if line.startswith("epoch ")]
    _same_run(dict(losses=losses), store, want, want_store)


@pytest.mark.parametrize("extra,match", [
    (["--mesh", "2x2"], "'model' axis is not ported"),
    (["--mesh", "2x1", "--host-eval"],
     "--mesh only shards the packed eval sweep; drop --host-eval"),
    (["--num-processes", "2"],
     "--num-processes needs --coordinator HOST:PORT and --process-id"),
    (["--num-processes", "2", "--coordinator", "localhost:1"],
     "--num-processes needs --coordinator HOST:PORT and --process-id"),
    (["--mesh", "2x1", "--device", "cuda"],
     r"--mesh 2x1 needs 2 devices; \d+ visible"),
    (["--mesh", "3x1", "--num-processes", "2", "--coordinator",
      "localhost:1", "--process-id", "0"], "needs 3 processes"),
    (["--mesh", "4"], "--mesh expects DATAxMODEL"),
])
def test_refusals_before_any_data_is_read(tmp_path, extra, match):
    """A model axis (naming its ROADMAP item), --host-eval under a mesh,
    --num-processes without --coordinator and --process-id, more ranks
    than visible cards (this box has none), a mesh that is not the
    process count, and a malformed --mesh: each refused before the data
    root (which does not exist) is read."""
    if extra == ["--mesh", "2x1", "--device", "cuda"] and \
            torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible")
    with pytest.raises(SystemExit, match=match) as err:
        train_cli.main(["--data-root", str(tmp_path / "none")] + extra
                       + (["--device", "cpu"] if "--device" not in extra
                          else []))
    if extra == ["--mesh", "2x2"]:
        assert MODEL_AXIS_ITEM in str(err.value)


def test_coordinator_alone_changes_nothing(pinned_root, tmp_path):
    """--coordinator (or --process-id) without --num-processes is accepted
    and runs the single-process path, as in the JAX package."""
    base = ["--data-root", pinned_root, "--store-root", str(tmp_path),
            "--batch-size", "8", "--epochs", "1", "--device", "cpu",
            "--quiet", "--sanity-check"] + DIM_ARGS
    plain = train_cli.main(base)
    with_flags = train_cli.main(base + ["--coordinator", "localhost:1",
                                        "--process-id", "0"])
    assert with_flags["train"]["losses"] == plain["train"]["losses"]


def test_run_entry_refuses_an_unguarded_child(tmp_path):
    """run_entry inside a multiprocessing child that is not a rank of
    spawn() (a launching script without a __main__ guard, re-imported by
    a spawned worker) raises instead of running the entry again."""
    import multiprocessing

    out = str(tmp_path / "message")
    proc = multiprocessing.get_context("spawn").Process(
        target=worker.run_entry_outside_a_rank, args=(out,))
    proc.start()
    proc.join(PROCESS_TIMEOUT)
    assert not proc.is_alive() and proc.exitcode == 0
    with open(out) as f:
        assert "re-executed inside a multiprocessing child" in f.read()
