"""The port's AssemblyPool workers (data/pipeline.py), the cases of
tests/test_assembly_pool.py and more: identical batches at any worker
count, from the pool, in process, from the plan and from the pool's
in-process fallback, and the same as the JAX package's BatchIterator;
train() with workers, in one process and in each rank of a two-rank data
mesh. The pool runs only where no assembly plan applies, so every case
here forces that (fast_assembly=False or LIREC_TPU_NO_PLAN=1); dispatch
records which path each epoch took."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lirec_tpu import config as config_lib
from lirec_tpu.data import synthetic
from lirec_tpu.data.dataset import InteractionDataset
from lirec_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from lirec_tpu_torch import config as port_config
from lirec_tpu_torch.data import synthetic as port_synthetic
from lirec_tpu_torch.data.dataset import InteractionDataset as PortDataset
from lirec_tpu_torch.data.pipeline import (
    ASSEMBLY, AssemblyPool, BatchIterator, _assemble_batch_with, collate,
    prefetch_to_device,
)
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.parallel import dist
from lirec_tpu_torch.train.loop import train
from tests import torch_dist_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(root, port=True, epochs=2):
    lib, syn, dataset = ((port_config, port_synthetic, PortDataset) if port
                         else (config_lib, synthetic, InteractionDataset))
    base = syn.make_config(root)
    cfg = lib.preset("int_rel_ch", data_root=root)
    cfg = cfg.replace(dims=base.dims, paths=base.paths).with_runtime(
        compute_dtype="float32").with_optim(batch_size=7, epochs=epochs,
                                            save_model=False, lr=1e-3,
                                            dropout=0.0)
    ds = dataset(cfg, mode="train")
    ds.cache()
    ds.init_relships()
    return cfg, ds


def _epochs(it, n=2):
    return [[b for b in it] for _ in range(n)]


def _assert_same_epochs(got, want):
    assert len(got) == len(want)
    for eg, ew in zip(got, want):
        assert len(eg) == len(ew)
        for bg, bw in zip(eg, ew):
            assert set(bg) == set(bw)
            for k in bw:
                assert bg[k].dtype == bw[k].dtype, k
                np.testing.assert_array_equal(bg[k], bw[k], err_msg=k)


def test_worker_counts_agree(synth_root):
    """workers=2 (the pool), workers=0 (in process), the plan and the
    in-process fallback give bitwise the same two shuffled epochs, and the
    JAX package's BatchIterator gives them too; each path is recorded."""
    _, ds = _dataset(synth_root)
    before = dispatch.decisions(ASSEMBLY)

    def counted(path):
        return dispatch.decisions(ASSEMBLY).get(path, 0) - before.get(path, 0)

    pooled_it = BatchIterator(ds, 7, shuffle=True, seed=3, workers=2,
                              fast_assembly=False)
    try:
        pooled = _epochs(pooled_it)
    finally:
        pooled_it.close()
    assert counted("pool") == 2
    assert dispatch.last_dispatch(ASSEMBLY)["reason"] == "2 workers"
    default = _epochs(BatchIterator(ds, 7, shuffle=True, seed=3,
                                    fast_assembly=False))
    assert counted("per-sample") == 2
    planned = _epochs(BatchIterator(ds, 7, shuffle=True, seed=3))
    assert counted("plan") == 2
    fallback_it = BatchIterator(ds, 7, shuffle=True, seed=3, workers=1,
                                fast_assembly=False)
    fallback_it._pool = False
    fallback = _epochs(fallback_it)
    assert counted("fallback") == 2
    _, jax_ds = _dataset(synth_root, port=False)
    jax_pooled_it = JaxBatchIterator(jax_ds, 7, shuffle=True, seed=3,
                                     workers=2, fast_assembly=False)
    try:
        jax_pooled = _epochs(jax_pooled_it)
    finally:
        jax_pooled_it.close()
    for other in (default, planned, fallback, jax_pooled):
        _assert_same_epochs(pooled, other)


def test_pool_that_cannot_start_falls_back_with_a_warning(synth_root,
                                                           monkeypatch):
    """A pool whose bootstrap fails: the JAX package's in-process
    fallback, warned and recorded with its reason, the same batches."""
    _, ds = _dataset(synth_root)

    def refuse(*args, **kw):
        raise RuntimeError("worker bootstrap failed (exit 1)")

    it = BatchIterator(ds, 7, shuffle=True, seed=3, workers=2,
                       fast_assembly=False)
    monkeypatch.setattr("lirec_tpu_torch.data.pipeline.AssemblyPool",
                        refuse)
    with pytest.warns(UserWarning, match="assembly worker pool unavailable"):
        got = _epochs(it, 1)
    rec = dispatch.last_dispatch(ASSEMBLY)
    assert rec["path"] == "fallback" and "bootstrap failed" in rec["reason"]
    want = _epochs(BatchIterator(ds, 7, shuffle=True, seed=3,
                                 fast_assembly=False), 1)
    _assert_same_epochs(got, want)


def test_train_with_assembly_workers(synth_root, monkeypatch):
    """train() with 2 workers and no plan: the pool assembles both epochs,
    and the losses are bitwise those of the in-process run."""
    monkeypatch.setenv("LIREC_TPU_NO_PLAN", "1")
    losses = {}
    for workers in (2, 0):
        cfg, ds = _dataset(synth_root)
        bundle = create_model(cfg, ds.n_classes,
                              n_rels=max(len(ds.rels_list) - 1, 0),
                              device="cpu")
        before = dispatch.decisions(ASSEMBLY).get("pool", 0)
        out = train(cfg, bundle, ds, verbose=False,
                    assembly_workers=workers)
        pooled = dispatch.decisions(ASSEMBLY).get("pool", 0) - before
        assert pooled == (2 if workers else 0)
        assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
        losses[workers] = out["losses"]
    assert losses[2] == losses[0]


def test_assemble_batch_matches_getitem(synth_root):
    _, ds = _dataset(synth_root)
    batch = _assemble_batch_with(ds, ([0, 1], 5, 7))
    manual = collate([
        ds.__getitem__(i, np.random.default_rng((5, 7, i))) for i in (0, 1)
    ])
    for k in manual:
        np.testing.assert_array_equal(batch[k], manual[k])


def test_mesh_ranks_run_the_pool(pinned_pool_root, tmp_path, monkeypatch):
    """Two gloo ranks (dist.spawn: not daemonic, so a rank may start
    workers), each training over the data mesh with 2 assembly workers and
    no plan: each rank's epochs came from its pool, not the fallback, and
    the losses are the one-process run's (rtol 1e-5, the data-parallel
    tests' contract)."""
    monkeypatch.setenv("LIREC_TPU_NO_PLAN", "1")
    cfg, ds = worker.port_setup(pinned_pool_root, "int_rel_ch", "train", 8,
                                epochs=2, save_model=False, lr=1e-3,
                                dropout=0.0)
    bundle = create_model(cfg, ds.n_classes,
                          n_rels=max(len(ds.rels_list) - 1, 0),
                          device="cpu")
    state_path = str(tmp_path / "state.pt")
    torch.save(bundle.model.state_dict(), state_path)
    want = train(cfg, bundle, ds, verbose=False)["losses"]
    ranks = dist.spawn(worker.pool_train_rank, 2, timeout=300,
                       args=(pinned_pool_root, state_path, 2))
    for r in ranks:
        losses, decisions = r.value
        assert decisions == {"pool": 2}, decisions
        np.testing.assert_allclose(losses, want, rtol=1e-5)


def test_pool_inside_a_rank_raises_instead_of_falling_back(synth_root,
                                                           monkeypatch):
    """Inside a data-parallel rank a pool that cannot start fails the run
    by name: the fallback's warning would be lost among the ranks."""
    _, ds = _dataset(synth_root)

    def refuse(*args, **kw):
        raise RuntimeError("worker bootstrap failed (exit 1)")

    monkeypatch.setattr("lirec_tpu_torch.data.pipeline.AssemblyPool",
                        refuse)
    monkeypatch.setattr(dist, "_IN_RANK", True)
    it = BatchIterator(ds, 7, shuffle=True, seed=3, workers=2,
                       fast_assembly=False)
    with pytest.raises(RuntimeError, match="data-parallel rank"):
        next(iter(it))


def test_worker_runs_outside_the_card_and_without_jax(synth_root):
    """A pool worker has unpickled the dataset, imported no jax and nothing
    of the JAX package, and sees no card; the parent's
    CUDA_VISIBLE_DEVICES is restored after the spawn."""
    _, ds = _dataset(synth_root)
    before = os.environ.get("CUDA_VISIBLE_DEVICES")
    with AssemblyPool(ds, 1) as pool:
        assert os.environ.get("CUDA_VISIBLE_DEVICES") == before
        foreign, visible = pool._pool.apply(worker.pool_worker_facts)
    assert foreign == []
    assert visible == ""


def test_prefetch_on_the_cpu_converts_to_tensors(synth_root):
    """prefetch_to_device(..., "cpu") yields the same batches as
    tensors, in order."""
    _, ds = _dataset(synth_root)
    host = list(BatchIterator(ds, 7, shuffle=True, seed=1))
    staged = list(prefetch_to_device(iter(host), "cpu", size=2))
    assert len(staged) == len(host)
    for s, h in zip(staged, host):
        assert set(s) == set(h)
        for k in h:
            assert isinstance(s[k], torch.Tensor)
            np.testing.assert_array_equal(s[k].numpy(), h[k], err_msg=k)


@pytest.fixture(scope="module")
def pinned_pool_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mg_pool_pinned"))
    subprocess.run(
        [sys.executable, "-c", "import sys; from lirec_tpu.data import "
         "synthetic; synthetic.generate(sys.argv[1])", root],
        cwd=ROOT, check=True, env=dict(os.environ, PYTHONHASHSEED="7"))
    return root
