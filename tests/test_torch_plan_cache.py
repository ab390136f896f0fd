"""The port's disk-cached assembly plans (lirec_tpu_torch/data/
plan_cache.py), the cases of tests/test_plan_cache.py, plus the files the
two packages write beside each other:

1. second-process semantics: a fresh dataset instance over the same data
   loads the plan from disk (dispatch-recorded, never silent) and its
   epochs are bitwise-identical to the per-sample path through BOTH
   executors (the numpy executor exercises the lazy program decode);
2. safety gates: corrupted files rebuild, tampered-but-wellformed files
   fail the load-time bitwise spot check and are deleted, and the env
   opt-out writes nothing;
3. the JAX package's files and the port's: the two fingerprints of the
   same data differ (each pickles its own classes' module names), so
   neither package finds the other's file under its own name; a file of
   the other package under this one's name fails the fingerprint check,
   and the other package's plan arrays stamped with this one's
   fingerprint load only through the bitwise spot check.
"""

import os

import numpy as np
import pytest

from lirec_tpu import config as jax_config
from lirec_tpu.data import plan_cache as jax_plan_cache
from lirec_tpu.data.dataset import InteractionDataset as JaxDataset
from lirec_tpu.ops import dispatch as jax_dispatch
from lirec_tpu_torch import config as config_lib
from lirec_tpu_torch.data import plan_cache, synthetic
from lirec_tpu_torch.data.dataset import InteractionDataset, first_choice
from lirec_tpu_torch.data.pipeline import collate
from lirec_tpu_torch.ops import dispatch


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mg_port_plancache")
    spec = synthetic.SyntheticSpec(
        scenes=list(range(2, 42, 2)), extra_rel_p=0.4
    )
    synthetic.generate(str(root), spec)
    return str(root)


def _dataset(root, mode="train", chooser=None, jax=False):
    base = synthetic.make_config(root)
    lib, dataset = ((jax_config, JaxDataset) if jax
                    else (config_lib, InteractionDataset))
    cfg = lib.preset("int_rel_ch", data_root=root)
    cfg = cfg.replace(dims=base.dims, paths=base.paths)
    kw = {} if chooser is None else {"label_chooser": chooser}
    ds = dataset(cfg, mode=mode, **kw)
    ds.cache()
    ds.init_relships()
    return ds


def _reference_epoch(ds, order, seed, epoch):
    return collate(
        [
            ds.__getitem__(
                int(i), np.random.default_rng((seed, epoch, int(i)))
            )
            for i in order
        ]
    )


def _assert_tree_equal(ref, got):
    assert set(ref) == set(got)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


def test_round_trip_and_bitwise_equality(root):
    ds1 = _dataset(root)
    plan1 = ds1.assembly_plan()
    assert plan1 is not None
    d = dispatch.last_dispatch("assembly_plan_cache")
    assert d["path"] == "disk-cache" and d["reason"] == "built+saved"
    fp = plan_cache.dataset_fingerprint(ds1)
    path = plan_cache.cache_path(ds1, fp)
    assert os.path.exists(path)

    # a "second process": fresh dataset over the same data
    ds2 = _dataset(root)
    assert plan_cache.dataset_fingerprint(ds2) == fp
    plan2 = ds2.assembly_plan()
    d = dispatch.last_dispatch("assembly_plan_cache")
    assert d["path"] == "disk-cache" and d["reason"] == "hit+verified"

    order = np.random.default_rng(0).permutation(len(ds2))
    ref = _reference_epoch(ds2, order, seed=7, epoch=3)
    for use_native in (True, False):
        got = plan2.assemble(order, 7, 3, use_native=use_native)
        _assert_tree_equal(ref, got)
    assert plan2.n_dynamic == plan1.n_dynamic


def test_eval_mode_gets_its_own_file(root):
    ds = _dataset(root, mode="val")
    plan = ds.assembly_plan()
    assert plan is not None
    fp = plan_cache.dataset_fingerprint(ds)
    path = plan_cache.cache_path(ds, fp)
    assert os.path.exists(path) and "/val_" in path
    order = np.arange(len(ds))
    ref = _reference_epoch(ds, order, seed=1, epoch=0)
    _assert_tree_equal(ref, ds.assembly_plan().assemble(order, 1, 0))


def test_corrupted_file_rebuilds(root):
    ds = _dataset(root)
    fp = plan_cache.dataset_fingerprint(ds)
    path = plan_cache.cache_path(ds, fp)
    ds.assembly_plan()
    assert os.path.exists(path)
    with open(path, "wb") as f:
        f.write(b"not an npz")
    ds2 = _dataset(root)
    plan = ds2.assembly_plan()
    assert plan is not None
    # the rebuild overwrote the corrupted file with a loadable one
    assert plan_cache.load_plan(path, fp, ds2) is not None


def test_tampered_file_fails_spot_check_and_is_deleted(root):
    ds = _dataset(root)
    fp = plan_cache.dataset_fingerprint(ds)
    path = plan_cache.cache_path(ds, fp)
    ds.assembly_plan()
    plan = plan_cache.load_plan(path, fp, ds)
    assert plan is not None
    # well-formed file, right fingerprint, wrong content
    plan.static["labels"] = plan.static["labels"].copy()
    plan.static["labels"][0] += 1
    plan_cache.save_plan(path, plan, fp)
    assert plan_cache.load_plan(path, fp, ds) is None
    d = dispatch.last_dispatch("assembly_plan_cache")
    assert d["reason"] == "cache-verify-failed"
    assert not os.path.exists(path)


def test_env_opt_out_writes_nothing(root, monkeypatch):
    ds = _dataset(root)
    fp = plan_cache.dataset_fingerprint(ds)
    path = plan_cache.cache_path(ds, fp)
    if os.path.exists(path):
        os.remove(path)
    monkeypatch.setenv("LIREC_TPU_NO_PLAN_CACHE", "1")
    plan = ds.assembly_plan()
    assert plan is not None
    assert not os.path.exists(path)


def test_incompatible_dataset_skips_cache(root):
    ds = _dataset(root, chooser=first_choice)
    # non-default chooser: build_plan refuses, cache must refuse too
    assert ds.assembly_plan() is None
    assert plan_cache.get_or_build(ds) is None


def test_the_jax_packages_files_are_checked_or_ignored(root):
    """Both packages over the same data: different fingerprints and file
    names, each builds and saves its own; the JAX package's file under the
    port's name is rejected by the fingerprint check (and the port's under
    the JAX package's name by the JAX loader); the JAX package's plan
    arrays stamped with the port's fingerprint pass the port's bitwise spot
    check and assemble the port's per-sample batches."""
    port_ds, jax_ds = _dataset(root), _dataset(root, jax=True)
    port_fp = plan_cache.dataset_fingerprint(port_ds)
    jax_fp = jax_plan_cache.dataset_fingerprint(jax_ds)
    assert port_fp != jax_fp
    port_path = plan_cache.cache_path(port_ds, port_fp)
    jax_path = jax_plan_cache.cache_path(jax_ds, jax_fp)
    assert os.path.dirname(port_path) == os.path.dirname(jax_path)
    for path in (port_path, jax_path):
        if os.path.exists(path):
            os.remove(path)
    jax_plan = jax_ds.assembly_plan()
    assert jax_dispatch.last_dispatch("assembly_plan_cache")["reason"] == \
        "built+saved"
    port_ds.assembly_plan()
    assert dispatch.last_dispatch("assembly_plan_cache")["reason"] == \
        "built+saved"
    assert os.path.exists(port_path) and os.path.exists(jax_path)

    # the other package's file under this one's name
    with open(jax_path, "rb") as f:
        jax_bytes = f.read()
    with open(port_path, "rb") as f:
        port_bytes = f.read()
    with open(port_path, "wb") as f:
        f.write(jax_bytes)
    assert plan_cache.load_plan(port_path, port_fp, port_ds) is None
    assert dispatch.last_dispatch("assembly_plan_cache")["reason"] == \
        "cache-mismatch"
    with open(jax_path, "wb") as f:
        f.write(port_bytes)
    assert jax_plan_cache.load_plan(jax_path, jax_fp, jax_ds) is None
    assert jax_dispatch.last_dispatch("assembly_plan_cache")["reason"] == \
        "cache-mismatch"

    # the JAX package's plan arrays, stamped with the port's fingerprint
    plan_cache.save_plan(port_path, jax_plan, port_fp)
    plan = plan_cache.load_plan(port_path, port_fp, port_ds)
    assert plan is not None
    assert dispatch.last_dispatch("assembly_plan_cache")["reason"] == \
        "hit+verified"
    order = np.random.default_rng(1).permutation(len(port_ds))
    ref = _reference_epoch(port_ds, order, seed=2, epoch=1)
    for use_native in (True, False):
        _assert_tree_equal(ref, plan.assemble(order, 2, 1,
                                              use_native=use_native))
    os.remove(jax_path)
