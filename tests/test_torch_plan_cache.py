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
   same data are equal (the port pickles its modules under the JAX
   package's names), so both packages use one file, and each loads the
   other's through its own bitwise spot check; that pickle is made once
   per dataset, later runs finding the fingerprint under the C pickler's
   hash.
"""

import os

import numpy as np
import pytest

from lirec_tpu import config as jax_config
from lirec_tpu.data import plan_cache as jax_plan_cache
from lirec_tpu.data import synthetic as jax_synthetic
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
    lib, syn, dataset = ((jax_config, jax_synthetic, JaxDataset) if jax
                         else (config_lib, synthetic, InteractionDataset))
    base = syn.make_config(root)
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
    """Both packages over the same data: equal fingerprints, one file. The
    port loads the JAX package's file through its bitwise spot check and
    assembles its own per-sample batches from it; the JAX package loads
    the port's file through its own; a JAX-written file whose arrays were
    altered fails the port's spot check and is rebuilt."""
    for mode in ("train", "val"):
        port_ds, jax_ds = _dataset(root, mode), _dataset(root, mode, jax=True)
        port_fp = plan_cache.dataset_fingerprint(port_ds)
        assert port_fp == jax_plan_cache.dataset_fingerprint(jax_ds)
        assert plan_cache.reduced_state(port_ds)["chooser"] == \
            "lirec_tpu.data.dataset.random_choice"
        path = plan_cache.cache_path(port_ds, port_fp)
        assert path == jax_plan_cache.cache_path(jax_ds, port_fp)
        if os.path.exists(path):
            os.remove(path)

        # the JAX package writes, the port loads
        jax_plan = jax_ds.assembly_plan()
        assert jax_dispatch.last_dispatch("assembly_plan_cache")[
            "reason"] == "built+saved"
        plan = port_ds.assembly_plan()
        assert dispatch.last_dispatch("assembly_plan_cache")["reason"] == \
            "hit+verified"
        assert plan.n_dynamic == jax_plan.n_dynamic
        order = np.random.default_rng(1).permutation(len(port_ds))
        ref = _reference_epoch(port_ds, order, seed=2, epoch=1)
        for use_native in (True, False):
            _assert_tree_equal(ref, plan.assemble(order, 2, 1,
                                                  use_native=use_native))

        # the port writes, the JAX package loads
        os.remove(path)
        port_ds2, jax_ds2 = (_dataset(root, mode),
                             _dataset(root, mode, jax=True))
        port_ds2.assembly_plan()
        assert dispatch.last_dispatch("assembly_plan_cache")["reason"] == \
            "built+saved"
        assert jax_ds2.assembly_plan() is not None
        assert jax_dispatch.last_dispatch("assembly_plan_cache")[
            "reason"] == "hit+verified"

    # a JAX-written file of the right fingerprint and altered arrays
    os.remove(path)
    jax_plan.static["labels"] = jax_plan.static["labels"].copy()
    jax_plan.static["labels"][0] += 1
    jax_plan_cache.save_plan(path, jax_plan, port_fp)
    assert plan_cache.load_plan(path, port_fp, _dataset(root, "val")) is None
    assert dispatch.last_dispatch("assembly_plan_cache")["reason"] == \
        "cache-verify-failed"
    assert not os.path.exists(path)


@pytest.mark.parametrize("preset", ["int_rel_ch", "int_rels", "int_ch",
                                    "modalities"])
def test_fingerprints_are_equal(root, preset):
    """The two packages' fingerprints of every preset's splits are equal:
    the port's pickle names the JAX package's modules, and its memo
    refers back where the C pickler's does."""
    for mode in ("train", "val", "test"):
        states = []
        for lib, syn, dataset in (
                (jax_config, jax_synthetic, JaxDataset),
                (config_lib, synthetic, InteractionDataset)):
            base = syn.make_config(root)
            cfg = lib.preset(preset, data_root=root)
            ds = dataset(cfg.replace(dims=base.dims, paths=base.paths),
                         mode=mode)
            ds.cache()
            if cfg.tasks.rels or cfg.tasks.rels_multitask:
                ds.init_relships()
            states.append(ds)
        jax_ds, port_ds = states
        assert plan_cache.dataset_fingerprint(port_ds) == \
            jax_plan_cache.dataset_fingerprint(jax_ds), mode


def test_the_slow_pickle_is_made_once_per_dataset(root, tmp_path,
                                                   monkeypatch):
    """`cached_fingerprint` pickles under the JAX package's names on its
    first call only: it keeps the fingerprint in `<mode>_<C hash>.fp`,
    and a second dataset over the same data reads it there and loads the
    plan without the pure-Python pickler. A damaged file is made anew."""
    ds = _dataset(root, "val")
    want = plan_cache.dataset_fingerprint(ds)
    jax_fp = jax_plan_cache.dataset_fingerprint(_dataset(root, "val",
                                                         jax=True))
    assert plan_cache.cached_fingerprint(ds, str(tmp_path)) == want == jax_fp
    (alias,) = os.listdir(tmp_path)
    assert alias.startswith("val_") and alias.endswith(".fp")
    assert (tmp_path / alias).read_text() == want

    def refuse(obj):
        raise AssertionError("the pure-Python pickler ran again")

    ds.assembly_plan()  # writes the plan and the fingerprint's file
    with monkeypatch.context() as m:
        m.setattr(plan_cache, "jax_names_dumps", refuse)
        ds2 = _dataset(root, "val")
        assert plan_cache.cached_fingerprint(ds2, str(tmp_path)) == want
        assert ds2.assembly_plan() is not None
        assert dispatch.last_dispatch("assembly_plan_cache")["reason"] == \
            "hit+verified"

    (tmp_path / alias).write_text("not a fingerprint")
    assert plan_cache.cached_fingerprint(ds, str(tmp_path)) == want
    assert (tmp_path / alias).read_text() == want
