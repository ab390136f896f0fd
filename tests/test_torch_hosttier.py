"""The port's own copy of the numpy host tier (config, data, native, utils)
against the JAX package's originals: the same inputs give identical
outputs, bit for bit."""

import dataclasses
import os

import numpy as np
import pytest

from lirec_tpu import config as config_lib
from lirec_tpu.data import localize as jax_localize
from lirec_tpu.data import synthetic
from lirec_tpu.data.dataset import InteractionDataset
from lirec_tpu.data.plan import build_plan
from lirec_tpu.utils import fake_batch
from lirec_tpu_torch import config as port_config
from lirec_tpu_torch.data import localize as port_localize
from lirec_tpu_torch.data import synthetic as port_synthetic
from lirec_tpu_torch.data.dataset import InteractionDataset as PortDataset
from lirec_tpu_torch.data.plan import build_plan as port_build_plan
from lirec_tpu_torch.models.spec import ModelSpec
from lirec_tpu_torch.utils import fake_batch as port_fake_batch

INT_REL_CH = dict(ctx=True, gates=True, tr_maximize=True, rels_multitask=True)


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_synthetic_generate_writes_the_same_tree(tmp_path):
    """Both generators in one process (their files depend on the string
    hash seed, which one process shares)."""
    want = synthetic.generate(str(tmp_path / "jax"))
    got = port_synthetic.generate(str(tmp_path / "port"))
    a, b = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert a and sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], name
    assert dataclasses.asdict(got.dims) == dataclasses.asdict(want.dims)


@pytest.mark.parametrize("name", sorted(config_lib.PRESETS))
def test_presets_are_equal(name):
    kw = dict(data_root="/data/mg", store_root="/data/st", sanity_check=True)
    assert sorted(port_config.PRESETS) == sorted(config_lib.PRESETS)
    assert dataclasses.asdict(port_config.preset(name, **kw)) == \
        dataclasses.asdict(config_lib.preset(name, **kw))


def _datasets(root, mode):
    out = []
    for lib, syn, dataset in ((config_lib, synthetic, InteractionDataset),
                              (port_config, port_synthetic, PortDataset)):
        base = syn.make_config(root)
        cfg = lib.preset("int_rel_ch", data_root=root)
        cfg = cfg.replace(dims=base.dims, paths=base.paths)
        ds = dataset(cfg, mode=mode)
        ds.cache()
        ds.init_relships()
        out.append(ds)
    return out


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_materialize_is_identical(synth_root, mode):
    jd, pd = _datasets(synth_root, mode)
    assert (pd.n_classes, pd.n_rels, len(pd)) == (jd.n_classes, jd.n_rels,
                                                 len(jd))
    _assert_same_arrays(pd.materialize(), jd.materialize())
    _assert_same_arrays(pd.tables.as_dict(), jd.tables.as_dict())


@pytest.fixture(scope="module")
def dense_root(tmp_path_factory):
    """Draw-heavy synthetic data (30 scenes a movie, 40% multi-label
    relationship scenes), so that train assembly draws labels and
    subsamples contexts: the plan then has dynamic samples."""
    root = tmp_path_factory.mktemp("mg_dense")
    synthetic.generate(str(root), synthetic.SyntheticSpec(
        scenes=list(range(2, 62, 2)), extra_rel_p=0.4))
    return str(root)


@pytest.mark.parametrize("use_native", [True, False])
def test_assembly_plan_is_identical(dense_root, use_native):
    jd, pd = _datasets(dense_root, "train")
    want_plan, got_plan = build_plan(jd), port_build_plan(pd)
    assert got_plan.n_dynamic == want_plan.n_dynamic > 0
    order = np.random.default_rng(5).permutation(len(jd))
    for epoch in (0, 1):
        _assert_same_arrays(
            got_plan.assemble(order, 3, epoch, use_native=use_native),
            want_plan.assemble(order, 3, epoch, use_native=use_native))
        assert got_plan.last_engine == want_plan.last_engine
    assert got_plan.last_engine == ("native" if use_native else "numpy")


def test_fake_batches_are_identical():
    spec = ModelSpec(n_classes=11, n_rels=5, text_dim=16, visual_dim=24,
                     track_dim=24, joint_dim=16, **INT_REL_CH)
    _assert_same_arrays(port_fake_batch.make_tables(spec, 40, 60, seed=2),
                        fake_batch.make_tables(spec, 40, 60, seed=2))
    for make in ("make_batch", "make_structured_batch"):
        _assert_same_arrays(
            getattr(port_fake_batch, make)(spec, 16, 40, 60, seed=4),
            getattr(fake_batch, make)(spec, 16, 40, 60, seed=4))


def test_eval_localization_is_identical():
    spec = ModelSpec(n_classes=11, n_rels=5, **INT_REL_CH)
    fi = np.concatenate([
        fake_batch.make_structured_batch(spec, 8, 300, 500, seed=s)
        ["feat_idx"] for s in range(3)])  # 24 samples: 2 full batches of 8
    fi = fi[:21]  # and a ragged tail the localisation leaves alone
    for got, want in (
        (port_localize.localize_eval_ctx(fi, 8, 2, 300, 500),
         jax_localize.localize_eval_ctx(fi, 8, 2, 300, 500)),
        (port_localize.localize_eval_ctx_triples(fi, 8, 2, 500),
         jax_localize.localize_eval_ctx_triples(fi, 8, 2, 500)),
    ):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
