"""Tensor-parallel training of the port (the ``model`` mesh axis,
parallel/mesh.py) over gloo processes on the CPU, against the JAX
package's sharded step on the same mesh of XLA CPU devices and against
the port's own one-process run.

Every mesh preset (int_rel_ch, int_ch, int_rels, modalities) on the
synthetic fixture, at its narrow widths, under meshes 1x2 and 2x2 (one
cluster of D * M ranks per mesh, the rank functions below, which import
no jax): from the JAX package's initial weights, the first three batches
of the shuffled epoch (the third ragged for int_rels and modalities,
padded by the port's step) with dropout 0, f32: the first step's loss and
gradient (gathered over the model group) within rtol 1e-5 of
``lirec_tpu.parallel.step.make_sharded_train_step``'s, and the parameters
after the three steps within rtol 1e-5 of its; the parameters the plan
replicates bitwise equal across the model peers; with dropout 0.3 the
losses within rtol 1e-5 of the port's one-process steps (the masks are
drawn at the full width and the global batch's rows: layers.draw_cols).
Under 1x2 the ranks also run train() on int_rel_ch with the cadence eval
and msgpack checkpoints: its best-n metrics and the sweep's integer
counters on the returned replica equal the one-process run's, its
``latest.ckpt`` is read by the JAX package and by a one-process port run,
and a resume under 1x2 continues as the one-process run does. Tolerances
are relative to each tensor's largest element (as
tests/test_torch_dist_train.py holds parameters).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from lirec_tpu_torch import config as port_config
from lirec_tpu_torch.data import synthetic as port_synthetic
from lirec_tpu_torch.data.pipeline import EpochIterator
from lirec_tpu_torch.evaluation import packed
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.parallel import dist
from lirec_tpu_torch.parallel.mesh import (
    gather_grads, gather_state, make_mesh, shard_model,
)
from lirec_tpu_torch.parallel.step import make_dp_train_step
from lirec_tpu_torch.train.loop import (
    make_train_step, step_generators, train,
)
from lirec_tpu_torch.train.optim import load_state, make_optimizer
from tests import torch_dist_worker as worker

PRESETS = {"int_rel_ch": "test", "int_ch": "test", "int_rels": "val",
           "modalities": "val"}
MESHES = ((1, 2), (2, 2))
B, STEPS, DROPOUT = 8, 3, 0.3
CLUSTER_TIMEOUT = 300  # seconds for one cluster, start to end


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(root, preset, dropout, **optim):
    base = port_synthetic.make_config(root)
    return port_config.preset(preset, data_root=root).replace(
        dims=base.dims, paths=base.paths).with_runtime(
        compute_dtype="float32").with_optim(batch_size=B, lr=1e-3,
                                            dropout=dropout, **optim)


def _bundle(job, dropout):
    cfg = _cfg(job["root"], job["preset"], dropout)
    bundle = create_model(cfg, job["n_classes"], n_rels=job["n_rels"],
                          device="cpu")
    bundle.model.load_state_dict(torch.load(job["state"]))
    return cfg, bundle


def _steps(job, dropout, mesh=None):
    """STEPS steps on job's batches from job's weights: (losses, the
    first step's gradient, the final parameters, both in full, and the
    parameters this process holds whole)."""
    cfg, bundle = _bundle(job, dropout)
    model = bundle.model
    opt = make_optimizer(model.parameters(), cfg.optim.lr,
                         cfg.optim.weight_decay)
    if mesh is None:
        step = make_train_step(bundle, opt)
    else:
        shard_model(model, mesh, bundle.spec, opt)
        step = make_dp_train_step(bundle, opt, mesh, B)
    data = torch.load(job["data"], weights_only=False)
    tables = {k: torch.from_numpy(v) for k, v in data["tables"].items()}
    losses, grads = [], None
    for i, batch in enumerate(data["batches"]):
        if mesh is None and len(batch["labels"]) != B:
            from lirec_tpu_torch.train.loop import _pad_batch

            batch = _pad_batch(batch, B)
        losses.append(float(step(batch, tables,
                                 step_generators(0, i, "cpu"))))
        if i == 0:
            grads = {k: v.clone() for k, v in gather_grads(model).items()}
    full = gather_state(model, mesh)[0] if mesh is not None else \
        model.state_dict()
    whole = {n: p.detach().clone() for n, p in model.named_parameters()
             if p.shape == full[n].shape}
    return losses, grads, {k: v.clone() for k, v in full.items()}, whole


def _train_run(job, mesh=None, resume=None):
    """train() on int_rel_ch: 1 epoch from the seeded weights with the
    cadence eval on val and msgpack checkpoints, then the sweep's carry of
    val on the returned model; then a second epoch resumed from the
    `resume` file (default: this run's latest.ckpt), under the same
    mesh."""
    import dataclasses

    from lirec_tpu_torch.cli.common import load_train_state_any
    from lirec_tpu_torch.train.optim import file_state

    cfg, ds = worker.port_setup(job["root"], "int_rel_ch", "train", B,
                                epochs=1, save_model=True, lr=1e-3,
                                dropout=0.0)
    _, val = worker.port_setup(job["root"], "int_rel_ch", "val", B)
    val.n_classes = ds.n_classes
    cfg = cfg.replace(paths=dataclasses.replace(cfg.paths,
                                                store_root=job["store"]))
    n_rels = max(len(ds.rels_list) - 1, 0)
    bundle = create_model(cfg, ds.n_classes, n_rels=n_rels, device="cpu")
    out = train(cfg, bundle, ds, val_dataset=val, verbose=False, mesh=mesh,
                checkpoint_every=1, checkpoint_backend="msgpack")
    last = dispatch.last_dispatch("train_loop")
    carry = packed.sweep_carry(val, bundle, out["model"], cfg, mode="val",
                               mesh=mesh)
    latest = os.path.join(job["store"], "latest.ckpt")
    resumed = create_model(cfg, ds.n_classes, n_rels=n_rels, device="cpu")
    opt = make_optimizer(resumed.model.parameters(), cfg.optim.lr,
                         cfg.optim.weight_decay)
    state, opt_state, epoch = load_train_state_any(resume or latest,
                                                   resumed.model, opt)
    resumed.model.load_state_dict(state)
    load_state(opt, opt_state)
    again = train(cfg.with_optim(epochs=2, save_model=False), resumed, ds,
                  optimizer=opt, start_epoch=epoch + 1, verbose=False,
                  mesh=mesh)
    return {"losses": out["losses"], "resumed": again["losses"],
            "eval": {k: dict(v) for k, v in out["saver"].eval.items()},
            "carry": carry, "latest": latest,
            "sweep": (out["epoch_sweep_used"], last["path"], last["reason"]),
            "state": {k: v.clone() for k, v in
                      out["model"].state_dict().items()},
            "opt": file_state(out["optimizer"])}


def _dense_run(root, mesh=None):
    """train() on dense int_rel_ch batches (the reference layout, no
    tables): 2 epochs at batch B with dropout DROPOUT from the seeded
    weights; the losses per epoch."""
    cfg, ds = worker.port_setup(root, "int_rel_ch", "test", B, epochs=2,
                                save_model=False, lr=1e-3, dropout=DROPOUT)
    bundle = create_model(cfg, ds.n_classes,
                          n_rels=max(len(ds.rels_list) - 1, 0), device="cpu")
    return train(cfg, bundle, ds, verbose=False, dense=True,
                 mesh=mesh)["losses"]


def model_axis_rank(jobs, shape, train_job=None):
    """One rank of a `shape` mesh: per job, _steps with dropout 0 and
    DROPOUT; _dense_run; then, given a train_job, _train_run."""
    mesh = make_mesh(shape)
    out = {"steps": [{d: _steps(job, d, mesh) for d in (0.0, DROPOUT)}
                     for job in jobs],
           "place": (mesh.rank, mesh.model_rank),
           "dense": _dense_run(jobs[0]["root"], mesh)}
    if train_job is not None:
        out["train"] = _train_run(train_job, mesh)
    return out


def _assert_close_scaled(got, want, rel, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max()) if want.size else 0.0
    bad = np.abs(got - want) > rel * (np.abs(want) + scale)
    assert not bad.any(), "%s: %d of %d beyond the bound; worst %.3e" % (
        name, bad.sum(), bad.size, float(np.abs(got - want).max()))


def _jax_sharded(job):
    """The JAX package's sharded step on a job's mesh of XLA CPU devices:
    (the first step's loss, its gradient, the parameters after the
    steps), in the port's names."""
    import jax

    from lirec_tpu.parallel import mesh as mesh_lib
    from lirec_tpu.parallel.step import make_sharded_train_step
    from lirec_tpu.train.optim import make_optimizer as jax_optimizer
    from lirec_tpu_torch.checkpoint import params_from_jax

    jb, cfg, tables, batches, shape = job
    tx = jax_optimizer(cfg.optim.lr, cfg.optim.weight_decay)
    mesh = mesh_lib.make_mesh(shape=shape,
                              devices=jax.devices()[:int(np.prod(shape))])
    state = make_sharded_train_step(jb, tx, mesh, jb.params, tables)
    first = mesh_lib.shard_tree(batches[0],
                                mesh_lib.batch_shardings(batches[0], mesh))
    # the step's own loss function (lirec_tpu/parallel/step._build_step)
    rng_drop, rng_loss = jax.random.split(jax.random.PRNGKey(0))
    model_batch = {k: first[k] for k in ("feat_idx", "rels_mask")
                   if k in first}

    def loss_fn(p):
        outputs = jb.apply(p, model_batch, tables=state.tables,
                           deterministic=False, rng=rng_drop, data_mesh=mesh)
        return jb.loss(outputs, first, rng=rng_loss, tr_sum_max_flag=True)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    for i, batch in enumerate(batches):
        state.step(batch, jax.random.PRNGKey(i))
    return (float(loss), params_from_jax(jax.tree.map(np.asarray, grads)),
            params_from_jax(jax.tree.map(np.asarray,
                                         jax.device_get(state.params))))


@pytest.fixture(scope="module")
def runs(synth_root, tmp_path_factory):
    """Per preset: the jobs' files, the JAX package's sharded step per
    mesh, the port's one-process steps with dropout, and each mesh's
    cluster (the clusters and the JAX steps run at once, in threads)."""
    import jax

    from lirec_tpu import config as config_lib
    from lirec_tpu.data import synthetic
    from lirec_tpu.models.factory import create_model as jax_create_model
    from lirec_tpu_torch.checkpoint import params_from_jax

    work = tmp_path_factory.mktemp("model_axis")
    out = {"jobs": [], "single": {}}
    base = synthetic.make_config(synth_root)
    jax_jobs = {}
    for preset, mode in PRESETS.items():
        _, ds = worker.port_setup(synth_root, preset, mode, B)
        n_rels = max(len(ds.rels_list) - 1, 0)
        # the first STEPS full batches of the shuffled epochs
        epochs = EpochIterator(ds, B, seed=0)
        batches = [b for _ in range(STEPS) for b in epochs
                   if len(b["labels"]) == B][:STEPS]
        tables = ds.tables.as_dict()
        cfg = config_lib.preset(preset, data_root=synth_root).replace(
            dims=base.dims, paths=base.paths).with_runtime(
            compute_dtype="float32").with_optim(batch_size=B, lr=1e-3,
                                                dropout=0.0)
        jb = jax_create_model(cfg, ds.n_classes, n_rels=n_rels)
        job = dict(preset=preset, root=synth_root, n_classes=ds.n_classes,
                   n_rels=n_rels, state=str(work / ("%s.pt" % preset)),
                   data=str(work / ("%s.data" % preset)))
        torch.save(params_from_jax(jax.tree.map(np.asarray, jb.params)),
                   job["state"])
        torch.save({"batches": batches, "tables": tables}, job["data"])
        out["jobs"].append(job)
        for shape in MESHES:
            jax_jobs[(preset, shape)] = (jb, cfg, tables, batches, shape)
    train_job = dict(root=synth_root, store=str(work / "ckpt"))
    for shape in MESHES:
        (work / ("%dx%d" % shape)).mkdir()
    with ThreadPoolExecutor(4) as pool:
        clusters = {shape: pool.submit(
            dist.spawn, model_axis_rank, int(np.prod(shape)),
            args=(out["jobs"], shape, train_job if shape == (1, 2)
                  else None),
            timeout=CLUSTER_TIMEOUT, workdir=str(work / ("%dx%d" % shape)))
            for shape in MESHES}
        out["jax"] = dict(zip(jax_jobs, pool.map(_jax_sharded,
                                                 jax_jobs.values())))
        for job in out["jobs"]:
            out["single"][job["preset"]] = _steps(job, DROPOUT)[0]
        out["dense_single"] = _dense_run(synth_root)
        out["train_single"] = _train_run(dict(train_job,
                                              store=str(work / "single")))
        for shape, cluster in clusters.items():
            out[shape] = [r.value for r in cluster.result()]
    return out


CASES = [(p, m) for m in MESHES for p in PRESETS]


def _ids(case):
    return "%s-%dx%d" % (case[0], *case[1])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_step_matches_the_jax_sharded_step(runs, case):
    """The first step's loss and gathered gradient, and the parameters
    after STEPS steps, within rtol 1e-5 of the JAX package's sharded
    step on the same mesh shape, on every rank."""
    preset, shape = case
    j = list(PRESETS).index(preset)
    loss, grads, params = runs["jax"][case]
    for rank in runs[shape]:
        losses, got_grads, got_params, _ = rank["steps"][j][0.0]
        np.testing.assert_allclose(losses[0], loss, rtol=1e-5)
        assert set(got_grads) == set(grads)
        for k, v in grads.items():
            _assert_close_scaled(got_grads[k], v, 1e-5, "grad " + k)
        assert set(got_params) == set(params)
        for k, v in params.items():
            _assert_close_scaled(got_params[k], v, 1e-5, "param " + k)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_dropout_steps_match_one_process(runs, case):
    """With dropout on, the losses within rtol 1e-5 of the port's
    one-process steps: the same masks, drawn at the full width."""
    preset, shape = case
    j = list(PRESETS).index(preset)
    for rank in runs[shape]:
        np.testing.assert_allclose(rank["steps"][j][DROPOUT][0],
                                   runs["single"][preset], rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_replicated_parameters_are_bitwise_equal_across_model_peers(
        runs, shape):
    """The parameters the plan replicates (out_ctx, out_ints without the
    gate, the row layers' biases) are bitwise equal on the model peers of
    every row after the steps, with no collective over them; and every
    rank holds a slice of the sharded ones."""
    ranks = runs[shape]
    assert sorted(r["place"] for r in ranks) == [
        (d, m) for d in range(shape[0]) for m in range(shape[1])]
    for j, job in enumerate(runs["jobs"]):
        for dropout in (0.0, DROPOUT):
            for d in range(shape[0]):
                row = [r["steps"][j][dropout][3] for r in ranks
                       if r["place"][0] == d]
                full = ranks[0]["steps"][j][dropout][2]
                assert len(row[0]) < len(full), job["preset"]
                for peer in row[1:]:
                    assert set(peer) == set(row[0])
                    for k, v in row[0].items():
                        assert torch.equal(peer[k], v), (job["preset"], k)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_dense_training_matches_one_process(runs, shape):
    """train(dense=True) over the mesh (the dense forwards' linears
    column- and row-parallel, their dropout masks drawn at the full
    width): the epoch losses within rtol 1e-5 of one process's, on every
    rank."""
    for rank in runs[shape]:
        np.testing.assert_allclose(rank["dense"], runs["dense_single"],
                                   rtol=1e-5)


def test_train_under_1x2_matches_one_process(runs):
    """train() under 1x2 on int_rel_ch: the epoch sweep ran its eager
    steps ("model mesh"), losses within rtol 1e-5 of the one-process
    run, the cadence's best-n metrics and the sweep's integer counters on
    the returned replica equal to it (the carry summed over the data axis
    only), and the resumed epoch's loss too."""
    want = runs["train_single"]
    assert want["sweep"] == (True, "eager", "cpu tensors")
    for rank in runs[(1, 2)]:
        got = rank["train"]
        assert got["sweep"] == (True, "eager", "model mesh")
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["resumed"], want["resumed"],
                                   rtol=1e-5)
        assert got["eval"] == want["eval"]
        for k, v in want["carry"].items():
            if v.dtype.kind != "f":
                np.testing.assert_array_equal(got["carry"][k], v, err_msg=k)
    assert runs[(1, 2)][0]["train"]["latest"] is not None


def test_1x2_checkpoint_is_read_by_jax_and_one_process(runs, tmp_path):
    """The 1x2 run's latest.ckpt, written by rank 0 from the gathered
    state: the JAX package's load_train_state and the port's reader both
    give the gathered weights and Adam moments of the ranks' replica bit
    for bit, and a one-process run resumed from it takes the second epoch
    as the 1x2 resume does (loss within rtol 1e-5)."""
    import jax

    from flax import serialization
    from lirec_tpu.checkpoint import load_train_state as jax_load
    from lirec_tpu_torch.checkpoint import load_jax_checkpoint, params_from_jax

    ranks = [r["train"] for r in runs[(1, 2)]]
    path = ranks[0]["latest"]
    cfg, ds = worker.port_setup(runs["jobs"][0]["root"], "int_rel_ch",
                                "train", B)
    model = create_model(cfg, ds.n_classes,
                         n_rels=max(len(ds.rels_list) - 1, 0),
                         device="cpu").model
    opt = make_optimizer(model.parameters(), 1e-3)
    state, opt_state, epoch = load_jax_checkpoint(path, model, opt)
    with open(path, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    params, _, jax_epoch = jax_load(path, tree["params"], tree["opt_state"])
    assert epoch == jax_epoch == 0
    from_jax = params_from_jax(jax.tree.map(np.asarray, params))
    for r in ranks:
        assert set(state) == set(r["state"])
        for k, v in r["state"].items():
            assert torch.equal(state[k], v), k
            np.testing.assert_array_equal(from_jax[k], v.numpy(), err_msg=k)
        for i, st in r["opt"]["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt_state["state"][i][key], st[key]), i
    single = _train_run(dict(root=runs["jobs"][0]["root"],
                             store=str(tmp_path)), resume=path)
    np.testing.assert_allclose(single["resumed"], ranks[0]["resumed"],
                               rtol=1e-5)
