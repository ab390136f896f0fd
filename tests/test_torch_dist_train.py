"""Data-parallel training of the port over two gloo processes on the CPU
(parallel/step.py, train/loop.train(mesh=...)) against the port's
single-process train() and the JAX package's, and the step over a world of
one against the plain step.

The fixture is the synthetic one written under a fixed string-hash seed
(as tests/test_torch_train.py pins it, so every run compares the same
data). int_rel_ch and int_rels train 2 epochs at batch 8 from the JAX
package's initial weights, dropout 0 (the deterministic forward), lr 1e-3.
Each epoch has a ragged last batch, padded to 8 with loss_weight 0 (its
second half partly padding), and an int_rels batch whose halves hold
different numbers of rows with a valid relationship label: the losses'
denominators must be the global batch's. Losses and final parameters
within rtol 1e-5, the tolerance of tests/test_torch_train.py. One
two-rank cluster (tests/torch_dist_worker.py) runs both presets, under a
time limit, rendezvousing through a FileStore in a temporary directory.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lirec_tpu import config as config_lib
from lirec_tpu.data import synthetic
from lirec_tpu.data.dataset import InteractionDataset
from lirec_tpu.models.factory import create_model as jax_create_model
from lirec_tpu.train.loop import train as jax_train
from lirec_tpu_torch.checkpoint import params_from_jax
from lirec_tpu_torch.data.pipeline import EpochIterator
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.parallel import dist
from lirec_tpu_torch.train.loop import train
from tests import torch_dist_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLUSTER_TIMEOUT = 300  # seconds for one cluster, start to end
B, EPOCHS = 8, 2
PRESETS = ("int_rel_ch", "int_rels")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pinned_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mg_dist_pinned"))
    subprocess.run(
        [sys.executable, "-c", "import sys; from lirec_tpu.data import "
         "synthetic; synthetic.generate(sys.argv[1])", root],
        cwd=ROOT, check=True, env=dict(os.environ, PYTHONHASHSEED="7"))
    return root


def _jax_setup(root, preset):
    base = synthetic.make_config(root)
    cfg = config_lib.preset(preset, data_root=root)
    cfg = cfg.replace(dims=base.dims, paths=base.paths).with_runtime(
        compute_dtype="float32").with_optim(
        batch_size=B, epochs=EPOCHS, save_model=False, lr=1e-3, dropout=0.0)
    ds = InteractionDataset(cfg, mode="train")
    ds.cache()
    ds.init_relships()
    return cfg, ds


def _assert_close_scaled(got, want, rel, name):
    """|got - want| <= rel * (|want| + max|want|) (as
    tests/test_torch_train.py holds parameters)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max()) if want.size else 0.0
    bad = np.abs(got - want) > rel * (np.abs(want) + scale)
    assert not bad.any(), "%s: %d of %d beyond the bound; worst %.3e" % (
        name, bad.sum(), bad.size, float(np.abs(got - want).max()))


@pytest.fixture(scope="module")
def runs(pinned_root, tmp_path_factory):
    """Per preset: the JAX package's train() (per batch), the port's
    single-process train() and the two ranks' train(mesh=(2, 1)), all from
    the JAX package's initial weights; with the port's dataset."""
    work = tmp_path_factory.mktemp("dist_train")
    out, jobs = {}, []
    for preset in PRESETS:
        cfg, ds = _jax_setup(pinned_root, preset)
        n_rels = max(len(ds.rels_list) - 1, 0)
        jb = jax_create_model(cfg, ds.n_classes, n_rels=n_rels)
        state = params_from_jax(jax.tree.map(np.asarray, jb.params))
        state_path = str(work / ("%s.pt" % preset))
        torch.save(state, state_path)
        want = jax_train(cfg, jb, ds, verbose=False, epoch_sweep=False)
        pcfg, pds = worker.port_setup(pinned_root, preset, "train", B,
                                      epochs=EPOCHS, save_model=False,
                                      lr=1e-3, dropout=0.0)
        pb = create_model(pcfg, pds.n_classes, n_rels=n_rels, device="cpu")
        pb.model.load_state_dict(state)
        single = train(pcfg, pb, pds, verbose=False)
        out[preset] = dict(
            jax=(want["losses"], params_from_jax(
                jax.tree.map(np.asarray, want["params"]))),
            single=(single["losses"], pb.model.state_dict()), ds=pds)
        jobs.append(dict(preset=preset, mode="train", batch_size=B,
                         state_path=state_path, epochs=EPOCHS))
    ranks = dist.spawn(worker.train_rank, 2, args=(pinned_root, jobs),
                       timeout=CLUSTER_TIMEOUT, workdir=str(work))
    for i, preset in enumerate(PRESETS):
        out[preset]["ranks"] = [r.value[i] for r in ranks]
    return out


def test_fixture_has_padding_and_uneven_rels_halves(runs):
    """The global-denominator cases are really there: a ragged batch
    padded to 8 (rank 1's half partly padding), and int_rels batches whose
    halves count different valid relationship labels, padding aside."""
    for preset in PRESETS:
        ds = runs[preset]["ds"]
        assert len(ds) % B > 1, preset
    ds = runs["int_rels"]["ds"]
    n_rels = max(len(ds.rels_list) - 1, 0)
    uneven = 0
    for epoch, batches in enumerate([list(EpochIterator(ds, B, seed=0))
                                     for _ in range(EPOCHS)]):
        for batch in batches:
            if len(batch["labels"]) != B:
                continue
            valid = batch["rels_label"].reshape(B) != n_rels
            uneven += int(valid[:B // 2].sum() != valid[B // 2:].sum())
    assert uneven > 0


@pytest.mark.parametrize("preset", PRESETS)
def test_two_rank_training_matches_single_process_and_jax(runs, preset):
    """Both ranks end with bitwise the same parameters and losses; losses
    and parameters within rtol 1e-5 of the port's single-process train()
    and of the JAX package's."""
    run = runs[preset]
    (l0, p0), (l1, p1) = run["ranks"]
    assert l0 == l1
    for k, v in p0.items():
        np.testing.assert_array_equal(p1[k], v, err_msg=k)
    assert len(l0) == EPOCHS and np.all(np.isfinite(l0))
    for ref in ("single", "jax"):
        losses, params = run[ref]
        np.testing.assert_allclose(l0, losses, rtol=1e-5, err_msg=ref)
        assert set(params) == set(p0)
        for k, v in params.items():
            _assert_close_scaled(p0[k], v, 1e-5, "%s %s" % (ref, k))


def test_two_rank_sweep_is_the_per_batch_mesh_path(pinned_root, tmp_path):
    """train(mesh=(2, 1)) with the epoch sweep (eager DDP steps inside the
    sweep's structure, recorded as "eager" for "data mesh") and with the
    per-batch path, int_rel_ch, dropout 0.3, 2 epochs at batch 8 (a padded
    last batch): bitwise the same losses and parameters on each rank, and
    on both ranks. The sweep weights every batch (one is ragged) where the
    per-batch path weights the padded one only; under a mesh both means
    divide a sum by the global count (bitwise, as on one process)."""
    cfg, ds = _jax_setup(pinned_root, "int_rel_ch")
    jb = jax_create_model(cfg, ds.n_classes,
                          n_rels=max(len(ds.rels_list) - 1, 0))
    state_path = str(tmp_path / "state.pt")
    torch.save(params_from_jax(jax.tree.map(np.asarray, jb.params)),
               state_path)
    job = dict(preset="int_rel_ch", batch_size=B, state_path=state_path,
               epochs=EPOCHS, dropout=0.3)
    ranks = [r.value for r in dist.spawn(
        worker.sweep_rank, 2, args=(pinned_root, job),
        timeout=CLUSTER_TIMEOUT, workdir=str(tmp_path))]
    for out in ranks:
        (l_s, p_s, used_s, dec_s), (l_b, p_b, used_b, dec_b) = (
            out[True], out[False])
        assert used_s and not used_b
        assert dec_s == ("eager", "data mesh")
        assert dec_b == ("per_batch", "epoch_sweep off")
        assert len(l_s) == EPOCHS and np.all(np.isfinite(l_s))
        assert l_s == l_b
        for k, v in p_b.items():
            np.testing.assert_array_equal(p_s[k], v, err_msg=k)
    for k, v in ranks[0][True][1].items():
        np.testing.assert_array_equal(ranks[1][True][1][k], v, err_msg=k)


def test_world_of_one_step_is_the_plain_step_bit_for_bit(tmp_path):
    """make_dp_train_step over a gloo group of one (DDP, its all-reduce
    and its mean over one rank) gives make_train_step's losses and
    parameters bit for bit, over steps with dropout on and a padded
    batch."""
    out = dist.spawn(worker.world_of_one_steps, 1, timeout=CLUSTER_TIMEOUT,
                     workdir=str(tmp_path))[0].value
    (dp_losses, dp_state), (plain_losses, plain_state) = out
    assert dp_losses == plain_losses
    for k, v in plain_state.items():
        np.testing.assert_array_equal(dp_state[k], v, err_msg=k)


def test_train_refuses_a_batch_that_does_not_divide():
    """The batch size must divide by the data axis (checked where the
    step is built, before any step runs); a model axis is refused by name
    (tests/test_torch_train.py) and --host-eval under a mesh as JAX
    refuses it."""
    from lirec_tpu_torch import config as port_config
    from lirec_tpu_torch.parallel.step import make_dp_train_step
    from lirec_tpu_torch.train.optim import make_optimizer

    cfg = port_config.preset("int_rel_ch").with_dims(
        text_dim=16, visual_dim=32, joint_dim=16)
    pb = create_model(cfg, 9, n_rels=6, device="cpu")
    opt = make_optimizer(pb.model.parameters(), 1e-3)
    with pytest.raises(ValueError, match="does not divide by the data axis"):
        make_dp_train_step(pb, opt, dist.DataMesh(2, 0), 7)
    with pytest.raises(ValueError, match="drop --host-eval"):
        train(cfg, pb, None, mesh=(1, 1), host_eval=True)


def test_every_loss_over_two_ranks_is_the_global_batch_loss(tmp_path):
    """Each loss of models/losses.py on two ranks' halves of a batch
    (sharded_batch): the ranks' losses add up to the whole batch's loss
    and their gradients, put together, are its gradient (rtol 1e-6), with
    padded rows, relationship labels 'None' on one half only, class
    weights, no loss_weight at all, and tr_cat_distr's samples drawn at
    the global batch's shape."""
    ranks = dist.spawn(worker.loss_shards, 2, timeout=CLUSTER_TIMEOUT,
                       workdir=str(tmp_path))
    halves = [r.value for r in ranks]
    for i, (name, fn, outputs, batch) in enumerate(worker.loss_cases()):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in outputs.items()}
        loss = fn(leaves, batch, torch.Generator().manual_seed(7))
        loss.backward()
        assert [h[i][0] for h in halves] == [name, name]
        np.testing.assert_allclose(sum(h[i][1] for h in halves),
                                   float(loss.detach()), rtol=1e-6,
                                   err_msg=name)
        for k, v in worker.grads_of(leaves).items():
            got = np.concatenate([h[i][2][k] for h in halves])
            np.testing.assert_allclose(got, v, rtol=1e-6, atol=1e-7,
                                       err_msg="%s %s" % (name, k))
