"""The port's eval sweep sharded over two gloo processes on the CPU
(evaluation/packed.py over parallel/dist.py) against the JAX package's
single-device sweep, and the process group's plumbing.

The two-rank cluster runs once for the module (tests/torch_dist_worker.py,
a FileStore in a temporary directory, a time limit) and sweeps the presets
of tests/test_parallel.py:121-125 (int_rel_ch test, int_rels val,
modalities val) at batch sizes that give each rank several full batches
and the last rank a ragged tail, int_rel_ch in the off and triple tiers.
Every integer counter of the all-reduced carry equals the JAX carry; float
sums and metrics agree within rtol 2e-6. Torch runs on one thread in every
process.
"""

import jax
import numpy as np
import pytest
import torch

from lirec_tpu import config as config_lib
from lirec_tpu.data import synthetic
from lirec_tpu.data.dataset import InteractionDataset
from lirec_tpu.evaluation import packed as jax_packed
from lirec_tpu.models.factory import create_model as jax_create_model
from lirec_tpu_torch.checkpoint import params_from_jax
from lirec_tpu_torch.evaluation import packed as port_packed
from lirec_tpu_torch.evaluation.runner import MESH_HOST_EVAL, evaluate
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.parallel import dist
from tests import torch_dist_worker as worker

CLUSTER_TIMEOUT = 240  # seconds for one two-rank cluster, start to end
JOBS = [  # preset, mode, batch size, ctx localisation tier
    ("int_rel_ch", "test", 4, False),
    ("int_rel_ch", "test", 4, "triple"),
    ("int_rels", "val", 5, False),
    ("modalities", "val", 4, False),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_side(root, preset, mode, batch_size):
    base = synthetic.make_config(root)
    cfg = config_lib.preset(preset, data_root=root)
    cfg = cfg.replace(dims=base.dims, paths=base.paths).with_runtime(
        compute_dtype="float32").with_optim(batch_size=batch_size)
    ds = InteractionDataset(cfg, mode=mode)
    ds.cache()
    if cfg.tasks.rels or cfg.tasks.rels_multitask:
        ds.init_relships()
    bundle = jax_create_model(cfg, ds.n_classes,
                              n_rels=max(len(ds.rels_list) - 1, 0))
    return cfg, ds, bundle


@pytest.fixture(scope="module")
def cluster(synth_root, tmp_path_factory):
    """The JAX package's single-device sweep of every job (metrics and
    carry) and the two ranks' results of the same jobs on its weights."""
    work = tmp_path_factory.mktemp("dist_eval")
    jobs, want = [], []
    for preset, mode, batch_size, tier in JOBS:
        cfg, ds, bundle = _jax_side(synth_root, preset, mode, batch_size)
        state_path = str(work / ("%s.pt" % preset))
        torch.save(params_from_jax(jax.tree.map(np.asarray, bundle.params)),
                   state_path)
        captured = {}
        finish = jax_packed.finish_from_carry

        def capture(carry, *args, **kw):
            captured["carry"] = {k: np.asarray(v) for k, v in carry.items()}
            return finish(carry, *args, **kw)

        jax_packed.finish_from_carry = capture
        try:
            metrics = jax_packed.evaluate_packed(
                ds, bundle, bundle.params, cfg, mode=mode, verbose=False,
                localize_ctx=tier)
        finally:
            jax_packed.finish_from_carry = finish
        want.append((captured["carry"], metrics, len(ds)))
        jobs.append(dict(preset=preset, mode=mode, batch_size=batch_size,
                         state_path=state_path, tier=tier))
    ranks = dist.spawn(worker.eval_rank, 2, args=(synth_root, jobs),
                       timeout=CLUSTER_TIMEOUT, workdir=str(work))
    return want, [r.value for r in ranks]


@pytest.mark.parametrize("job", range(len(JOBS)),
                         ids=["%s-%s-B%d-%s" % j for j in JOBS])
def test_two_rank_sweep_matches_jax_single_device(cluster, job):
    """Both ranks end with the same all-reduced carry; its counters equal
    the JAX carry's, its loss sum and score table within rtol 2e-6, and
    the metrics too. Each rank swept whole batches of its own: the split
    gives each at least one, and the last one the tail."""
    want, ranks = cluster
    (jc, jm, n), (p0, m0), (p1, m1) = want[job], ranks[0][job], ranks[1][job]
    B = JOBS[job][2]
    assert n // B >= 2 and n % B > 1  # full batches to split, and a tail
    for key, v in p0.items():
        np.testing.assert_array_equal(p1[key], v, err_msg=key)
    assert m0 == m1
    assert set(p0) == set(jc)
    for key, jv in jc.items():
        pv = p0[key]
        if key == "rels_seen":  # JAX: a flag; the port: a count
            np.testing.assert_array_equal(pv > 0, jv)
        elif key == "rels_gt":  # the label of every seen hash
            np.testing.assert_array_equal(pv[jc["rels_seen"]],
                                          jv[jc["rels_seen"]])
        elif jv.dtype.kind == "f":
            np.testing.assert_allclose(pv, jv, rtol=2e-6, atol=1e-7,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(pv, jv, err_msg=key)
    assert int(p0["n_batches"]) == n // B + 1
    assert set(m0) == set(jm)
    for key, v in jm.items():
        np.testing.assert_allclose(m0[key], v, rtol=2e-6, atol=1e-7,
                                   err_msg=key)


@pytest.mark.parametrize("world", [2, 3])
def test_rank_blocks_add_up_to_the_whole_sweep(synth_root, world):
    """In one process: the carries of every rank's block (sweep_carry
    with DataMesh(world, r); no group, so nothing is reduced) add up
    counter for counter to the unsharded sweep's, with whole batches per
    block and the tail on the last."""
    cfg, ds = worker.port_setup(synth_root, "int_rel_ch", "test", 4)
    bundle = create_model(cfg, ds.n_classes,
                          n_rels=max(len(ds.rels_list) - 1, 0), seed=1,
                          device="cpu")
    whole = port_packed.sweep_carry(ds, bundle, bundle.model, cfg,
                                    mode="test")
    blocks = [port_packed.sweep_carry(ds, bundle, bundle.model, cfg,
                                      mode="test",
                                      mesh=dist.DataMesh(world, r))
              for r in range(world)]
    n_full = len(ds) // 4
    assert [int(b["n_batches"]) for b in blocks[:-1]] == [
        n_full * (r + 1) // world - n_full * r // world
        for r in range(world - 1)]
    for key, v in whole.items():
        total = sum(b[key] for b in blocks)
        if v.dtype.kind == "f":
            np.testing.assert_allclose(total, v, rtol=2e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(total, v, err_msg=key)


def test_group_plumbing_over_two_ranks(tmp_path):
    """rank / world / all_gather_object inside a spawned group, and
    local_batch: each rank its contiguous half of the rows, the
    batch-level uniq_clip whole."""
    ranks = dist.spawn(worker.group_facts, 2, args=(6, 3),
                       timeout=CLUSTER_TIMEOUT, workdir=str(tmp_path))
    for r, result in enumerate(ranks):
        (rank, world, gathered), rows = result.value
        assert (rank, world, gathered) == (r, 2, [0, 1])
        np.testing.assert_array_equal(rows["labels"], np.arange(3) + 3 * r)
        np.testing.assert_array_equal(
            rows["feat_idx"], np.arange(18).reshape(6, 3)[3 * r:3 * r + 3])
        np.testing.assert_array_equal(rows["uniq_clip"], np.arange(5))
        assert result.launches == {}


def test_a_failing_rank_fails_the_call_with_its_traceback(tmp_path):
    """Rank 1 raises while rank 0 waits in a collective: spawn stops rank
    0 and raises with rank 1's traceback, well inside its time limit."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        dist.spawn(worker.fail_on_rank, 2, args=(1,),
                   timeout=CLUSTER_TIMEOUT, workdir=str(tmp_path))
    assert "fails on purpose" in str(err.value)
    assert "Traceback" in str(err.value)


def test_a_hanging_rank_fails_the_call_at_its_time_limit(tmp_path):
    """Rank 0 returns, rank 1 never does: TimeoutError naming rank 1 (and
    rank 0 too, on a host too loaded to start it within the limit), and
    no process left behind."""
    import multiprocessing

    with pytest.raises(TimeoutError,
                       match=r"ranks \[(0, )?1\] of 2 did not finish "
                             r"within 30 s"):
        dist.spawn(worker.hang_on_rank, 2, args=(1,), timeout=30,
                   workdir=str(tmp_path))
    assert not multiprocessing.active_children()


def test_mesh_refusals_and_slices():
    """A model axis is refused by name, naming its ROADMAP item; a data
    axis must be the group's size; a batch must divide by the data axis;
    the host loop refuses a mesh of several processes."""
    with pytest.raises(NotImplementedError, match=dist.MODEL_AXIS_ITEM):
        dist.make_mesh((2, 2))
    with pytest.raises(ValueError, match="needs 2 processes"):
        dist.make_mesh((2, 1))
    assert dist.make_mesh((1, 1)) == dist.DataMesh(1, 0)
    assert dist.process_local_slice(dist.DataMesh(4, 2), 8) == slice(4, 6)
    with pytest.raises(ValueError, match="does not divide"):
        dist.process_local_slice(dist.DataMesh(2, 0), 7)
    with pytest.raises(ValueError, match="drop --host-eval"):
        evaluate(None, None, None, None, mesh=dist.DataMesh(2, 0))
    assert MESH_HOST_EVAL == ("--mesh only shards the packed eval sweep; "
                              "drop --host-eval")
