"""The mesh train step (parallel/step.make_dp_train_step: the flat
gradient buffers and their one all-reduce over the data group) against a
``DistributedDataParallel`` step built here, as the port built its mesh
step before, over gloo ranks on the CPU.

Meshes 1x1, 2x1, 1x2 and 2x2, one cluster of D * M ranks each
(parallel/dist.spawn; the rank function below imports no jax): a narrow
int_rel_ch in f32 with dropout 0.3, three steps of batch 8 (the third
ragged, padded by the step) from the same seeded weights on both sides.
At D <= 2 the two steps are bitwise equal: the reference scales the loss
by D before DDP's mean over D ranks (both exact for D = 2) and a sum of
two terms commutes. Each step's loss and gradient, and the parameters
after the three Adam steps, are held bitwise. Ranks given different
weights hold the data column's first rank's after the step is built (the
broadcast). Over gloo the epoch sweep runs eager steps and records them
("data mesh" / "model mesh"), and ``require_graph=True`` is refused,
naming the backend: gloo runs on the host, and a CUDA graph holds NCCL
calls only. The sweep's graph path itself (this rank's rows staged in a
static stack, read by a device-side step index) runs with the step called
eagerly in place of the capture, bitwise the flat step. The graph over
NCCL runs on the card (tests/test_torch_cuda.py, chip_smoke.py phase
16(a), lirec_tpu_torch/tools/mesh_graph.py on several cards).
"""

import numpy as np
import pytest
import torch

from lirec_tpu_torch import config as port_config
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.parallel import dist
from lirec_tpu_torch.parallel.mesh import gather_grads, make_mesh, shard_model
from lirec_tpu_torch.parallel.step import make_dp_train_step
from lirec_tpu_torch.train.loop import step_generators
from lirec_tpu_torch.train.optim import make_optimizer
from lirec_tpu_torch.utils.fake_batch import make_batch, make_tables

MESHES = ((1, 1), (2, 1), (1, 2), (2, 2))
B, N_CLIPS, N_TRACKS = 8, 64, 96
CLUSTER_TIMEOUT = 300  # seconds for one cluster, start to end


def _cfg():
    return port_config.preset("int_rel_ch").with_dims(
        text_dim=16, visual_dim=32, joint_dim=16).with_runtime(
        compute_dtype="float32").with_optim(batch_size=B, lr=1e-3,
                                            dropout=0.3)


def _model(mesh, seed=0):
    cfg = _cfg()
    bundle = create_model(cfg, 9, n_rels=6, seed=seed, device="cpu")
    opt = make_optimizer(bundle.model.parameters(), cfg.optim.lr,
                         cfg.optim.weight_decay)
    shard_model(bundle.model, mesh, bundle.spec, opt)
    return bundle, opt


def _batches(spec):
    return [make_batch(spec, n, N_CLIPS, N_TRACKS, seed=s)
            for s, n in enumerate((B, B, B - 2))]


class _TrainForward(torch.nn.Module):
    """train/loop.train_loss as a module, so that DDP sees the whole graph
    the gradient flows through."""

    def __init__(self, bundle):
        super().__init__()
        self.model = bundle.model
        self.bundle = bundle

    def forward(self, batch, tables, generators, flag):
        from lirec_tpu_torch.train.loop import train_loss

        return train_loss(self.bundle, batch, tables, generators, flag)


def _ddp_step(bundle, optimizer, mesh):
    """The mesh step as DDP runs it: the loss scaled by the data axis
    before DDP's mean over it."""
    from lirec_tpu_torch.data.pipeline import local_batch
    from lirec_tpu_torch.train.loop import _pad_batch, _to_device

    ddp = torch.nn.parallel.DistributedDataParallel(
        _TrainForward(bundle), process_group=mesh.data_group)

    def step(batch, tables, generators):
        if len(batch["labels"]) != B:
            batch = _pad_batch(batch, B)
        batch = _to_device(local_batch(batch, mesh), "cpu")
        optimizer.zero_grad(set_to_none=True)
        with dist.sharded_batch(mesh):
            loss = ddp(batch, tables, generators, True)
            scaled = loss * mesh.size if mesh.size > 1 else loss
            scaled.backward()
            total = dist.batch_total(loss.detach())
        optimizer.step()
        return total

    return step


def _copy(named):
    return {k: v.detach().clone() for k, v in named}


class _EagerGraph:
    """utils/graphs.StepGraph's interface with the step run eagerly (the
    CPU has no CUDA graphs): one call for the warm-up (the capture runs
    nothing), one per replay. It lets the epoch sweep's graph path, its
    staging of this rank's rows and its device-side step index, run over
    gloo."""

    def __init__(self, step, device, generators=()):
        self.step, self.capture_s = step, 0.0
        step()

    def replay(self):
        self.step()


def mesh_step_rank(shape):
    """One rank of a `shape` mesh: the DDP reference's and the flat
    step's (losses, gradients (gathered over the model group) and
    parameters after each step); the parameters before and after the flat
    step's construction from weights seeded by the rank; the epoch sweep's
    decision and require_graph's refusal; the sweep's graph path with the
    step run eagerly (_EagerGraph)."""
    mesh = make_mesh(shape)
    out = {"place": (mesh.rank, mesh.model_rank)}
    tables = None
    for side in ("ddp", "flat"):
        bundle, opt = _model(mesh)
        if tables is None:
            tables = {k: torch.from_numpy(v) for k, v in make_tables(
                bundle.spec, N_CLIPS, N_TRACKS).items()}
        step = (_ddp_step(bundle, opt, mesh) if side == "ddp"
                else make_dp_train_step(bundle, opt, mesh, B))
        runs = []
        for i, batch in enumerate(_batches(bundle.spec)):
            loss = float(step(batch, tables, step_generators(0, i, "cpu")))
            runs.append((loss, _copy(gather_grads(bundle.model).items()),
                         _copy(bundle.model.named_parameters())))
        out[side] = runs
    bundle, opt = _model(mesh, seed=1 + dist.rank())
    out["before"] = _copy(bundle.model.named_parameters())
    make_dp_train_step(bundle, opt, mesh, B)
    out["after"] = _copy(bundle.model.named_parameters())

    from lirec_tpu_torch.train.sweep import EpochSweep

    bundle, opt = _model(mesh)
    with pytest.raises(ValueError, match="backend is gloo") as refused:
        EpochSweep(bundle, opt, tables, 0, B, mesh=mesh, require_graph=True)
    out["refusal"] = str(refused.value)
    sweep = EpochSweep(bundle, opt, tables, 0, B, mesh=mesh)
    losses = sweep.fetch(sweep.run(_batches(bundle.spec), 0))
    last = dispatch.last_dispatch("train_loop")
    out["sweep"] = (losses, (last["path"], last["reason"]))

    from lirec_tpu_torch.utils import graphs

    bundle, opt = _model(mesh)
    sweep = EpochSweep(bundle, opt, tables, 0, B, mesh=mesh)
    sweep.graph, real = True, graphs.StepGraph
    graphs.StepGraph = _EagerGraph
    try:
        losses = sweep.fetch(sweep.run(_batches(bundle.spec), 0))
    finally:
        graphs.StepGraph = real
    out["graph_path"] = (losses, _copy(bundle.model.named_parameters()))
    return out


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """{shape: every rank's mesh_step_rank}, one cluster per mesh."""
    out = {}
    for shape in MESHES:
        work = tmp_path_factory.mktemp("mesh%dx%d" % shape)
        out[shape] = [r.value for r in dist.spawn(
            mesh_step_rank, int(np.prod(shape)), args=(shape,),
            timeout=CLUSTER_TIMEOUT, workdir=str(work))]
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_step_is_the_ddp_step_bitwise(clusters, shape):
    """Every step's loss and gradient, and the parameters after each Adam
    step, bitwise the DDP reference's on every rank; the losses finite and
    the same on every rank (the global batch's)."""
    for rank in clusters[shape]:
        assert len(rank["flat"]) == 3
        for i, ((l_d, g_d, p_d), (l_f, g_f, p_f)) in enumerate(
                zip(rank["ddp"], rank["flat"])):
            assert np.isfinite(l_f) and l_f == l_d, (i, l_f, l_d)
            assert set(g_f) == set(g_d) == set(p_f)
            for name, g in g_d.items():
                assert torch.equal(g_f[name], g), (i, name)
            for name, p in p_d.items():
                assert torch.equal(p_f[name], p), (i, name)
    losses = [[s[0] for s in rank["flat"]] for rank in clusters[shape]]
    assert all(x == losses[0] for x in losses)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=lambda s: "%dx%d" % s)
def test_construction_broadcasts_the_data_column_first_state(clusters,
                                                             shape):
    """Ranks seeded apart hold, after the step is built, the parameters of
    the first rank of their data column (rank m of column m), which keeps
    its own."""
    ranks = clusters[shape]
    model = shape[1]
    for r, rank in enumerate(ranks):
        src = ranks[r % model]["before"]
        assert any(not torch.equal(src[n], p)
                   for n, p in rank["before"].items()) == (r >= model)
        for name, p in rank["after"].items():
            assert torch.equal(p, src[name]), (r, name)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_gloo_sweep_runs_eager_steps_and_refuses_a_graph(clusters, shape):
    """Over gloo the epoch sweep records "eager" for "data mesh" (M = 1)
    or "model mesh" (M > 1), and takes the per-batch steps' losses;
    require_graph=True raises, naming the backend."""
    want = "model mesh" if shape[1] > 1 else "data mesh"
    for rank in clusters[shape]:
        losses, decision = rank["sweep"]
        assert decision == ("eager", want)
        assert losses == [s[0] for s in rank["flat"]]
        assert "gloo" in rank["refusal"]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_graph_path_steps_this_rank_rows(clusters, shape):
    """The epoch sweep's graph path (its static stack of this rank's rows
    of each batch, read through the device-side step index), with the
    step run eagerly in place of the capture: the losses and the final
    parameters bitwise the flat step's."""
    for rank in clusters[shape]:
        losses, params = rank["graph_path"]
        assert losses == [s[0] for s in rank["flat"]]
        for name, p in rank["flat"][-1][2].items():
            assert torch.equal(params[name], p), name
