"""The context mesh axis of the port's eval forward (``apply_model(...,
context_group=)``, models/tabular._ctx_branch_context) over two gloo
processes on the CPU, against the JAX package's ``context_axis`` forward.

The setup of tests/test_parallel.py's sequence-parallel test: int_rel_ch
at text 16 / visual 32 / joint 16, tables of 32 clips and 48 tracks (seed
9), a batch of 8 samples, 20 hypotheses and R = 18 context slots (seed
10), the JAX package's weights. The JAX side shards the gathered context
rows over a ("data", "context") mesh of 4 x 2 XLA CPU devices; the port's
two processes each pool a block of 9 slots (the masked-sum kernel's plain
version on the CPU), all-reduce the sums and the mask counts, and divide.
``inters`` and ``rels`` are held at rtol 1e-5 / atol 1e-6 in f32 and at
4.1e-3 in bf16 (the parity contract of the eval forward), and to the
port's own one-process forward at the same tolerances.
"""

import numpy as np
import pytest
import torch

from lirec_tpu_torch import config as port_config
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.parallel import dist

CLUSTER_TIMEOUT = 120  # seconds for the two ranks, start to end
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=4.1e-3, atol=4.1e-3)}


def _port_cfg(compute):
    return port_config.preset("int_rel_ch", data_root="/tmp/x").with_dims(
        text_dim=16, visual_dim=32, joint_dim=16).with_runtime(
        compute_dtype=compute)


def context_rank(state, batch, tables):
    """One process of a context group of the whole world: the eval
    forward of `batch` with its context pool split over the group, per
    compute dtype, and which block of slots this process pooled (the
    masked-sum wrapper's recorded shapes)."""
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES

    name = KERNEL_NAMES[("gather_masked_sum", torch.float32)]
    group = torch.distributed.group.WORLD
    t = {k: torch.from_numpy(v) for k, v in tables.items()}
    out = {}
    for compute in TOL:
        bundle = create_model(_port_cfg(compute), 11, n_rels=6,
                              device="cpu")
        bundle.model.load_state_dict(state)
        with torch.no_grad():
            got = bundle.apply(bundle.model, batch, tables=t,
                               context_group=group)
        out[compute] = {k: v.numpy() for k, v in got.items()}
    out["block"] = dispatch.last_dispatch(name)["shapes"]["idx"]
    out["pools"] = dispatch.decisions(name)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's plain and context-axis forwards per compute
    dtype, the port's one-process forward, and the two ranks'."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from lirec_tpu import config as config_lib
    from lirec_tpu.models.factory import create_model as jax_create_model
    from lirec_tpu.utils.fake_batch import make_batch, make_tables
    from lirec_tpu_torch.checkpoint import params_from_jax

    out = {"jax": {}, "single": {}}
    base = config_lib.preset("int_rel_ch", data_root="/tmp/x").with_dims(
        text_dim=16, visual_dim=32, joint_dim=16)
    state = tables = batch = None
    for compute in TOL:
        bundle = jax_create_model(base.with_runtime(compute_dtype=compute),
                                  11, n_rels=6)
        if state is None:
            tables = make_tables(bundle.spec, 32, 48, seed=9)
            full = make_batch(bundle.spec, 8, 32, 48, seed=10)
            batch = {k: full[k] for k in ("feat_idx", "rels_mask")}
            state = params_from_jax(jax.tree.map(np.asarray, bundle.params))
        jt = {k: jnp.asarray(v) for k, v in tables.items()}
        devices = np.asarray(jax.devices()[:8]).reshape(4, 2)
        mesh = Mesh(devices, ("data", "context"))
        with jax.set_mesh(mesh):
            f = jax.device_put(batch["feat_idx"], NamedSharding(mesh,
                                                                P("data")))
            m = jax.device_put(batch["rels_mask"], NamedSharding(mesh,
                                                                 P("data")))
            sharded = jax.jit(lambda p, f, m, t: bundle.apply(
                p, {"feat_idx": f, "rels_mask": m}, tables=t,
                context_axis="context"))(bundle.params, f, m, jt)
        out["jax"][compute] = {k: np.asarray(v) for k, v in sharded.items()}
        pb = create_model(_port_cfg(compute), 11, n_rels=6, device="cpu")
        pb.model.load_state_dict(state)
        with torch.no_grad():
            got = pb.apply(pb.model, batch, tables={
                k: torch.from_numpy(v) for k, v in tables.items()})
        out["single"][compute] = {k: v.numpy() for k, v in got.items()}
    assert batch["feat_idx"].shape[-2] == 19  # the GT slot and R = 18
    work = tmp_path_factory.mktemp("context_axis")
    out["ranks"] = [r.value for r in dist.spawn(
        context_rank, 2, args=(state, batch, tables),
        timeout=CLUSTER_TIMEOUT, workdir=str(work))]
    return out


@pytest.mark.parametrize("compute", list(TOL))
def test_context_forward_matches_jax_context_axis(runs, compute):
    """Both ranks' inters and rels against the JAX package's context-axis
    forward, within the parity contract of `compute`."""
    for rank in runs["ranks"]:
        for key in ("inters", "rels"):
            np.testing.assert_allclose(rank[compute][key],
                                       runs["jax"][compute][key],
                                       err_msg=key, **TOL[compute])


@pytest.mark.parametrize("compute", list(TOL))
def test_context_forward_matches_one_process(runs, compute):
    """Both ranks' outputs equal each other bit for bit, and the port's
    one-process forward within the parity contract; each rank pooled
    its own block of 9 of the 18 slots."""
    ranks = runs["ranks"]
    for key in ("inters", "rels"):
        np.testing.assert_array_equal(ranks[0][compute][key],
                                      ranks[1][compute][key])
        np.testing.assert_allclose(ranks[0][compute][key],
                                   runs["single"][compute][key],
                                   err_msg=key, **TOL[compute])
    for rank in ranks:
        # three tables per forward, a bf16 table read as f32
        assert rank["pools"] == {"reference": 6}
        assert tuple(rank["block"]) == (8 * 20, 9)
