"""Rank functions of the port's two-rank CPU tests (tests/test_torch_dist_*.py).

``lirec_tpu_torch.parallel.dist.spawn`` runs them in fresh processes of
the ``spawn`` start method, which import this module by its name: it
imports the port, numpy and torch only, never jax nor the JAX package
(tests/test_torch_imports.py scans it). Each job builds the port's
dataset from a fixture root, loads the weights the test wrote, and
returns host values the test compares with its single-process runs.
"""

import time

import numpy as np
import torch

from lirec_tpu_torch import config as config_lib
from lirec_tpu_torch.data import synthetic
from lirec_tpu_torch.data.dataset import InteractionDataset
from lirec_tpu_torch.evaluation import packed
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.parallel import dist


def port_setup(root, preset, mode, batch_size, **optim):
    """(cfg, dataset) of the port's host tier on a fixture root, f32, with
    the relationships initialised where the preset has them."""
    base = synthetic.make_config(root)
    cfg = config_lib.preset(preset, data_root=root)
    cfg = cfg.replace(dims=base.dims, paths=base.paths).with_runtime(
        compute_dtype="float32").with_optim(batch_size=batch_size, **optim)
    ds = InteractionDataset(cfg, mode=mode)
    ds.cache()
    if cfg.tasks.rels or cfg.tasks.rels_multitask:
        ds.init_relships()
    return cfg, ds


def _bundle(cfg, ds, state_path):
    bundle = create_model(cfg, ds.n_classes,
                          n_rels=max(len(ds.rels_list) - 1, 0), device="cpu")
    bundle.model.load_state_dict(torch.load(state_path))
    return bundle


def eval_rank(root, jobs):
    """Per job {preset, mode, batch_size, state_path, tier}: the sharded
    sweep's all-reduced carry and its metrics, over a data mesh of the
    whole group."""
    mesh = dist.make_mesh((dist.world(), 1))
    out = []
    for job in jobs:
        cfg, ds = port_setup(root, job["preset"], job["mode"],
                             job["batch_size"])
        bundle = _bundle(cfg, ds, job["state_path"])
        carry = packed.sweep_carry(ds, bundle, bundle.model, cfg,
                                   mode=job["mode"], mesh=mesh,
                                   localize_ctx=job["tier"])
        n_hashes = len(getattr(ds, "hashidx_rels", ()) or ())
        metrics = packed.finish_from_carry(carry, cfg.tasks, ds.n_rels,
                                           n_hashes, job["mode"], False)
        out.append((carry, metrics))
    return out


def train_rank(root, jobs):
    """Per job {preset, mode, batch_size, state_path, epochs}: train()
    over a data mesh of the whole group from the given weights, dropout 0,
    lr 1e-3 (the single-process parity test's settings); returns (losses
    per epoch, the final state_dict as numpy)."""
    from lirec_tpu_torch.train.loop import train

    out = []
    for job in jobs:
        cfg, ds = port_setup(root, job["preset"], job["mode"],
                             job["batch_size"], epochs=job["epochs"],
                             save_model=False, lr=1e-3, dropout=0.0)
        bundle = _bundle(cfg, ds, job["state_path"])
        got = train(cfg, bundle, ds, verbose=False,
                    mesh=(dist.world(), 1))
        out.append((got["losses"], {k: v.numpy() for k, v in
                                    bundle.model.state_dict().items()}))
    return out


def fail_on_rank(which):
    """Raise on rank `which`; the other ranks wait at a barrier."""
    if dist.rank() == which:
        raise ValueError("rank %d fails on purpose" % which)
    dist.barrier("after the failure")
    return dist.rank()


def hang_on_rank(which):
    """Rank `which` never returns; the others return at once."""
    while dist.rank() == which:
        time.sleep(1)
    return dist.rank()


def group_facts(n_rows, width):
    """((rank, world, every rank's id through all_gather_object), this
    rank's rows of a global batch of `n_rows` rows (local_batch), whose
    batch-level uniq_clip stays whole)."""
    from lirec_tpu_torch.data.pipeline import local_batch

    batch = {"labels": np.arange(n_rows),
             "feat_idx": np.arange(n_rows * width).reshape(n_rows, width),
             "uniq_clip": np.arange(5)}
    rows = local_batch(batch, dist.make_mesh((dist.world(), 1)))
    return (dist.rank(), dist.world(), dist.all_gather_object(dist.rank())), \
        rows


def world_of_one_steps():
    """In a group of one: three steps of make_train_step and of
    make_dp_train_step from the same weights, dropout on, the last batch
    ragged (padded by both); returns (losses, numpy state_dict) of each,
    DP first."""
    from lirec_tpu_torch.parallel.step import make_dp_train_step
    from lirec_tpu_torch.train.loop import (
        _pad_batch, make_train_step, step_generators,
    )
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.utils.fake_batch import make_batch, make_tables

    cfg = config_lib.preset("int_rel_ch").with_dims(
        text_dim=16, visual_dim=32, joint_dim=16).with_runtime(
        compute_dtype="float32")
    out = []
    for dp in (True, False):
        bundle = create_model(cfg, 9, n_rels=6, seed=4, device="cpu")
        opt = make_optimizer(bundle.model.parameters(), 1e-3, 1e-5)
        if dp:
            step = make_dp_train_step(bundle, opt, dist.make_mesh((1, 1)), 6)
        else:
            step = make_train_step(bundle, opt)
        tables = {k: torch.from_numpy(v) for k, v in make_tables(
            bundle.spec, 24, 40, seed=0).items()}
        losses = []
        for i, n in enumerate((6, 6, 4)):
            batch = make_batch(bundle.spec, n, 24, 40, seed=i)
            if not dp and n != 6:
                batch = _pad_batch(batch, 6)
            losses.append(float(step(batch, tables,
                                     step_generators(0, i, "cpu"))))
        out.append((losses, {k: v.numpy() for k, v in
                             bundle.model.state_dict().items()}))
    return out


def run_entry_outside_a_rank(out_path):
    """What run_entry raises in a multiprocessing child that spawn() did
    not start (an unguarded script re-imported by a worker), written to
    `out_path`."""
    from lirec_tpu_torch.cli.common import run_entry

    try:
        run_entry("int_rel_ch", ["--data-root", "/nonexistent"])
        message = "no error"
    except RuntimeError as err:
        message = str(err)
    with open(out_path, "w") as f:
        f.write(message)


def foreign_modules():
    """The modules of jax, flax, optax, msgpack, the JAX package or the
    repo-root tools/ that this rank process has imported, after importing
    the training CLI's entry and the rank functions."""
    import sys

    import lirec_tpu_torch.cli.train  # noqa: F401

    return sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "msgpack", "lirec_tpu", "tools"))


def loss_cases(B=8, T=5, C=9, R=6, seed=0):
    """[(name, loss fn(outputs, batch, rng), outputs, batch)] on seeded
    inputs: every loss of models/losses.py, a padded tail (loss_weight 0
    on the last 3 rows) where the loss reads one, relationship labels
    'None' (= R) on rows of one half only, and tr_cat_distr sampling."""
    from lirec_tpu_torch.models import losses

    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    weight = t(np.r_[np.ones(B - 3), np.zeros(3)])
    mem = (rng.random((B, T)) < 0.7).astype(np.float32)
    mem[:, :2] = 1.0
    rels_bt = rng.integers(0, R, (B, T))
    rels_bt[1, :] = R
    tracks = dict(labels=t(rng.integers(0, C, B), torch.long),
                  rels_label=t(rels_bt, torch.long), mem_mask=t(mem),
                  gt_tracks=t(np.stack([np.zeros(B), np.ones(B)], 1),
                              torch.long),
                  multilab_weights=t(rng.random((B, C)) < 0.8),
                  loss_weight=weight)
    rels_b = rng.integers(0, R, B)
    rels_b[[0, 2]] = R
    flat = dict(labels=t(rng.integers(0, C, (B, 1)), torch.long),
                rels_label=t(rels_b, torch.long),
                multilab_weights=t(rng.random((B, C)) < 0.8))
    out_bt = {"inters": t(rng.standard_normal((B, T, C))),
              "rels": t(rng.standard_normal((B, T, R)))}
    out_b = {"inters": t(rng.standard_normal((B, 1, C))),
             "rels": t(rng.standard_normal((B, R)))}
    class_w = t(rng.random(C) + 0.5)
    kw = dict(tr_margin=0.4, tr_correct=False, tr_cat_distr=True)
    return [
        ("margin", lambda o, b, g: losses.margin_loss(o, b, rng=g, **kw),
         out_bt, tracks),
        ("margin_track_rels", lambda o, b, g: losses.margin_track_rels_loss(
            o, b, R, lymbda=0.5, rng=g, **kw), out_bt, tracks),
        ("multitask_max_margin", lambda o, b, g:
         losses.multitask_max_margin_loss(o, b, R, margin=0.2, lymbda=0.5),
         out_b, dict(flat, loss_weight=weight)),
        ("multitask_max_margin_unweighted", lambda o, b, g:
         losses.multitask_max_margin_loss(o, b, R, margin=0.2, lymbda=0.5),
         out_b, flat),
        ("max_margin_ce", lambda o, b, g: losses.max_margin_ce_loss(
            o, b, margin=0.2), out_b, dict(flat, loss_weight=weight)),
        ("multitask_ce_class_weights", lambda o, b, g:
         losses.multitask_ce_loss(
             {"inters": o["inters"][:, 0], "rels": o["rels"]},
             dict(b, labels=b["labels"][:, 0]), R, weights=class_w),
         out_b, dict(flat, loss_weight=weight)),
    ]


def loss_shards():
    """Every loss_cases() loss on this rank's rows inside sharded_batch:
    [(name, loss, gradient of the loss with respect to this rank's rows
    of the outputs)]; the sampling draws from a generator seeded 7."""
    from lirec_tpu_torch.data.pipeline import local_batch

    mesh = dist.make_mesh((dist.world(), 1))
    out = []
    for name, fn, outputs, batch in loss_cases():
        rows = dist.process_local_slice(mesh, len(batch["labels"]))
        local = {k: v[rows].clone().requires_grad_(True)
                 for k, v in outputs.items()}
        with dist.sharded_batch(mesh):
            loss = fn(local, local_batch(batch, mesh),
                      torch.Generator().manual_seed(7))
        loss.backward()
        out.append((name, float(loss), grads_of(local)))
    return out


def grads_of(leaves):
    """{name: gradient as numpy} of leaf tensors (zeros where the loss did
    not reach one)."""
    return {k: (np.zeros(v.shape, np.float32) if v.grad is None
                else v.grad.numpy()) for k, v in leaves.items()}


def pool_worker_facts():
    """(the foreign modules of foreign_modules(), CUDA_VISIBLE_DEVICES as
    the process sees it), from inside a data/pipeline.AssemblyPool
    worker, which has unpickled the dataset."""
    import os

    from lirec_tpu_torch.data import pipeline

    assert pipeline._POOL_DATASET is not None
    return foreign_modules(), os.environ.get("CUDA_VISIBLE_DEVICES")


def pool_train_rank(root, state_path, workers):
    """train() over a data mesh of the whole group with `workers` assembly
    workers in this rank (int_rel_ch train split, batch 8, 2 epochs,
    dropout 0, lr 1e-3); returns (losses per epoch, this rank's batch
    assembly decisions)."""
    from lirec_tpu_torch.data.pipeline import ASSEMBLY
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.train.loop import train

    cfg, ds = port_setup(root, "int_rel_ch", "train", 8, epochs=2,
                         save_model=False, lr=1e-3, dropout=0.0)
    bundle = _bundle(cfg, ds, state_path)
    got = train(cfg, bundle, ds, verbose=False, mesh=(dist.world(), 1),
                assembly_workers=workers)
    return got["losses"], dispatch.decisions(ASSEMBLY)
