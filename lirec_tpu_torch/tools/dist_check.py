"""One rank of the two-rank data-parallel check that chip_smoke.py runs as
phase 16(b): two ranks share one card over gloo (NCCL refuses two ranks
on one device), started by ``parallel/dist.spawn``, which imports this
module in each rank process.

Each rank sweeps its block of a split's full batches (the last one also
the ragged tail) with the packed eval sweep in bf16 and f32 and all-reduces
the carry (evaluation/packed.sweep_carry over a data mesh), then takes
training steps on its half of every batch (parallel/step.make_dp_train_step,
the deterministic forward, f32), from weights and tables made from the
same seed on every rank. The caller compares the carries with the
single-process sweep's, each step's gradient with the one-process
gradient at the same parameters, and the losses with one process's
steps; the parameters after Adam are reported, not held: Adam turns a
near-zero gradient element into a step of about lr whatever its last
digits, so a few elements of 18.4M part by more than rounding, and the
trajectories by that much after the first step. The rank's launch counts
come back with its result (dist.RankResult).
"""

from __future__ import annotations

import time
import types

__all__ = ["rank_run"]


def rank_run(job: dict) -> dict:
    """`job`: {"split": path of the materialized split (torch.save of a
    dict of numpy arrays), "batches": path of the host train batches,
    "device" (``cuda``: this rank's card; ``cpu`` runs the plain
    versions), "preset", "n_classes", "n_rels", "seed", "n_clips",
    "n_tracks", "eval_b", "train_b"}. Returns {"carries": {compute:
    all-reduced carry}, "sweep_s": {compute: seconds of this rank's
    sweep}, "losses": the global losses of the steps, "before": the
    parameters each step started from and "grads": its all-reduced
    gradients, on the host (rank 0; None elsewhere), "params": the final
    parameters on the host (rank 0; None elsewhere), "params_sum": their
    float64 sum (every rank)}."""
    import torch

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.evaluation import packed
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.parallel import dist
    from lirec_tpu_torch.parallel.step import make_dp_train_step
    from lirec_tpu_torch.train.loop import step_generators
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.utils.fake_batch import make_tables

    mesh = dist.make_mesh((dist.world(), 1))
    device = job["device"]
    split = torch.load(job["split"], weights_only=False)
    batches = torch.load(job["batches"], weights_only=False)
    # what evaluate_packed reads of a dataset (dataset.n_rels counts 'None')
    stand_in = types.SimpleNamespace(n_classes=job["n_classes"],
                                     n_rels=job["n_rels"] + 1,
                                     hashidx_rels=None)
    base = config_lib.preset(job["preset"])
    tables, carries, seconds = None, {}, {}
    for compute in ("bfloat16", "float32"):
        cfg = base.with_optim(batch_size=job["eval_b"]).with_runtime(
            compute_dtype=compute)
        bundle = create_model(cfg, job["n_classes"], n_rels=job["n_rels"],
                              seed=job["seed"], device=device)
        if tables is None:
            tables = make_tables(bundle.spec, job["n_clips"],
                                 job["n_tracks"], seed=job["seed"])
        dist.barrier("sweep " + compute)
        t0 = time.perf_counter()
        carries[compute] = packed.sweep_carry(
            stand_in, bundle, bundle.model, cfg, mode="test", data=split,
            tables=tables, localize_ctx=False, mesh=mesh)
        seconds[compute] = time.perf_counter() - t0
        del bundle
    cfg = base.with_runtime(compute_dtype="float32")
    bundle = create_model(cfg, job["n_classes"], n_rels=job["n_rels"],
                          seed=job["seed"], device=device)
    optimizer = make_optimizer(bundle.model.parameters(), cfg.optim.lr,
                               cfg.optim.weight_decay)
    step = make_dp_train_step(bundle, optimizer, mesh, job["train_b"],
                              deterministic=True)
    dev_tables = {k: torch.from_numpy(v).to(device)
                  for k, v in tables.items()}
    lead = dist.rank() == 0
    losses, before, grads = [], [], []
    for i, batch in enumerate(batches):
        if lead:
            before.append({n: p.detach().to("cpu", copy=True) for n, p in
                           bundle.model.named_parameters()})
        losses.append(float(step(batch, dev_tables,
                                 step_generators(job["seed"], i, device))))
        if lead:
            grads.append({n: p.grad.detach().to("cpu", copy=True)
                          for n, p in bundle.model.named_parameters()})
    params = {n: p.detach().cpu() for n, p in
              bundle.model.named_parameters()}
    return {"carries": carries, "sweep_s": seconds, "losses": losses,
            "before": before if lead else None,
            "grads": grads if lead else None,
            "params": params if lead else None,
            "params_sum": sum(float(p.double().sum())
                              for p in params.values())}
