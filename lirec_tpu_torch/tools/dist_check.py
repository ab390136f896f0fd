"""One rank of the two-rank data-parallel check that chip_smoke.py runs as
phase 16(b): two ranks share one card over gloo (NCCL refuses two ranks
on one device), started by ``parallel/dist.spawn``, which imports this
module in each rank process; and the means by which the caller holds the
ranks' gradients to one process's.

Each rank sweeps its block of a split's full batches (the last one also
the ragged tail) with the packed eval sweep in bf16 and f32 and all-reduces
the carry (evaluation/packed.sweep_carry over a data mesh), then takes
training steps on its half of every batch (parallel/step.make_dp_train_step,
the deterministic forward, f32, the product's Adam: capturable on a card),
from weights and tables made from the same seed on every rank. The caller
compares the carries with the single-process sweep's, each step's
gradient with the one-process gradient at the same parameters, and the
losses with one process's steps; the parameters after Adam are reported,
not held: Adam turns a near-zero gradient element into a step of about lr
whatever its last digits, so a few elements of 18.4M part by more than
rounding, and the trajectories by that much after the first step. The
rank's launch counts come back with its result (dist.RankResult).

A rank's forward over its half of a batch and one process's over the
whole batch round apart in the last digits (their GEMMs differ in M), so
where one of the forward's decisions sits within rounding of a tie (a
relu's input at zero, or two candidates of an argmax or amax) the two
sides can take different branches, and that row's gradient differs by
more than rounding. ``DecisionRecorder`` records every such decision of a
forward; ``tied_rows`` compares the whole batch's with its halves' and
names the rows whose decisions differ, with the gap of each; and
``row_gradient`` gives one row's share of the gradient, so that the caller
can hold the two gradients with those rows taken out of both, and count
them.
"""

from __future__ import annotations

import time
import types
from typing import Dict, List, Optional, Sequence

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["rank_run", "DecisionRecorder", "tied_rows", "row_gradient"]

# the functions whose result is a branch taken on the values of their input
_DECIDING = {"relu": "relu", "argmax": "argmax", "amax": "amax"}


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


class DecisionRecorder(TorchFunctionMode):
    """Within: every ``relu``, ``argmax`` and ``amax`` call in order, as
    ``calls``: (kind, decision, input, dim). A relu's decision is
    ``input > 0``; an argmax's its result; an amax's the argmax along its
    dim (the element its gradient goes to)."""

    def __init__(self):
        super().__init__()
        self.calls: List = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _DECIDING.get(getattr(func, "__name__", ""))
        if kind is not None:
            x = args[0].detach()
            if kind == "relu":
                self.calls.append((kind, x > 0, x.float(), None))
            else:
                dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
                idx = out if kind == "argmax" else x.argmax(dim=dim)
                self.calls.append((kind, idx.detach(), x.float(), dim))
        return out


def _gap(kind, x, pos, dim, mine, theirs):
    """How far the decision at `pos` of input `x` is from a tie, relative
    to the largest finite |x|: a relu's |input|; for an argmax / amax the
    difference of the two chosen candidates' values."""
    finite = x[torch.isfinite(x)]
    scale = float(finite.abs().max()) if finite.numel() else 1.0
    scale = scale or 1.0
    if kind == "relu":
        return float(x[pos].abs()) / scale
    if dim is None:  # an argmax of the flattened input
        a, b = x.reshape(-1)[int(mine)], x.reshape(-1)[int(theirs)]
    else:
        dim %= x.dim()
        a = x[pos[:dim] + (int(mine),) + pos[dim:]]
        b = x[pos[:dim] + (int(theirs),) + pos[dim:]]
    return float((a - b).abs()) / scale


def tied_rows(whole: Sequence, blocks: Sequence[Sequence], n_rows: int,
              report: int = 8) -> Dict:
    """Compare the decisions (``DecisionRecorder.calls``) of a forward over
    a batch of `n_rows` rows with those of forwards over its contiguous
    blocks of rows, in order. A call whose tensors have the batch rows on
    their leading axis (``n_rows`` times some count of rows each) is
    compared row for row; one whose tensors are the same in every forward
    (batch-level) as a whole. Returns {"rows": sorted batch rows with a
    differing decision, "shared": differing decisions no row owns,
    "differing": their count, "worst_gap": the largest gap of a differing
    decision from its tie (relative to its input's scale), "ties": the
    first `report` of them as (kind, call index, shape, row, gap)}."""
    if any(len(b) != len(whole) for b in blocks):
        raise ValueError("the forwards made %d and %s decisions" % (
            len(whole), [len(b) for b in blocks]))
    rows, ties, shared, differing, worst = set(), [], 0, 0, 0.0
    for k, (kind, dec, x, dim) in enumerate(whole):
        parts = [b[k] for b in blocks]
        if any(p[0] != kind for p in parts):
            raise ValueError("decision %d: %s against %s" % (
                k, kind, [p[0] for p in parts]))
        lead = dec.shape[0] if dec.dim() else 0
        stacked = (dec.dim() and lead % n_rows == 0
                   and sum(p[1].shape[0] for p in parts) == lead
                   and all(p[1].shape[1:] == dec.shape[1:] for p in parts))
        if stacked:
            pairs = [(torch.cat([p[1] for p in parts]), None)]
        elif all(p[1].shape == dec.shape for p in parts):
            pairs = [(p[1], None) for p in parts]
        else:
            raise ValueError("decision %d (%s): shapes %s against %s" % (
                k, kind, tuple(dec.shape),
                [tuple(p[1].shape) for p in parts]))
        for theirs, _ in pairs:
            for pos in (dec != theirs).nonzero().tolist():
                pos = tuple(pos)
                gap = _gap(kind, x, pos, dim, dec[pos], theirs[pos])
                differing += 1
                worst = max(worst, gap)
                row = None
                if stacked:
                    row = pos[0] // (lead // n_rows)
                    rows.add(row)
                else:
                    shared += 1
                if len(ties) < report:
                    ties.append((kind, k, tuple(dec.shape), row, gap))
    return {"rows": sorted(rows), "shared": shared, "differing": differing,
            "worst_gap": worst, "ties": ties}


def row_gradient(bundle, batch: Dict, tables, generators, row: int,
                 count: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """`row`'s share of the gradient of the mean loss over `batch` (device
    tensors), on the host: the gradient of its own loss in the forward
    over the whole of `batch`, divided by `count` (the rows the mean
    divides by; the batch's rows by default). Deterministic forward; the
    model's gradients are overwritten."""
    from lirec_tpu_torch.train.loop import train_loss

    n = len(batch["labels"])
    weight = torch.zeros(n, dtype=torch.float32,
                         device=batch["labels"].device)
    weight[row] = 1.0
    if "loss_weight" in batch:
        weight = weight * batch["loss_weight"].float()
    bundle.model.zero_grad(set_to_none=True)
    train_loss(bundle, dict(batch, loss_weight=weight), tables, generators,
               deterministic=True).backward()
    count = float(n if count is None else count)
    return {name: p.grad.detach().cpu() / count
            for name, p in bundle.model.named_parameters()}
