"""One rank of the multi-rank checks that chip_smoke.py runs as phases
16(b) (a 2x1 mesh) and 20(a)-(b) (1x2 and 2x2 meshes): ranks share one
card over gloo (NCCL refuses two ranks on one device), started by
``parallel/dist.spawn``, which imports this module in each rank process;
and the means by which the ranks' gradients are held to one process's.

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

Under a model axis (``rank_run`` with ``job["mesh"]`` = (D, M), M > 1)
the whole check runs in the ranks, since no single process can redo the
tensor-parallel arithmetic: each rank cuts the model to its slices
(parallel/mesh.shard_model), keeps a full replica that
parallel/mesh.gather_state fills before every step, and holds each step
against one process's forward and backward on that replica at the same
parameters (``_model_axis_run``). Its own decisions come from the step's
forward run again without gradient under a ``DecisionRecorder(mesh)``,
whose ``gathered()`` puts a decision made on this process's columns
together with its model peers'; ``block_tied_rows`` compares them with
the replica's over the whole batch; the rows of differing decisions have
their share taken out of both gradients (``row_gradient``, through the
sharded model for this rank's side).
"""

from __future__ import annotations

import time
import types
from typing import Dict, List, Optional, Sequence

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["rank_run", "DecisionRecorder", "tied_rows", "block_tied_rows",
           "row_gradient", "context_run"]

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
    float64 sum (every rank)}. `job["mesh"]`: (data, model), the whole
    group as a data axis by default; a model axis above 1 takes
    ``_model_axis_run``. `job["dims"]`: widths other than the preset's
    (with_dims), for a run at a small size."""
    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.evaluation import packed
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.parallel import dist
    from lirec_tpu_torch.parallel.step import make_dp_train_step
    from lirec_tpu_torch.train.loop import step_generators
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.utils.fake_batch import make_tables

    mesh = dist.make_mesh(tuple(job.get("mesh", (dist.world(), 1))))
    if mesh.model > 1:
        return _model_axis_run(job, mesh)
    device = job["device"]
    split = torch.load(job["split"], weights_only=False)
    batches = torch.load(job["batches"], weights_only=False)
    # what evaluate_packed reads of a dataset (dataset.n_rels counts 'None')
    stand_in = types.SimpleNamespace(n_classes=job["n_classes"],
                                     n_rels=job["n_rels"] + 1,
                                     hashidx_rels=None)
    base = config_lib.preset(job["preset"]).with_dims(**job.get("dims", {}))
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
    dim (the element its gradient goes to). `mesh`: the process's place
    on a mesh with a model axis, for ``gathered``."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.calls: List = []

    def gathered(self) -> List:
        """``calls`` at the full width: each call's input all-gathered over
        the model group (every process of it must call this, after the
        same forward); a call whose input is the same on every peer was
        made on a replicated tensor and stays as it is, one whose inputs
        differ was made on this process's columns of a sharded activation
        (always a relu) and becomes the relu of the peers' columns put
        together. Without a model axis, ``calls``."""
        mesh = self.mesh
        if mesh is None or mesh.model == 1:
            return self.calls
        import torch.distributed as td

        out = []
        for kind, dec, x, dim in self.calls:
            parts = [torch.empty_like(x) for _ in range(mesh.model)]
            td.all_gather(parts, x.contiguous(), group=mesh.model_group)
            if all(torch.equal(parts[0], q) for q in parts[1:]):
                out.append((kind, dec, x, dim))
                continue
            if kind != "relu":
                raise ValueError("an %s of a sharded tensor" % kind)
            full = torch.cat(parts, dim=-1)
            out.append((kind, full > 0, full, None))
        return out

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


def block_tied_rows(whole: Sequence, mine: Sequence, n_rows: int,
                    blocks: int, index: int, report: int = 8) -> Dict:
    """``tied_rows`` of a forward over block `index` of `blocks` equal
    row blocks of an `n_rows`-row batch (`mine`), the other blocks taken
    from `whole` itself: the rows of this block whose decisions differ
    from the whole batch's, in the batch's numbering."""
    fill = []
    for b in range(blocks):
        if b == index:
            fill.append(list(mine))
            continue
        calls = []
        for (kind, dec, x, dim), (_, own, _, _) in zip(whole, mine):
            lead = dec.shape[0] if dec.dim() else 0
            if (dec.dim() and lead % n_rows == 0 and own.dim()
                    and own.shape[0] * blocks == lead):
                n = lead // blocks
                dec = dec[b * n:(b + 1) * n]
            calls.append((kind, dec, x, dim))
        fill.append(calls)
    return tied_rows(whole, fill, n_rows, report)


def row_gradient(bundle, batch: Dict, tables, generators, row: int,
                 count: Optional[float] = None,
                 deterministic: bool = True) -> Dict[str, torch.Tensor]:
    """`row`'s share of the gradient of the mean loss over `batch` (device
    tensors), on the host: the gradient of its own loss in the forward
    over the whole of `batch`, divided by `count` (the rows the mean
    divides by; the batch's rows by default). The model's gradients are
    overwritten; a model sharded over a model axis gives them in full
    (parallel/mesh.gather_grads: every process of its model group must
    call this for the same row)."""
    from lirec_tpu_torch.parallel.mesh import gather_grads
    from lirec_tpu_torch.train.loop import train_loss

    n = len(batch["labels"])
    weight = torch.zeros(n, dtype=torch.float32,
                         device=batch["labels"].device)
    weight[row] = 1.0
    if "loss_weight" in batch:
        weight = weight * batch["loss_weight"].float()
    bundle.model.zero_grad(set_to_none=True)
    train_loss(bundle, dict(batch, loss_weight=weight), tables, generators,
               deterministic=deterministic).backward()
    count = float(n if count is None else count)
    return {name: g.detach().cpu() / count
            for name, g in gather_grads(bundle.model).items()}


def _model_axis_run(job: dict, mesh) -> dict:
    """rank_run under a model axis. For each compute dtype of
    `job["computes"]` (default bf16 and f32): the model cut to this
    process's slices, a full replica filled from them; the split's sweep
    on the replica, split over the data axis; then `job["steps"]` steps
    of the batches (dropout on where `job["dropout"]`, which needs a data
    axis of 1), each held against one process's forward and backward on
    the replica at the same parameters. Returns {"carries", "sweep_s" as
    rank_run's, "steps": {compute: [per step: "loss", "loss_one", "ms"
    (the step, synchronized), "raw" and "held" (the largest |gradient -
    one process's| over a tensor's largest |element|, with all rows and
    without the rows of differing decisions), "worst" (the tensor of
    "held"), "differing", "shared",
    "worst_gap", "rows", "ties" (as tied_rows gives them, over the whole
    batch)]}, "replicated": {compute: {name: sha1 of each parameter this
    process holds whole}}, "place": (d, m), "launches": {"sweep", "steps":
    {kernel: launches}}, counted around the sweeps and the steps alone
    (not the one-process comparisons)}."""
    import copy
    import hashlib

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.data.pipeline import local_batch
    from lirec_tpu_torch.evaluation import packed
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.parallel import dist
    from lirec_tpu_torch.parallel.mesh import (
        gather_grads, gather_state, shard_model,
    )
    from lirec_tpu_torch.parallel.step import make_dp_train_step
    from lirec_tpu_torch.train.loop import _to_device, step_generators
    from lirec_tpu_torch.train.loop import train_loss
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.utils.fake_batch import make_tables

    device = job["device"]
    deterministic = not job.get("dropout", False)
    if not deterministic and mesh.size > 1:
        raise ValueError("the held steps take dropout on a data axis of 1 "
                         "only: a row's share is taken outside the step's "
                         "row block, where its masks would differ")
    split = torch.load(job["split"], weights_only=False)
    batches = torch.load(job["batches"], weights_only=False)[:job["steps"]]
    stand_in = types.SimpleNamespace(n_classes=job["n_classes"],
                                     n_rels=job["n_rels"] + 1,
                                     hashidx_rels=None)
    base = config_lib.preset(job["preset"]).with_dims(**job.get("dims", {}))
    out = {"carries": {}, "sweep_s": {}, "steps": {}, "replicated": {},
           "place": (mesh.rank, mesh.model_rank),
           "launches": {"sweep": {}, "steps": {}}}

    def counted(part, fn, *args, **kw):
        before = dispatch.launches()
        value = fn(*args, **kw)
        _sync(device)
        for k, v in dispatch.launches().items():
            if v != before.get(k, 0):
                out["launches"][part][k] = (out["launches"][part].get(k, 0)
                                            + v - before.get(k, 0))
        return value
    tables = dev_tables = None
    for compute in job.get("computes", ("bfloat16", "float32")):
        cfg = base.with_runtime(compute_dtype=compute)
        bundle = create_model(cfg, job["n_classes"], n_rels=job["n_rels"],
                              seed=job["seed"], device=device)
        if tables is None:
            tables = make_tables(bundle.spec, job["n_clips"],
                                 job["n_tracks"], seed=job["seed"])
            dev_tables = {k: torch.from_numpy(v).to(device)
                          for k, v in tables.items()}
        model = bundle.model
        replica = copy.deepcopy(model)
        one = bundle._replace(model=replica)
        optimizer = make_optimizer(model.parameters(), cfg.optim.lr,
                                   cfg.optim.weight_decay)
        shard_model(model, mesh, bundle.spec, optimizer)
        replica.load_state_dict(gather_state(model, mesh)[0])
        dist.barrier("sweep " + compute)
        t0 = time.perf_counter()
        out["carries"][compute] = counted(
            "sweep", packed.sweep_carry, stand_in, bundle, replica,
            cfg.with_optim(batch_size=job["eval_b"]), mode="test",
            data=split, tables=tables, localize_ctx=False, mesh=mesh)
        out["sweep_s"][compute] = time.perf_counter() - t0
        step = make_dp_train_step(bundle, optimizer, mesh, job["train_b"],
                                  deterministic=deterministic)
        params = list(model.parameters())
        held_steps = []
        for i, batch in enumerate(batches):
            def gens():
                return step_generators(job["seed"], i, device)

            n = len(batch["labels"])
            replica.load_state_dict(gather_state(model, mesh)[0])
            whole = _to_device(batch, device)
            mine = _to_device(local_batch(batch, mesh), device)
            replica.zero_grad(set_to_none=True)
            with DecisionRecorder() as rec_one:
                loss_one = train_loss(one, whole, dev_tables, gens(),
                                      deterministic=deterministic)
            loss_one.backward()
            g_one = {k: p.grad.detach().clone()
                     for k, p in replica.named_parameters()}
            # this rank's decisions: the step's forward again, no gradient
            with torch.no_grad(), dist.sharded_batch(mesh), \
                    DecisionRecorder(mesh) as rec:
                train_loss(bundle, mine, dev_tables, gens(),
                           deterministic=deterministic)
            calls = rec.gathered()
            before = [p.detach().clone() for p in params]
            _sync(device)
            t0 = time.perf_counter()
            loss = float(counted("steps", step, batch, dev_tables, gens()))
            ms = (time.perf_counter() - t0) * 1e3
            g_step = gather_grads(model)
            tied = block_tied_rows(rec_one.calls, calls, n, mesh.size,
                                   mesh.rank)
            del rec_one, rec, calls
            corr = {}
            if tied["rows"]:
                # each side's share of those rows, at the step's start
                after = [p.detach().clone() for p in params]
                with torch.no_grad():
                    for p, b in zip(params, before):
                        p.copy_(b)
                lo = mesh.rank * (n // mesh.size)
                for row in tied["rows"]:
                    a = row_gradient(one, whole, dev_tables, gens(), row,
                                     deterministic=deterministic)
                    b = row_gradient(bundle, mine, dev_tables, gens(),
                                     row - lo, count=n,
                                     deterministic=deterministic)
                    for k in a:
                        corr[k] = corr.get(k, 0) + a[k] - b[k]
                with torch.no_grad():
                    for p, b in zip(params, after):
                        p.copy_(b)
            del before
            rows = dist.all_gather_object((corr, tied), mesh.data_group)
            raw = held = 0.0
            worst = None
            for k, g in g_one.items():
                scale = float(g.abs().max()) or 1.0
                diff = (g_step[k] - g).cpu()
                raw = max(raw, float(diff.abs().max()) / scale)
                for c, _ in rows:
                    if k in c:
                        diff = diff + c[k]
                err = float(diff.abs().max()) / scale
                if err >= held:
                    held, worst = err, k
            held_steps.append({
                "loss": loss, "loss_one": float(loss_one.detach()),
                "ms": ms, "raw": raw, "held": held, "worst": worst,
                "differing": sum(t["differing"] for _, t in rows),
                "shared": sum(t["shared"] for _, t in rows),
                "worst_gap": max(t["worst_gap"] for _, t in rows),
                "rows": sorted(r for _, t in rows for r in t["rows"]),
                "ties": [x for _, t in rows for x in t["ties"]][:8]})
            del g_one, g_step, whole, mine
        out["steps"][compute] = held_steps
        full = dict(replica.named_parameters())
        out["replicated"][compute] = {
            k: hashlib.sha1(p.detach().cpu().numpy().tobytes()).hexdigest()
            for k, p in model.named_parameters()
            if p.shape == full[k].shape}
        del bundle, model, replica, one, optimizer, step
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def context_run(job: dict) -> dict:
    """One process of a context group of the whole group (the context
    axis of the eval forward, models/tabular._ctx_branch_context): per
    compute dtype, the model and tables made from `job["seed"]` (as
    rank_run makes them), the tables embedded once, and the forward of
    the host batch at `job["batch"]` (feat_idx, rels_mask) with its ctx
    pool split over the group. Returns {compute: {"inters", "rels"} on
    the host}."""
    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.models.tabular import embed_all
    from lirec_tpu_torch.utils.fake_batch import make_tables

    import torch.distributed as td

    device = job["device"]
    batch = torch.load(job["batch"], weights_only=False)
    base = config_lib.preset(job["preset"]).with_dims(**job.get("dims", {}))
    out = {}
    for compute in ("bfloat16", "float32"):
        bundle = create_model(base.with_runtime(compute_dtype=compute),
                              job["n_classes"], n_rels=job["n_rels"],
                              seed=job["seed"], device=device)
        tables = {k: torch.from_numpy(v).to(device) for k, v in make_tables(
            bundle.spec, job["n_clips"], job["n_tracks"],
            seed=job["seed"]).items()}
        with torch.no_grad():
            emb = embed_all(bundle.model, bundle.spec, tables)
            got = bundle.apply(bundle.model, batch, embedded=emb,
                               context_group=td.group.WORLD)
        out[compute] = {k: v.cpu() for k, v in got.items()}
        del bundle, emb
    return out
