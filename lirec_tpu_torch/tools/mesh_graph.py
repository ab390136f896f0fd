"""The mesh train step as a CUDA graph over NCCL ranks, one per card.

    python -m lirec_tpu_torch.tools.mesh_graph [--meshes 2x1,1x2,2x2]
                                               [--steps 10]

For each mesh D x M (it needs D * M visible cards): D * M ranks over NCCL
(parallel/dist.spawn), int_rel_ch at its published widths with seeded
weights, split-scale tables (12,288 clip / 24,576 track rows) and
``--steps`` structured B = 64 batches localized together (the
configuration of ``chip_smoke.py`` phase 7), in bf16 and f32 compute.
Each rank takes the steps twice from the same weights: through the epoch
sweep (train/sweep.EpochSweep with ``require_graph=True``: the first step
its warm-up, the step captured once with its collectives, then replayed)
and through the same mesh step run eagerly (parallel/step.
make_dp_train_step). It holds the two runs' losses and parameters bitwise
equal, checks that the sweep recorded "graph" for "cuda: nccl mesh" and
that every loss is finite, and times epochs of graph replays and of the
eager step in turns on the graph's model (ms/step on the host clock,
synchronized). Rank 0's numbers print as one JSON line, ``RESULT {...}``,
after the cards' names and power limits.

Exits 2 where fewer cards are visible than a mesh needs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

N_CLIPS, N_TRACKS, BATCH = 12288, 24576, 64
TURNS = ("eager", "graph", "graph", "eager")
TIMEOUT = 900  # seconds for one mesh's ranks, start to join


def _batches(spec, n):
    from lirec_tpu_torch.data.localize import Localizer
    from lirec_tpu_torch.utils.fake_batch import make_structured_batch

    raw = [make_structured_batch(spec, BATCH, N_CLIPS, N_TRACKS, seed=400 + i)
           for i in range(n)]
    return Localizer(spec, N_CLIPS, N_TRACKS).maybe_localize(raw)


def _model(ccfg, mesh):
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.parallel.mesh import shard_model
    from lirec_tpu_torch.train.optim import make_optimizer

    bundle = create_model(ccfg, 101, n_rels=15, seed=0, device="cuda")
    opt = make_optimizer(bundle.model.parameters(), ccfg.optim.lr,
                         ccfg.optim.weight_decay)
    shard_model(bundle.model, mesh, bundle.spec, opt)
    return bundle, opt


def rank_run(job):
    """One rank of a job["mesh"] mesh: {compute: numbers}."""
    import numpy as np
    import torch

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.parallel import dist
    from lirec_tpu_torch.parallel.step import make_dp_train_step
    from lirec_tpu_torch.train.loop import step_generators
    from lirec_tpu_torch.train.sweep import SEED_STRIDE, EpochSweep
    from lirec_tpu_torch.utils.fake_batch import make_tables

    mesh = dist.make_mesh(tuple(job["mesh"]))
    cfg = config_lib.preset("int_rel_ch")
    out, batches, tables = {}, None, None
    for compute in ("bfloat16", "float32"):
        ccfg = cfg.with_runtime(compute_dtype=compute)
        runs = {}
        for kind in ("eager", "graph"):
            bundle, opt = _model(ccfg, mesh)
            if batches is None:
                batches = _batches(bundle.spec, job["steps"])
                tables = {k: torch.from_numpy(v).cuda() for k, v in
                          make_tables(bundle.spec, N_CLIPS, N_TRACKS,
                                      seed=0).items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            if kind == "graph":
                sweep = EpochSweep(bundle, opt, tables, 0, BATCH, mesh=mesh,
                                   require_graph=True)
                losses = sweep.fetch(sweep.run(batches, 0))
                last = dispatch.last_dispatch("train_loop")
                if (last["path"], last["reason"]) != ("graph",
                                                      "cuda: nccl mesh"):
                    raise RuntimeError("the sweep recorded %s" % last)
            else:
                step = make_dp_train_step(bundle, opt, mesh, BATCH)
                losses = [float(step(b, tables, step_generators(0, i, "cuda")))
                          for i, b in enumerate(batches)]
                del step
            first_s = time.perf_counter() - t
            if not np.all(np.isfinite(losses)):
                raise RuntimeError("%s %s losses %s" % (compute, kind, losses))
            params = {n: p.detach().cpu()
                      for n, p in bundle.model.named_parameters()}
            runs[kind] = (losses, params, first_s)
        (l_e, p_e, s_e), (l_g, p_g, s_g) = runs["eager"], runs["graph"]
        worst = max(float((p_g[n] - p).abs().max()) /
                    (float(p.abs().max()) or 1.0) for n, p in p_e.items())
        bitwise = l_g == l_e and all(torch.equal(p_g[n], p)
                                     for n, p in p_e.items())
        times = {"graph": [], "eager": []}
        for turn, kind in enumerate(TURNS):
            epoch = turn + 1
            torch.cuda.synchronize()
            t = time.perf_counter()
            if kind == "graph":
                got = sweep.fetch(sweep.run(batches, epoch))
            else:
                got = [float(sweep.step(b, tables, step_generators(
                    0, epoch * SEED_STRIDE + i, "cuda")))
                    for i, b in enumerate(batches)]
            times[kind].append((time.perf_counter() - t) * 1e3
                               / len(batches))
            if not np.all(np.isfinite(got)):
                raise RuntimeError("%s %s losses %s" % (compute, kind, got))
        if len(sweep.capture_s) != 1:
            raise RuntimeError("%d captures for one batch shape"
                               % len(sweep.capture_s))
        out[compute] = dict(
            bitwise=bitwise, losses_graph=l_g, losses_eager=l_e,
            worst_param_diff_of_scale=worst,
            graph_ms_per_step=times["graph"],
            eager_ms_per_step=times["eager"],
            capture_ms=sweep.capture_s[0] * 1e3,
            first_epoch_s={"graph": s_g, "eager": s_e})
        del sweep, bundle, opt
        torch.cuda.empty_cache()
    return out


def _shape(text):
    d, m = text.lower().split("x")
    return int(d), int(m)


def main(argv=None) -> int:
    import torch

    from lirec_tpu_torch.parallel import dist

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--meshes", default="2x1,1x2,2x2")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    meshes = [_shape(m) for m in args.meshes.split(",")]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    need = max(d * m for d, m in meshes)
    if cards < need:
        print("mesh_graph: the meshes need %d cards, %d visible"
              % (need, cards), file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        end="", flush=True)
    from lirec_tpu_torch.ops import build

    build.build("scatter_accum")  # the step's one kernel, once for the ranks
    result = {"torch": torch.__version__, "cards": cards, "meshes": {}}
    for d, m in meshes:
        t = time.perf_counter()
        ranks = dist.spawn(rank_run, d * m, devices="cuda", timeout=TIMEOUT,
                           args=({"mesh": (d, m), "steps": args.steps},))
        lead = ranks[0].value
        for r, rank in enumerate(ranks):
            for compute, got in rank.value.items():
                if got["losses_graph"] != lead[compute]["losses_graph"]:
                    raise RuntimeError("%dx%d rank %d %s: losses %s, rank "
                                       "0's %s" % (d, m, r, compute,
                                                   got["losses_graph"],
                                                   lead[compute]
                                                   ["losses_graph"]))
        record = dict(lead, wall_s=time.perf_counter() - t,
                      all_bitwise=all(v["bitwise"] for rank in ranks
                                      for v in rank.value.values()))
        result["meshes"]["%dx%d" % (d, m)] = record
        print("%dx%d: %s" % (d, m, json.dumps(record)), flush=True)
    print("RESULT " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
