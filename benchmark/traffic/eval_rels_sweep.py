"""Traffic kind ``eval_rels_sweep``: whole-split evaluations of the joint
interaction and relationship model without the grounding (the int_rels
configuration), one after another, as a researcher evaluates a split.

As ``eval_sweep`` (traffic/eval_sweep.py), whose state, recorder and
output comparison it takes, but the split has relationship hashes
(harness/split_rels.py: the mix's ``hashes`` and ``locality``), and the
stand-in dataset carries them (harness/program_rels.stand_in), so the
program's sweep folds its per-hash score table on the card every batch
and finishes RelationshipsAcc on the host. Each sweep is one call of the
program's ``evaluation/packed.evaluate_packed`` at its defaults (a CUDA
graph replay per full batch, the ragged tail as one eager step).

Compared with the plain reference over the same split (``gaps``): every
sweep's loss (relative gap), interaction top-1/3/5/10 counts (gap in
samples, from the carry the sweep fetched) and relationship top-1/3 counts
over the hashes (gap in hashes, from the RelationshipsAcc it filled); the
last sweep's per-sample interaction and relationship scores as the timed
graph's replays made them, its embedded tables, and its per-hash score
table against the reference's in-order sums (each widest element gap over
the largest reference element).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from harness import (faults, faults_rels, flops, program, program_rels,
                     roofline, weights as wlib)
from harness.cells import BENCH_DIR, load_module
from harness.fold_roofline import fold_need
from harness.split import split_batches
from harness.split_rels import make_rels_split

__all__ = ["run", "prepare", "readings", "reference_metrics", "gaps",
           "counts"]

_BASE = load_module(os.path.join(BENCH_DIR, "traffic", "eval_sweep.py"),
                    "bench_kind_eval_sweep")
# the eval sweep's faults (harness/faults.EVAL) that apply without the
# grounding, beside the fold's own (harness/faults_rels.RELS)
EVAL_FAULTS = ("unchanged", "half_batch", "altered_scores")
KEYS = ("feat_idx", "rels_mask", "labels", "rels_label", "hash_rel",
        "multilab_weights")


class State(_BASE.State):
    """A run's inputs and the program's objects: the split with its hashes
    and the stand-in that carries them."""

    def __init__(self, ctx, seed: int):
        cfg, mix = ctx.cfg, ctx.mix
        dev = self.device = ctx.device
        self.batch_size = mix["batch_size"]
        self.weights = wlib.make_weights(
            ctx.reference.param_shapes(cfg), seed, dev)
        self.tables = wlib.make_tables(cfg, seed, dev)
        ctx.note("weights and tables made")
        self.data, self.n_hashes = make_rels_split(
            seed, mix["samples"], cfg["n_clips"], cfg["n_tracks"],
            cfg["n_classes"], cfg["n_rels"], cfg["rels_n_clips"],
            **mix["hashes"], **mix["locality"])
        ctx.note("split made: %d hashes" % self.n_hashes)
        self.pc, self.bundle = program.build(cfg, self.weights, dev,
                                             self.batch_size)
        if self.pc.optim.margin != cfg["margin"]:
            raise ValueError("preset %r holds margin %r; the configuration "
                             "file says %r" % (cfg["preset"],
                                               self.pc.optim.margin,
                                               cfg["margin"]))
        ctx.note("model built")
        self.stand_in = program_rels.stand_in(cfg, self.n_hashes)
        self.recorder = self.record()


def prepare(ctx, seed: int, warm: bool = True) -> State:
    """Inputs made and the program warmed up, as ``eval_sweep.prepare``."""
    st = State(ctx, seed)
    with ctx.span("bench.sweep"):
        st.sweep()
    ctx.note("first sweep done")
    t0 = time.perf_counter()
    sweeps = 0
    while warm and time.perf_counter() - t0 < ctx.mix["warm_seconds"]:
        with ctx.span("bench.sweep"):
            st.sweep()
        sweeps += 1
    ctx.note("%d warm sweeps more done" % sweeps)
    return st


def _program_counts(metrics: Dict, store: Dict) -> Dict:
    """A sweep's metrics with the counts its finish was given: the carry's
    interaction counters and RelationshipsAcc's hashes and hits."""
    carry, acc = store["carry"], store["rels_acc"]
    out = dict(metrics)
    out["counts"] = {k: int(carry[k]) for k in carry
                     if k.startswith("top") or k == "total"}
    out["counts"].update(rels_top1=round(acc.top1() * acc.total),
                         rels_top3=round(acc.top3() * acc.total),
                         n_hashes=acc.total)
    return out


def reference_metrics(ctx, st: State, quant=None) -> Dict:
    """The plain reference over the split, batched as the sweep batches it:
    its mean loss, counts (interaction top-k, relationship top-1/3 and
    hashes), per-hash sums [n_hashes, n_rels], embedded tables and
    per-sample outputs."""
    ref, cfg = ctx.reference, ctx.cfg
    dev = ctx.device
    total: Dict[str, int] = {}
    loss_sum, n = 0.0, 0
    full: Dict[str, List[torch.Tensor]] = {}
    tail: Dict[str, torch.Tensor] = {}
    probs, hashes, labels = [], [], []
    with torch.no_grad(), ref.no_tf32():
        emb = ref.embed_tables(st.weights, cfg, st.tables, quant)
        embedded = {"%s.%s" % (b, name): torch.cat([e[k] for k in ks], -1)
                    for b, e in emb.items()
                    for name, ks in (("clip", ("txt", "vis")),
                                     ("tr1", ("tracks1",)),
                                     ("tr2", ("tracks2",)))}
        for b in split_batches(st.data, st.batch_size):
            b = {k: torch.as_tensor(b[k], device=dev) for k in KEYS}
            out = ref.forward_eval(st.weights, cfg, emb, b["feat_idx"],
                                   b["rels_mask"], quant)
            loss_sum += float(ref.loss(out, b, cfg))
            n += 1
            for k, v in ref.counters(out, b, cfg).items():
                total[k] = total.get(k, 0) + v
            probs.append(torch.sigmoid(out["rels"].float()))
            hashes.append(b["hash_rel"])
            labels.append(b["rels_label"])
            if len(b["labels"]) == st.batch_size:
                for k in _BASE.HEADS:
                    full.setdefault(k, []).append(out[k])
            else:
                tail = {k: out[k] for k in _BASE.HEADS}
        sums, label, seen = ref.hash_sums(
            torch.cat(probs), torch.cat(hashes), torch.cat(labels),
            st.n_hashes, cfg["n_rels"])
        total.update(ref.rels_counts(sums, label, seen))
    return {"loss": loss_sum / n, "counts": total, "table": sums,
            "embedded": embedded,
            "outputs": {"full": {k: torch.stack(v) for k, v in full.items()},
                        "tail": tail}}


def gaps(got: Dict, want: Dict) -> Dict[str, float]:
    """The numbers that can be compared: the loss's relative gap, the
    widest gap of an interaction top-k count (in samples), the widest gap
    of a relationship count or of the hash count (in hashes), and, where
    `got` has them, the widest gap of a per-sample output, of an element
    of the embedded tables and of an element of the per-hash table (each
    over the largest reference element)."""
    g, w = got["counts"], want["counts"]
    out = {"loss_gap": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
           "count_gap": max(abs(g[k] - w[k]) for k in w
                            if k.startswith("top")),
           "rels_count_gap": max(abs(g[k] - w[k]) for k in
                                 ("rels_top1", "rels_top3", "n_hashes"))}
    if "outputs" in got:
        out["out_gap"] = _BASE._out_gap(got["outputs"], want["outputs"])
    if "embedded" in got:
        out["emb_gap"] = max(
            float((got["embedded"][k].float() - want["embedded"][k]).abs()
                  .max() / want["embedded"][k].abs().max())
            for k in want["embedded"])
    if "table" in got:
        table = got["table"]
        table = (table.cpu() if isinstance(table, torch.Tensor)
                 else torch.as_tensor(np.asarray(table)))
        ref = want["table"].cpu()
        out["table_gap"] = (float((table.float() - ref).abs().max()
                                  / ref.abs().max())
                            if table.shape == ref.shape else float("inf"))
    return out


def counts(ctx, st: State, sweeps: int) -> Dict:
    """The work of `sweeps` sweeps, for the per-layer readers: the model
    FLOPs of the forward without the grounding (one row a sample), the
    context pool's and the fold's least seconds."""
    cfg = ctx.cfg
    batches = split_batches(st.data, st.batch_size)
    n = len(st.data["labels"])
    out = {"sweeps": sweeps, "batches": sweeps * len(batches),
           "flops": sweeps * (flops.embed_flops(cfg)
                              + flops.head_flops(cfg, n))}
    rates = roofline.device_peak(ctx.device)
    if rates is not None:
        j = cfg["joint_dim"]
        widths = (2 * j, j // 2, j // 2)
        dtype = cfg["compute_dtype"]
        out["pool_bound_s"] = sweeps * sum(
            roofline.bound_s(*roofline.pool_need(b["feat_idx"][:, None],
                                                 widths, dtype), rates)
            for b in batches)
        out["fold_bound_s"] = sweeps * sum(
            roofline.bound_s(*fold_need(b["hash_rel"], b["rels_label"],
                                        st.n_hashes, cfg["n_rels"],
                                        cfg["n_rels"]), rates)
            for b in batches)
    return out


def run(ctx) -> Dict:
    from lirec_tpu_torch.utils.graphs import CAPTURE_SECONDS

    before = len(CAPTURE_SECONDS)
    st = prepare(ctx, ctx.seed)
    ctx.setup_done()
    results: List[Dict] = []
    n = len(st.data["labels"])
    store: Dict = {}
    with ctx.window(), program.recording_embeddings(store), \
            program_rels.recording_finish(store):
        t0 = time.perf_counter()
        while True:
            with ctx.span("bench.sweep"):
                results.append(_program_counts(st.sweep(), store))
            elapsed = time.perf_counter() - t0
            ctx.unit_done(elapsed)
            if (len(results) >= ctx.mix["trace_sweeps"] if ctx.trace
                    else elapsed >= ctx.seconds):
                break
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0
    capture_s = sum(list(CAPTURE_SECONDS)[before:])
    # the last sweep's outputs, embedded tables and per-hash table
    results[-1]["outputs"] = st.recorder.outputs()
    results[-1]["embedded"] = _BASE._flat_embedded(store["embedded"])
    results[-1]["table"] = store["carry"]["rels_table"][:st.n_hashes]
    st.free_program()
    want = reference_metrics(ctx, st)
    per_sweep = [gaps(r, want) for r in results]
    checks = {k: (max(g[k] for g in per_sweep if k in g), lim)
              for k, lim in ctx.limits.items()}
    failed = sum(any(not g[k] <= lim for k, lim in ctx.limits.items()
                     if k in g) for g in per_sweep)
    return {"end_to_end": {ctx.mix["rate_metric"]: len(results) * n
                           / elapsed},
            "attempted": len(results), "failed": failed, "checks": checks,
            "memory_peak_bytes": peak, "capture_s": capture_s,
            "counts": counts(ctx, st, len(results)) if ctx.trace else {}}


def _sweep(st: State, recorder=None) -> Dict:
    """One sweep with its finish recorded: its metrics and counts, its
    outputs, embedded tables and per-hash table."""
    store: Dict = {}
    rec = recorder or st.recorder
    with program.recording_embeddings(store), \
            program_rels.recording_finish(store):
        got = _program_counts(st.sweep(rec), store)
    got["outputs"] = rec.outputs()
    got["embedded"] = _BASE._flat_embedded(store["embedded"])
    got["table"] = store["carry"]["rels_table"][:st.n_hashes]
    return got


def _fault(st: State, name: str) -> Dict:
    """A sweep of the program with fault `name` planted (its own graph,
    captured with the fault in place); a sweep that raises reads as
    nothing."""
    plant = (faults_rels.planted(name) if name in faults_rels.RELS
             else faults.planted("eval_sweep", name))
    try:
        with plant:
            return _sweep(st, st.record())
    except (ZeroDivisionError, RuntimeError, ValueError, KeyError) as e:
        return {"raised": repr(e)}


def readings(ctx, seed: int, quant, planted: bool = True
             ) -> Dict[str, Dict[str, float]]:
    """For calibration, on one seed: the numbers of the program (its first
    sweep after the warm one), of the control (the reference under
    `quant` in the program's place), and (`planted`) of the program with
    each fault planted (a fault whose sweep raises reads infinite)."""
    st = prepare(ctx, seed, warm=False)
    got = _sweep(st)
    names = EVAL_FAULTS + tuple(faults_rels.RELS) if planted else ()
    broken = {name: _fault(st, name) for name in names}
    st.free_program()
    want = reference_metrics(ctx, st)
    control = reference_metrics(ctx, st, quant)
    out = {"program": gaps(got, want), "control": gaps(control, want)}
    for name, b in broken.items():
        out[name] = ({k: float("inf") for k in out["program"]}
                     if "raised" in b else gaps(b, want))
    return out
