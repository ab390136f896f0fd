"""Traffic kind ``eval_sweep``: whole-split evaluations, one after another,
as a researcher evaluates a split (every cadence and final eval).

The mix file gives the split's size (``samples``), the batch size, the
locality of its indices (``locality``: harness/split.make_split's
parameters), how long set-up sweeps before the window (``warm_seconds``),
how many sweeps a traced run traces (``trace_sweeps``) and the end-to-end
metric the rate goes to (``rate_metric``). The split, the tables and the
weights are made from the seed; each sweep is one call of the program's
``evaluation/packed.evaluate_packed`` at its defaults (a CUDA graph
replay per full batch, localisation ``auto``), and returns the split's
metrics. The first sweep, which captures the graph, and the sweeps
``warm_seconds`` long after it are set-up: runs of the card read the
first seconds of sweeps slower than the rest.

The rate is the samples of every sweep that the window completed over
the time from the first sweep's start to the last one's end (each sweep
ends with its metrics on the host). Compared with the plain reference
over the same split (``gaps``): every sweep's metrics, the loss
(relative gap) and the top-1 counts (gap in samples); the last sweep's
per-sample outputs, every sample's interaction and relationship scores
as the timed graph's replays made them (harness/program.OutputRecorder),
element by element; and the last sweep's embedded tables, which the
sweep makes with ``models/tabular.embed_all``, element by element.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from harness import faults, flops, program, roofline, weights as wlib
from harness.split import make_split, split_batches

__all__ = ["run", "prepare", "readings", "reference_metrics",
           "gaps", "counts"]

# the model's per-sample output heads that are compared
HEADS = ("inters", "rels")

# the reference's numbers that the sweep's metrics hold as ratios:
# (metric key, counter, denominator counter)
RATIOS = (("ints", "cls_top1", "total_cl"), ("tracks", "trks_top1", "total"),
          ("joint", "top1", "total"), ("rels", "rels_top1", "total"))


class State:
    """A run's inputs and the program's objects."""

    def __init__(self, ctx, seed: int):
        cfg, mix = ctx.cfg, ctx.mix
        dev = self.device = ctx.device
        self.batch_size = mix["batch_size"]
        self.weights = wlib.make_weights(ctx.reference.param_shapes(cfg),
                                         seed, dev)
        self.tables = wlib.make_tables(cfg, seed, dev)
        ctx.note("weights and tables made")
        self.data = make_split(
            seed, mix["samples"], cfg["n_clips"], cfg["n_tracks"],
            cfg["n_classes"], cfg["n_rels"], cfg["rels_n_clips"],
            cfg["n_hypotheses"], context=cfg["ctx"], **mix["locality"])
        ctx.note("split made")
        self.pc, self.bundle = program.build(cfg, self.weights, dev,
                                             self.batch_size)
        ctx.note("model built")
        self.stand_in = program.stand_in(cfg)
        self.recorder = self.record()

    def record(self) -> program.OutputRecorder:
        """A recorder of the sweep's outputs around the program's model (a
        new one makes the sweep capture a graph of its own)."""
        return program.OutputRecorder(
            self.bundle, len(self.data["labels"]) // self.batch_size,
            self.batch_size, self.device)

    def sweep(self, recorder=None) -> Dict[str, float]:
        """One call of the program's sweep over the split; its outputs go
        to `recorder` (the run's own by default)."""
        from lirec_tpu_torch.evaluation.packed import evaluate_packed

        rec = recorder or self.recorder
        rec.reset()
        return evaluate_packed(self.stand_in, rec.bundle, rec.bundle.model,
                               self.pc, mode="test", verbose=False,
                               data=self.data, tables=self.tables)

    def free_program(self) -> None:
        """The program's objects dropped; the recorded outputs kept."""
        self.bundle = self.pc = None
        self.recorder.bundle = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def prepare(ctx, seed: int, warm: bool = True) -> State:
    """Inputs made and the program warmed up: its first sweep, which
    captures the graph, and (`warm`) more sweeps until the mix's
    ``warm_seconds`` have passed since the first ended (so that what the
    first sweep builds and captures shows in set-up whole)."""
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


def reference_metrics(ctx, st: State, quant=None) -> Dict:
    """The plain reference's loss and counters over the split, batched as
    the sweep batches it (the full batches, then the tail), as the sweep's
    metric keys, with its embedded tables and its per-sample outputs
    ({"full": {head: [n_full, B, ...]}, "tail": {head: [n, ...]}})."""
    ref, cfg = ctx.reference, ctx.cfg
    dev = ctx.device
    keys = ("feat_idx", "rels_mask", "labels", "rels_label", "mem_mask",
            "gt_tracks", "just_zeros", "multilab_weights")
    total: Dict[str, int] = {}
    loss_sum, n = 0.0, 0
    full: Dict[str, List[torch.Tensor]] = {}
    tail: Dict[str, torch.Tensor] = {}
    with torch.no_grad(), ref.no_tf32():
        emb = ref.embed_tables(st.weights, cfg, st.tables, quant)
        embedded = {"%s.%s" % (b, name): torch.cat([e[k] for k in ks], -1)
                    for b, e in emb.items()
                    for name, ks in (("clip", ("txt", "vis")),
                                     ("tr1", ("tracks1",)),
                                     ("tr2", ("tracks2",)))}
        for b in split_batches(st.data, st.batch_size):
            b = {k: torch.as_tensor(b[k], device=dev) for k in keys
                 if k in b}
            out = ref.forward_eval(st.weights, cfg, emb, b["feat_idx"],
                                   b.get("rels_mask"), quant)
            loss_sum += float(ref.grounding_loss(out, b, cfg))
            n += 1
            for k, v in ref.counters(out, b, cfg).items():
                total[k] = total.get(k, 0) + v
            heads = {k: out[k] for k in HEADS if out.get(k) is not None}
            if len(b["labels"]) == st.batch_size:
                for k, v in heads.items():
                    full.setdefault(k, []).append(v)
            else:
                tail = heads
    res = {"loss": loss_sum / n, "embedded": embedded,
           "outputs": {"full": {k: torch.stack(v) for k, v in full.items()},
                       "tail": tail}}
    for key, num, den in RATIOS:
        if num in total:
            res[key] = total[num] / total[den]
            res["n_" + key] = total[den]
    return res


def _out_gap(got: Dict, want: Dict) -> float:
    """The widest gap of a per-sample output element, over the largest
    magnitude of that head's reference outputs over the split; infinite
    where the program left a head or a batch out, or shaped it otherwise."""
    worst = 0.0
    for k, w in want["full"].items():
        scale = float(w.abs().max())
        for part in ("full", "tail"):
            if k not in want[part]:
                continue
            g = got[part].get(k)
            if g is None or g.shape != want[part][k].shape:
                return float("inf")
            worst = max(worst, float((g.float() - want[part][k]).abs().max())
                        / scale)
    return worst


def gaps(got: Dict[str, float], want: Dict[str, float]) -> Dict[str, float]:
    """The numbers that can be compared: the loss's relative gap, the
    widest gap of a top-1 count (in samples), the widest gap of a
    per-sample output (``_out_gap``), and the widest gap of an element of
    the embedded tables, over the table's largest element."""
    out = {"loss_gap": abs(got["loss"] - want["loss"]) / abs(want["loss"])}
    out["count_gap"] = max(abs(got[k] - want[k]) * want["n_" + k]
                           for k, _, _ in RATIOS if k in want)
    if "outputs" in got:
        out["out_gap"] = _out_gap(got["outputs"], want["outputs"])
    if "embedded" in got:
        out["emb_gap"] = max(
            float((got["embedded"][k].float() - want["embedded"][k]).abs()
                  .max() / want["embedded"][k].abs().max())
            for k in want["embedded"])
    return out


def _flat_embedded(tree) -> Dict[str, torch.Tensor]:
    """The program's embedded tables ({branch: (clip [txt | vis], tr1,
    tr2)}) as {branch.table: tensor}."""
    return {"%s.%s" % (b, name): t for b, tabs in tree.items()
            for name, t in zip(("clip", "tr1", "tr2"), tabs)}


def counts(ctx, st: State, sweeps: int) -> Dict:
    """The work of `sweeps` sweeps, for the per-layer readers."""
    cfg = ctx.cfg
    batches = split_batches(st.data, st.batch_size)
    out = {"sweeps": sweeps, "batches": sweeps * len(batches),
           "flops": sweeps * flops.eval_sweep_flops(cfg, len(
               st.data["labels"]))}
    rates = roofline.device_peak(ctx.device)
    if cfg["ctx"] and rates is not None:
        j = cfg["joint_dim"]
        widths = (2 * j, j // 2, j // 2)
        dtype = cfg["compute_dtype"]
        out["pool_bound_s"] = sweeps * sum(
            roofline.bound_s(*roofline.pool_need(b["feat_idx"], widths,
                                                 dtype), rates)
            for b in batches)
    return out


def run(ctx) -> Dict:
    from lirec_tpu_torch.utils.graphs import CAPTURE_SECONDS

    before = len(CAPTURE_SECONDS)
    st = prepare(ctx, ctx.seed)
    ctx.setup_done()
    results: List[Dict[str, float]] = []
    n = len(st.data["labels"])
    store: Dict = {}
    with ctx.window(), program.recording_embeddings(store):
        t0 = time.perf_counter()
        while True:
            with ctx.span("bench.sweep"):
                results.append(st.sweep())
            elapsed = time.perf_counter() - t0
            ctx.unit_done(elapsed)
            if (len(results) >= ctx.mix["trace_sweeps"] if ctx.trace
                    else elapsed >= ctx.seconds):
                break
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0
    capture_s = sum(list(CAPTURE_SECONDS)[before:])
    # the last sweep's outputs and embedded tables; every sweep's metrics
    results[-1]["outputs"] = st.recorder.outputs()
    results[-1]["embedded"] = _flat_embedded(store["embedded"])
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


def _fault(st: State, name: str) -> Dict:
    """A sweep of the program with fault `name` planted (its own graph,
    captured with the fault in place): its metrics and outputs; a sweep
    that raises reads as nothing."""
    rec = st.record()
    try:
        with faults.planted("eval_sweep", name):
            got = st.sweep(rec)
    except (ZeroDivisionError, RuntimeError, ValueError) as e:
        return {"raised": repr(e)}
    got["outputs"] = rec.outputs()
    return got


def readings(ctx, seed: int, quant, planted: bool = True
             ) -> Dict[str, Dict[str, float]]:
    """For calibration, on one seed: the numbers of the program (its sweep
    after the warm one), of the control (the reference under `quant` in
    the program's place), and (`planted`) of the program with each fault
    of harness/faults.EVAL planted (a fault whose sweep raises reads
    infinite)."""
    st = prepare(ctx, seed, warm=False)
    with program.recording_embeddings({}) as store:
        got = st.sweep()
    got["outputs"] = st.recorder.outputs()
    got["embedded"] = _flat_embedded(store["embedded"])
    broken = {name: _fault(st, name)
              for name in (faults.EVAL if planted else ())}
    st.free_program()
    want = reference_metrics(ctx, st)
    control = reference_metrics(ctx, st, quant)
    out = {"program": gaps(got, want), "control": gaps(control, want)}
    for name, b in broken.items():
        out[name] = ({k: float("inf") for k in out["program"]}
                     if "raised" in b else gaps(b, want))
    return out
