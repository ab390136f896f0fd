"""Traffic kind ``train_epochs``: training epochs over one split, as a
researcher trains.

The mix file gives the split's size (``samples``), the batch size, the
locality of its indices (``locality``), how long set-up runs epochs
before the window (``warm_seconds``), how many epochs a traced run
traces (``trace_epochs``) and the end-to-end metric the rate goes to
(``rate_metric``). The split, the tables and the weights are made from the
seed. The split is cut into batches (the last one ragged), localized
together by the program's ``data/localize.Localizer`` as
``train/loop.train`` localizes an epoch, and stepped by the program's
``train/sweep.EpochSweep`` (a CUDA graph replay per step: forward, loss,
backward through the scatter kernel, Adam at the preset's values), each
epoch ending at the sweep's loss read, as ``train()`` drives it.

Set-up builds the one sweep, model and optimizer that the window goes on
with. It runs one whole epoch, which captures the graph that the window
replays, and more for ``warm_seconds`` after it (runs of the card read
the first seconds of epochs slower than the rest); puts the seeded
weights back and Adam's state to its start, in place, in the tensors
that graph reads and writes; and drives the first three steps through
the sweep's own call on three distinct batches of the split: replays of
that same graph (a capture on the way is an error). The window then goes
on from there. The plain reference follows the three steps from the same
weights, with the same dropout draws. Compared (``gaps``): the first
gradient as Adam took it (worked out from Adam's first moment after one
step), against the reference's nearest choice where the weak loss's
positive hypothesis is a near tie (within the reference's
``TIE_WINDOW``, set from the program's own measured rounding of that
choice), and the parameters' change over the three steps, by leaf. The
window's epochs must give finite losses. The rate is the samples of the
epochs that the window completed over their time.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from harness import faults, flops, program, roofline, weights as wlib
from harness.split import make_split, split_batches

__all__ = ["run", "prepare", "reference_steps", "gaps", "step_seed",
           "SEED_STRIDE", "CHECKED_STEPS"]

# the epoch sweep's seed scheme: step i of epoch e draws its dropout masks
# from a generator seeded with the first word of SeedSequence([seed,
# e * SEED_STRIDE + i])
SEED_STRIDE = 100003
# the checked steps: (epoch, the split's batches) of the two calls of the
# sweep that make them, after the warm epoch (epoch 2) and the restart
CHECKED_STEPS = ((0, (0,)), (1, (1, 2)))
WARM_EPOCH = 2
# a leaf whose reference gradient norm is under this share of the median
# leaf's moves by round-off alone under Adam: it is left out of the norms
SMALL_GRAD = 1e-3
# the model's output heads (the reference's layer names)
HEADS = ("out_ints", "out_ctx")


def step_seed(seed: int, epoch: int, i: int) -> int:
    return int(np.random.SeedSequence(
        [seed, epoch * SEED_STRIDE + i]).generate_state(2, np.uint64)[0])


class State:
    def __init__(self, ctx, seed: int):
        cfg, mix = ctx.cfg, ctx.mix
        dev = ctx.device
        self.B = mix["batch_size"]
        self.weights = wlib.make_weights(ctx.reference.param_shapes(cfg),
                                         seed, dev)
        self.tables = wlib.make_tables(cfg, seed, dev)
        ctx.note("weights and tables made")
        self.data = make_split(
            seed, mix["samples"], cfg["n_clips"], cfg["n_tracks"],
            cfg["n_classes"], cfg["n_rels"], cfg["rels_n_clips"],
            cfg["n_hypotheses"], context=cfg["ctx"], **mix["locality"])
        self.batches = split_batches(self.data, self.B)
        ctx.note("split made")
        self.pc, self.bundle = program.build(cfg, self.weights, dev, self.B)
        ctx.note("model built")

        from lirec_tpu_torch.data.localize import Localizer
        from lirec_tpu_torch.train.optim import make_optimizer
        from lirec_tpu_torch.train.sweep import EpochSweep

        localizer = Localizer(self.bundle.spec, cfg["n_clips"],
                              cfg["n_tracks"])
        self.local = localizer.maybe_localize(self.batches)
        self.optimizer = make_optimizer(self.bundle.model.parameters(),
                                        self.pc.optim.lr,
                                        self.pc.optim.weight_decay)
        self.sweep = EpochSweep(self.bundle, self.optimizer, self.tables,
                                seed, self.B)
        ctx.note("epoch localized, tables of %s rows" % str(tuple(
            len(self.local[0][k]) for k in ("uniq_clip", "uniq_track")
            if k in self.local[0])))

    def epoch(self, batches: List[Dict], epoch: int) -> List[float]:
        """One call of the sweep as ``train()`` makes it: the batches'
        indices checked, the steps dispatched, the losses read."""
        from lirec_tpu_torch.train.loop import check_batch

        for b in batches:
            check_batch(b, self.tables)
        return self.sweep.fetch(self.sweep.run(batches, epoch))

    def restart(self) -> None:
        """The seeded weights and Adam's start put back in place, in the
        tensors the sweep's graph reads and writes: the same state as a
        fresh model and optimizer, and the same graph."""
        with torch.no_grad():
            self.bundle.model.load_state_dict(self.weights, strict=True)
            for st in self.optimizer.state.values():
                for v in st.values():
                    if torch.is_tensor(v):
                        v.zero_()

    def checked_steps(self) -> Dict:
        """The first three steps, through the sweep's own call and as
        replays of the graph it already holds: their losses, the first
        gradient as Adam took it, the parameters after the third step
        (device copies)."""
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        names = [n for n, _ in self.bundle.model.named_parameters()]
        params = [p for _, p in self.bundle.model.named_parameters()]
        captures = len(self.sweep.capture_s)
        # every batch of an epoch with a ragged one carries a loss_weight:
        # these do too then, so the sweep stacks the keys the graph has
        weight = ({"loss_weight": np.ones(self.B, np.float32)}
                  if len(self.batches[-1]["labels"]) != self.B else {})
        losses, first = [], None
        for epoch, which in CHECKED_STEPS:
            losses += self.epoch([dict(self.local[i], **weight)
                                  for i in which], epoch)
            if first is None:
                first = {n: self.optimizer.state[p]["exp_avg"].detach()
                         / (1.0 - beta1) for n, p in zip(names, params)}
        if len(self.sweep.capture_s) != captures:
            raise RuntimeError("the checked steps captured a graph of their "
                               "own: they are not the window's replays")
        after = {n: p.detach().clone() for n, p in zip(names, params)}
        return {"losses": losses, "first": first, "after": after}

    def selection(self, batch: Dict) -> torch.Tensor:
        """The program's forward of a raw batch at its current weights,
        without dropout: the outputs the weak loss chooses its positive
        hypothesis from (for the tie window's reading)."""
        with torch.no_grad():
            return self.bundle.apply(self.bundle.model, batch,
                                     tables=self.tables, deterministic=True,
                                     use_tabular=False)

    def free_program(self) -> None:
        self.bundle = self.pc = self.optimizer = self.sweep = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def prepare(ctx, seed: int, probe=None, warm: bool = True):
    """Inputs made, the warm epochs run (the first captures the graph;
    with `warm`, more until the mix's ``warm_seconds`` have passed since
    the first ended, so that what it builds and captures shows in set-up
    whole), the state put back to its start and the checked steps taken.
    `probe(st)`, where given, runs between the restart and the checked
    steps."""
    st = State(ctx, seed)
    with ctx.span("bench.epoch"):
        st.epoch(st.local, WARM_EPOCH)
    ctx.note("first epoch done")
    t0 = time.perf_counter()
    epochs = 0
    while warm and time.perf_counter() - t0 < ctx.mix["warm_seconds"]:
        with ctx.span("bench.epoch"):
            st.epoch(st.local, WARM_EPOCH)
        epochs += 1
    ctx.note("%d warm epochs more done" % epochs)
    st.restart()
    seen = probe(st) if probe is not None else None
    got = st.checked_steps()
    ctx.note("checked steps done")
    return st, got, seen


def reference_steps(ctx, st: State, seed: int, quant=None,
                    rows=slice(None), alter: bool = False,
                    flip_within: float = 0.0) -> Dict:
    """The plain reference's three steps from the same weights, over the
    same batches (their raw indices into the full tables), each drawing
    its dropout masks from the generator the sweep seeds for it. `rows`:
    the rows of each batch it takes (all by default); `alter`: each
    batch's first label altered; `flip_within`: each sample whose
    positive hypothesis wins by less than this takes its second-best (the
    last two: faults' readings)."""
    ref, cfg = ctx.reference, ctx.cfg
    dev = ctx.device
    keys = ("feat_idx", "rels_mask", "labels", "rels_label", "mem_mask",
            "gt_tracks", "multilab_weights")
    batches, gens = [], []
    for epoch, which in CHECKED_STEPS:
        for i, j in enumerate(which):
            b = st.batches[j]
            b = {k: torch.as_tensor(b[k][rows], device=dev) for k in keys
                 if k in b}
            if alter:
                b["labels"] = b["labels"].clone()
                b["labels"][0] = (b["labels"][0] + 1) % cfg["n_classes"]
            batches.append(b)
            gens.append(torch.Generator(device=dev).manual_seed(
                step_seed(seed, epoch, i)))
    return ref.train_steps(st.weights, cfg, st.tables, batches, gens, quant,
                           tie_window=ref.TIE_WINDOW,
                           flip_within=flip_within)


def _leaf_gaps(got: Dict, want: Dict, keep) -> Dict[str, List[float]]:
    """Per kept leaf: the gap between the program's norm and the
    reference's, over the reference's norm of the leaf or of the median
    leaf, whichever is larger ("norm"); one minus the cosine of the two
    ("dir")."""
    norms = {k: float(want[k].norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    out = {"norm": [], "dir": []}
    for k in keep:
        a, b = got[k].double().flatten(), want[k].double().flatten()
        out["norm"].append(abs(float(a.norm()) - norms[k])
                           / max(norms[k], med))
        out["dir"].append(1.0 - float(torch.dot(a, b) / (
            a.norm() * b.norm()).clamp(min=1e-300)))
    return out


def _nearest_first(got: Dict, want: Dict) -> Dict:
    """The reference's first gradient with the choices of its near ties
    (``want["ties"]``: the change where a sample's second-best hypothesis
    is its positive) that bring it nearest the program's, over all
    parameters."""
    base, ties = want["first"], want["ties"]
    if not ties:
        return base
    dot = lambda a, b: sum(float((a[k].double() * b[k].double()).sum())
                           for k in base)  # noqa: E731
    resid = {k: got[k] - base[k] for k in base}
    c = [dot(resid, d) for d in ties]
    gram = [[dot(a, b) for b in ties] for a in ties]
    best, pick = 0.0, ()
    for mask in range(1, 1 << len(ties)):
        s = [i for i in range(len(ties)) if mask >> i & 1]
        cost = sum(gram[i][j] for i in s for j in s) - 2 * sum(c[i]
                                                             for i in s)
        if cost < best:
            best, pick = cost, s
    return {k: base[k] + sum(ties[i][k] for i in pick) for k in base}


def gaps(got: Dict, want: Dict, start: Dict) -> Dict[str, float]:
    """The numbers: the worst step's relative loss gap (read, not
    compared: the weak loss's choice of a positive hypothesis jumps on
    near ties); the first gradient against the nearest choice of the
    reference's near ties, by the worst leaf's norm gap, the median
    leaf's direction gap and the worst direction gap of the output heads'
    leaves (HEADS: the layers the loss reads, whose gradients the
    backward rounds least); the change of the parameters over the steps
    by the worst leaf's norm gap. Leaves whose reference gradient is
    nought to rounding (SMALL_GRAD) are left out."""
    g = {k: float(v.norm()) for k, v in want["first"].items()}
    med = float(np.median(list(g.values())))
    keep = [k for k, v in g.items() if v >= SMALL_GRAD * med]
    first = _nearest_first(got["first"], want)
    grad = _leaf_gaps(got["first"], first, keep)
    heads = _leaf_gaps(got["first"], first,
                       [k for k in keep if k.split(".")[0] in HEADS])
    step = _leaf_gaps({k: got["after"][k] - start[k] for k in keep},
                      {k: want["after"][k] - start[k] for k in keep}, keep)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(
                got["losses"], want["losses"])),
            "near_ties": len(want["ties"]),
            "grad_gap": max(grad["norm"]),
            "grad_dir_med": float(np.median(grad["dir"])),
            "head_dir_gap": max(heads["dir"]),
            "step_gap": max(step["norm"])}


def _checked_batches(ctx, st: State) -> List[Dict]:
    """The checked steps' raw batches as device tensors."""
    return [{k: torch.as_tensor(v, device=ctx.device)
             for k, v in st.batches[j].items() if k != "just_zeros"}
            for _, which in CHECKED_STEPS for j in which]


def _program_selection(ctx, st: State) -> List[torch.Tensor]:
    """The program's selection scores of the checked batches at the seeded
    weights, without dropout (a probe between the restart and the checked
    steps)."""
    ref, cfg = ctx.reference, ctx.cfg
    return [ref.selection_scores(st.selection(b), b, cfg)
            for b in _checked_batches(ctx, st)]


def _selection_error(ctx, st: State, program) -> Dict[str, float]:
    """For the tie window: over the checked batches, without dropout, the
    widest gap of the loss's selection score between the reference at
    float32 and the program (`program`: its scores), the reference with
    bfloat16 products, or with float8 products; and the nearest tie."""
    ref, cfg = ctx.reference, ctx.cfg
    err = {"program": 0.0, "bf16": 0.0, "fp8": 0.0}
    nearest = float("inf")
    with torch.no_grad(), ref.no_tf32():
        for b, prog in zip(_checked_batches(ctx, st), program):
            out = {}
            for tag, quant in (("f32", None), ("bf16", ref.bf16_quant),
                               ("fp8", ref.fp8_quant)):
                o = ref.forward_rows(st.weights, cfg, st.tables,
                                     b["feat_idx"], b.get("rels_mask"),
                                     None, quant)
                out[tag] = ref.selection_scores(o, b, cfg)
            out["program"] = prog.float()
            for tag in err:
                err[tag] = max(err[tag], float(
                    (out[tag] - out["f32"]).abs().max()))
            top = out["f32"].topk(2, dim=1).values
            nearest = min(nearest, float((top[:, 0] - top[:, 1]).min()))
    return {"sel_err_program": err["program"], "sel_err_bf16": err["bf16"],
            "sel_err_fp8": err["fp8"], "nearest_tie": nearest}


def counts(ctx, st: State, epochs: int) -> Dict:
    """The work of `epochs` epochs, for the per-layer readers."""
    cfg = ctx.cfg
    step_flops, bound = 0, 0.0
    rates = roofline.device_peak(ctx.device)
    j = cfg["joint_dim"]
    for raw, loc in zip(st.batches, st.local):
        fi = raw["feat_idx"]
        n = len(raw["labels"])
        step_flops += flops.train_step_flops(
            cfg, n, int(np.unique(fi[..., 0]).size),
            int(np.unique(fi[..., 1:]).size))
        if cfg["ctx"] and rates is not None:
            updates = n * cfg["n_hypotheses"] * cfg["rels_n_clips"]
            # the local tables' rows (the full tables' where the
            # Localizer found localizing unprofitable)
            rows = (len(loc.get("uniq_clip", ())) or cfg["n_clips"],
                    len(loc.get("uniq_track", ())) or cfg["n_tracks"])
            rows += rows[1:]
            bound += roofline.bound_s(*roofline.scatter_need(
                updates, rows, (2 * j, j, j), cfg["compute_dtype"]), rates)
    out = {"epochs": epochs, "steps": epochs * len(st.batches),
           "flops": epochs * step_flops}
    if bound:
        out["scatter_bound_s"] = epochs * bound
    return out


def run(ctx) -> Dict:
    from lirec_tpu_torch.utils.graphs import CAPTURE_SECONDS

    before = len(CAPTURE_SECONDS)
    st, got, _ = prepare(ctx, ctx.seed)
    ctx.setup_done()
    n = len(st.data["labels"])
    losses: List[List[float]] = []
    with ctx.window():
        t0 = time.perf_counter()
        while True:
            with ctx.span("bench.epoch"):
                losses.append(st.epoch(st.local, WARM_EPOCH + 1
                                       + len(losses)))
            elapsed = time.perf_counter() - t0
            ctx.unit_done(elapsed)
            if (len(losses) >= ctx.mix["trace_epochs"] if ctx.trace
                    else elapsed >= ctx.seconds):
                break
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0
    capture_s = sum(list(CAPTURE_SECONDS)[before:])
    st.free_program()
    want = reference_steps(ctx, st, ctx.seed)
    numbers = gaps(got, want, st.weights)
    failed = sum(not np.isfinite(e).all() for e in losses)
    return {"end_to_end": {ctx.mix["rate_metric"]: len(losses) * n
                           / elapsed},
            "attempted": len(losses), "failed": failed,
            "checks": {k: (numbers[k], v) for k, v in ctx.limits.items()},
            "memory_peak_bytes": peak, "capture_s": capture_s,
            "counts": counts(ctx, st, len(losses)) if ctx.trace else {}}


def _fault(ctx, seed: int, name: str) -> Dict:
    """The program's checked steps with fault `name` of harness/faults.TRAIN
    planted (a sweep of its own, built and captured with the fault in
    place)."""
    with faults.planted("train_epochs", name):
        st, got, _ = prepare(ctx, seed, warm=False)
    st.free_program()
    return got


def readings(ctx, seed: int, quant, planted: bool = True
             ) -> Dict[str, Dict[str, float]]:
    """For calibration, on one seed: the program's numbers; the control's
    (the reference under `quant` in the program's place); the faults' in
    the reference put in the program's place: half of each batch left
    out, the mean taken over the rest (the reference over the first half
    of the rows), each batch's first label altered, and each positive
    hypothesis that wins by less than twice the tie window flipped to its
    second-best; the program with each fault of harness/faults.TRAIN
    planted ("planted.<name>", where `planted`); and the state left
    unchanged (the
    program's start in place of its end). With the selection scores'
    rounding by the program, by bfloat16 and by float8 products (the tie
    window's readings)."""
    st, got, program_sel = prepare(ctx, seed, probe=lambda s: (
        _program_selection(ctx, s)), warm=False)
    st.free_program()
    want = reference_steps(ctx, st, seed)
    half = reference_steps(ctx, st, seed, rows=slice(0, st.B // 2))
    unchanged = dict(got, after=st.weights)
    window = ctx.reference.TIE_WINDOW
    out = {"ties": _selection_error(ctx, st, program_sel),
           "program": gaps(got, want, st.weights),
           "unchanged": gaps(unchanged, want, st.weights),
           "control": gaps(reference_steps(ctx, st, seed, quant), want,
                           st.weights),
           "half_batch": gaps(half, want, st.weights),
           "altered": gaps(reference_steps(ctx, st, seed, alter=True), want,
                           st.weights),
           "tie_flip": gaps(reference_steps(ctx, st, seed,
                                            flip_within=2 * window),
                            want, st.weights)}
    for name in faults.TRAIN if planted else ():
        out["planted." + name] = gaps(_fault(ctx, seed, name), want,
                                      st.weights)
    return out
