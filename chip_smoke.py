#!/usr/bin/env python3
"""Drive the PyTorch port (lirec_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the versions.
2. Builds every CUDA kernel from csrc/ with nvcc, one process per source,
   all started together.
3. Holds each kernel against its plain PyTorch version on the card, at the
   serve path's shapes (M = 64 x 20 pooled rows, R = 18, clip 12,288 x 1024
   and track 24,576 x 256 embedded rows) and at 4x the rows, in float32 and
   bfloat16 tables, with and without the zero-divider guard; prints the
   differences and the median kernel and plain times.
4. Serves the int_rel_ch preset at its published widths (text 768, visual
   and track 2048, joint 512, 101 interaction classes, 15 relationship
   heads) with seeded random weights on 12,288 / 24,576-row tables, in
   bfloat16 and in float32 compute, through the HTTP server; posts
   /predict at B = 1, 7 and 64, checks every answer, checks that each
   forward launched the pool kernel exactly once, and holds the logits
   against the same forward with the plain pool.
5. Builds a server through the CLI's own ``build_engine_from_args`` on a
   synthetic MovieGraphs fixture and answers one /predict.
6. Holds the scatter-accumulate kernel (the train step's gather_h1
   backward) against its plain version on the card and against the
   in-order sum on the CPU, at the train step's shapes (idx [1280, 18, 3],
   updates 1024 / 512 wide) into split-scale tables (12,288 / 24,576 rows)
   and into the Localizer's batch-local tables, with structured indices and
   with every update sent to 8 rows, f32 and bf16 updates, three tables,
   flattened and single-table; checks that two launches are bit-identical;
   prints median times (L2 flushed), the sort apart from the kernel.
7. Trains int_rel_ch at its published widths on split-scale tables, B = 64
   structured batches through the port's Localizer, in bf16 and f32
   compute: holds one step's gradients against the same step with the
   plain scatter, then runs 10 steps, checks every loss finite, every
   parameter moved and one scatter launch per step, and prints the median
   ms/step and clips/s.
8. Runs the port's train() on a synthetic MovieGraphs fixture on the card:
   2 epochs at batch 8 (the last batch of 6 is padded with loss_weight 0).

Every failure raises. There is no CPU path: without a CUDA device the
script exits 2. Its last line is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists each kernel with its launch count, error and
times.
"""

import json
import os
import statistics
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager
from http.server import ThreadingHTTPServer

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

B_SIZES = (1, 7, 64)
N_CLIPS, N_TRACKS = 12288, 24576  # split-scale tables (ROADMAP.md)
GIANT = 4  # giant tables: 4x the rows, past the TPU's VMEM-resident tier
TOPK = 5
CU = "lirec_tpu_torch/csrc/fused_ctx_pool.cu"
TPU_SRC = "lirec_tpu/ops/gather_pool.py"
SCATTER_CU = "lirec_tpu_torch/csrc/scatter_accum.cu"
SCATTER_TPU_SRC = "lirec_tpu/ops/scatter_accum.py"
TRAIN_B, TRAIN_STEPS = 64, 10


def log(*args):
    print(*args, flush=True)


class Failure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise Failure(msg)


# ------------------------------------------------------------------ card


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0]


# --------------------------------------------------------------- kernels


def median_ms(torch, fn, reps=15):
    """Median of CUDA-event times of single launches, the L2 cache flushed
    (a 64 MiB write) before each one, so rows are read from HBM as a new
    request would."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pool_inputs(torch, n_clips, n_tracks, dtype, seed, M=64 * 20, R=18,
                d_clip=1024, d_tr=256):
    from lirec_tpu_torch.models.tabular import EmbeddedTables

    g = torch.Generator(device="cuda").manual_seed(seed)

    def table(n, d):
        return torch.randn(n, d, device="cuda", generator=g).to(dtype)

    emb = EmbeddedTables(table(n_clips, d_clip), table(n_tracks, d_tr),
                         table(n_tracks, d_tr))
    idx = torch.stack(
        [torch.randint(0, n, (M, R), device="cuda", generator=g)
         for n in (n_clips, n_tracks, n_tracks)], dim=-1,
    ).to(torch.int32).contiguous()
    mask = (torch.rand(M, R, device="cuda", generator=g) < 0.5).float()
    mask[5:, 0] = 1.0
    mask[:5] = 0.0  # only these rows lack context: the zero-divider guard
    return emb, idx, mask


def pool_case(torch, label, emb, idx, mask, guard, atol):
    """Kernel vs plain version on the same inputs; returns max |diff|."""
    from lirec_tpu_torch.ops.gather_pool import (
        fused_ctx_pool, fused_ctx_pool_reference,
    )

    got = fused_ctx_pool(emb, idx, mask, guard)
    torch.cuda.synchronize()
    want = fused_ctx_pool_reference(emb, idx, mask, guard)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == torch.float32,
          "%s: kernel output %s %s" % (label, tuple(got.shape), got.dtype))
    nan = want.isnan()
    check(torch.equal(got.isnan(), nan), "%s: NaN positions differ" % label)
    # rows without context: 0 under the guard, NaN (0/0) without it
    if guard:
        check(bool((got[:5] == 0).all()), "%s: guarded empty rows" % label)
    else:
        check(bool(nan[:5].all()) and not bool(nan[5:].any()),
              "%s: unguarded empty rows must be NaN, and only they" % label)
    err = float((got - want).abs()[~nan].max())
    log("  %-34s max|diff| %.3e (atol %.0e)" % (label, err, atol))
    check(err <= atol, "%s: kernel disagrees with the plain version" % label)
    return err


def kernel_checks(torch):
    """Phase 3. Returns {entry: {max_abs_err, ms, plain_ms}}."""
    from lirec_tpu_torch.ops.gather_pool import (
        fused_ctx_pool, fused_ctx_pool_reference,
    )

    # f32 tables: one-ulp differences from 1/div vs divide and sum order;
    # bf16 tables: the same bf16 values on both sides, f32 sums
    atol = {torch.float32: 2e-6, torch.bfloat16: 1e-5}
    results = {}
    for key, rows, dtypes in (
        ("split_f32", 1, (torch.float32,)),
        ("split_bf16", 1, (torch.bfloat16,)),
        ("giant", GIANT, (torch.float32, torch.bfloat16)),
    ):
        errs = []
        timed = None
        for dtype in dtypes:
            emb, idx, mask = pool_inputs(torch, N_CLIPS * rows,
                                         N_TRACKS * rows, dtype, seed=rows)
            name = "%s %dx%d rows %s" % (key, N_CLIPS * rows,
                                         N_TRACKS * rows,
                                         str(dtype).split(".")[1])
            for guard in (True, False):
                errs.append(pool_case(
                    torch, "%s guard=%s" % (name, guard), emb, idx, mask,
                    guard, atol[dtype],
                ))
            if timed is None:
                ms = median_ms(torch, lambda: fused_ctx_pool(
                    emb, idx, mask, True))
                plain = median_ms(torch, lambda: fused_ctx_pool_reference(
                    emb, idx, mask, True))
                log("  %-34s kernel %.4f ms, plain %.4f ms (median, M=%d)"
                    % (name, ms, plain, idx.shape[0]))
                timed = (ms, plain)
            del emb, idx, mask
        results[key] = {"max_abs_err": max(errs), "ms": timed[0],
                        "plain_ms": timed[1]}
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------ main path


@contextmanager
def serving(engine):
    from lirec_tpu_torch.cli.serve import make_handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield "http://127.0.0.1:%d" % httpd.server_port
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def http(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def samples_of(batch):
    return [
        {"feat_idx": batch["feat_idx"][i].tolist(),
         "rels_mask": batch["rels_mask"][i].tolist()}
        for i in range(batch["feat_idx"].shape[0])
    ]


def check_predictions(preds, B, spec, label):
    import math

    check(len(preds) == B, "%s: %d predictions for %d samples"
          % (label, len(preds), B))
    for p in preds:
        check(len(p["track_scores"]) == 20, "%s: track_scores" % label)
        check(0 <= p["best_track"] < 20, "%s: best_track" % label)
        for key, n_labels in (("interactions", spec.n_classes),
                              ("relationships", spec.n_rels)):
            items = p[key]
            check(len(items) == TOPK, "%s: %s top-k" % (label, key))
            for it in items:
                check(0 <= it["label"] < n_labels, "%s: %s label"
                      % (label, key))
                check(math.isfinite(it["score"]) and 0 <= it["score"] <= 1,
                      "%s: %s score %r" % (label, key, it["score"]))
        check(all(math.isfinite(s) and 0 <= s <= 1
                  for s in p["track_scores"]), "%s: track score" % label)


def main_path(torch):
    """Phase 4. Returns {kernel name: launches} and the latencies."""
    import numpy as np

    from lirec_tpu import config as config_lib
    from lirec_tpu.utils.fake_batch import make_structured_batch, make_tables
    from lirec_tpu_torch.cli.serve import InferenceEngine
    from lirec_tpu_torch.evaluation.metrics import _sigmoid
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES

    cfg = config_lib.preset("int_rel_ch")
    engines = {}
    t0 = time.perf_counter()
    tables = None
    for compute in ("bfloat16", "float32"):
        bundle = create_model(cfg.with_runtime(compute_dtype=compute), 101,
                              n_rels=15, seed=0, device="cuda")
        if tables is None:
            tables = make_tables(bundle.spec, N_CLIPS, N_TRACKS, seed=0)
        engines[compute] = InferenceEngine(bundle, tables, device="cuda",
                                           topk=TOPK, max_batch=64)
    spec = engines["float32"].bundle.spec
    check((spec.text_dim, spec.visual_dim, spec.track_dim, spec.joint_dim,
           spec.mid_m_ints, spec.n_classes, spec.n_rels)
          == (768, 2048, 2048, 512, 6, 101, 15), "published widths: %s" % (
              spec,))
    torch.cuda.synchronize()
    log("  engines built (tables embedded once each) in %.1f s"
        % (time.perf_counter() - t0))
    batches = {B: make_structured_batch(spec, B, N_CLIPS, N_TRACKS,
                                        seed=100 + B) for B in B_SIZES}
    reps = {1: 10, 64: 5}  # timed requests per size (3 for the others)

    # ---- the counted run: only the served requests launch kernels here
    dispatch.reset_launches()
    forwards = {}
    latency = {}
    served = {}
    for compute, engine in engines.items():
        n = 0
        with serving(engine) as base:
            status, health = http(base + "/healthz")
            check(status == 200 and health["status"] == "ok"
                  and health["n_classes"] == 101 and health["n_rels"] == 15,
                  "healthz: %s %s" % (status, health))
            for B in B_SIZES:
                payload = {"samples": samples_of(batches[B])}
                times = []
                for _ in range(1 + reps.get(B, 3)):  # the first is a warm-up
                    t = time.perf_counter()
                    status, out = http(base + "/predict", payload)
                    times.append((time.perf_counter() - t) * 1e3)
                    n += 1
                    check(status == 200, "%s B=%d: status %s %s"
                          % (compute, B, status, out))
                    check_predictions(out["predictions"], B, spec,
                                      "%s B=%d" % (compute, B))
                served[(compute, B)] = out["predictions"]
                latency[(compute, B)] = statistics.median(times[1:])
                log("  %s /predict B=%-2d median %.2f ms over %d requests"
                    % (compute, B, latency[(compute, B)], len(times) - 1))
        forwards[compute] = n
    counts = dispatch.launches()
    # ---- end of the counted run

    names = {"bfloat16": KERNEL_NAMES[torch.bfloat16],
             "float32": KERNEL_NAMES[torch.float32]}
    for compute, name in names.items():
        log("  %s: %d forwards, %d launches of %s"
            % (compute, forwards[compute], counts.get(name, 0), name))
        check(counts.get(name, 0) == forwards[compute],
              "%s: launches %d != forwards %d"
              % (name, counts.get(name, 0), forwards[compute]))

    # the logits against the same forward with the plain pool on the card;
    # f32: one-ulp pool differences through f32 matmuls; bf16: a pooled
    # value can round to the neighbouring bf16 before the gate
    atol = {"float32": 1e-5, "bfloat16": 2e-3}
    for compute, engine in engines.items():
        for B in B_SIZES[1:]:
            batch = {k: batches[B][k] for k in ("feat_idx", "rels_mask")}
            with torch.inference_mode():
                outs = [engine.bundle.apply(engine.bundle.model, batch,
                                            embedded=engine.embedded,
                                            use_kernel=use)
                        for use in (True, False)]
            torch.cuda.synchronize()
            for key, width in (("inters", 101), ("rels", 15)):
                got, want = outs[0][key], outs[1][key]
                check(tuple(got.shape) == (B, 20, width),
                      "%s %s shape %s" % (compute, key, tuple(got.shape)))
                check(bool(torch.isfinite(got).all()),
                      "%s %s: non-finite logits" % (compute, key))
                err = float((got - want).abs().max())
                log("  %s B=%d %s: kernel vs plain pool max|diff| %.3e "
                    "(atol %.0e)" % (compute, B, key, err, atol[compute]))
                check(err <= atol[compute], "%s %s: kernel path disagrees"
                      % (compute, key))
            # the served scores are the sigmoid of these logits
            s = _sigmoid(outs[0]["inters"].cpu().numpy().astype(np.float64))
            got = np.array([p["track_scores"] for p in served[(compute, B)]])
            check(np.abs(got - s.max(axis=-1)).max() < 1e-5,
                  "%s B=%d: served scores differ from the logits"
                  % (compute, B))
    del engines
    torch.cuda.empty_cache()
    return counts, latency


def entry_point(torch):
    """Phase 5: the CLI's own engine builder on a synthetic fixture."""
    from lirec_tpu.data import synthetic
    from lirec_tpu.utils.fake_batch import make_batch
    from lirec_tpu_torch.cli.serve import build_engine_from_args, make_parser

    with tempfile.TemporaryDirectory() as root:
        synthetic.generate(root)
        args = make_parser().parse_args([
            "--data-root", root, "--text-dim", "16", "--visual-dim", "32",
            "--text-layers", "4", "--joint-dim", "16", "--device", "cuda",
        ])
        engine = build_engine_from_args(args)
        check(engine.device.type == "cuda", "engine not on cuda")
        batch = make_batch(engine.bundle.spec, 2, engine.n_clip_rows,
                           engine.n_track_rows, seed=3)
        with serving(engine) as base:
            status, out = http(base + "/predict",
                               {"samples": samples_of(batch)})
        check(status == 200, "entry point: %s %s" % (status, out))
        check_predictions(out["predictions"], 2, engine.bundle.spec,
                          "entry point")
        log("  build_engine_from_args on %s: %d classes, %d rels, "
            "/predict ok" % (engine.device, engine.bundle.spec.n_classes,
                             engine.bundle.spec.n_rels))


# ------------------------------------------------------- scatter kernel


def train_batches(spec):
    """TRAIN_STEPS structured B = 64 host batches (the real loader's index
    locality: heavy duplicate rows), and the same batches localized
    together by the port's Localizer, as the train loop localizes an
    epoch. Returns (raw, localized, (cap_clip, cap_track))."""
    from lirec_tpu.utils.fake_batch import make_structured_batch
    from lirec_tpu_torch.data.localize import Localizer

    raw = [make_structured_batch(spec, TRAIN_B, N_CLIPS, N_TRACKS,
                                 seed=400 + i) for i in range(TRAIN_STEPS)]
    localizer = Localizer(spec, N_CLIPS, N_TRACKS)
    local = localizer.maybe_localize(raw)
    check(localizer.applied, "the Localizer did not localize")
    return raw, local, (localizer.cap_clip, localizer.cap_track)


def ctx_idx(torch, batch):
    """A batch's ctx index triples as a contiguous int32 [B*T, R, 3] on the
    card: the idx of the train step's gather_h1."""
    fi = batch["feat_idx"]
    return torch.from_numpy(fi[:, :, 1:, :].reshape(
        -1, fi.shape[2] - 1, 3).copy()).cuda()


def scatter_case(torch, label, idx, gs, rows, single):
    """Kernel vs the plain version on the card (index_add_, f32 atomics)
    and vs the in-order sum on the CPU; two launches must be bitwise equal.
    Returns (max |diff| vs the card's plain version, kernel ms, sort ms,
    plain ms)."""
    from lirec_tpu_torch.ops import scatter_accum as sa

    if single:
        one = idx[..., 0].contiguous()
        run = lambda: (sa.scatter_accum1(one, gs[0], rows[0]),)  # noqa: E731
        plain = lambda: (sa.scatter_accum1_reference(  # noqa: E731
            one, gs[0], rows[0]),)
        flat = one.reshape(-1, 1)
        gflat, rows_k = [gs[0].reshape(-1, gs[0].shape[-1])], rows[:1]
    else:
        run = lambda: sa.scatter_accum3(idx, *gs, *rows[:2])  # noqa: E731
        plain = lambda: sa.scatter_accum3_reference(  # noqa: E731
            idx, *gs, *rows[:2])
        flat = idx.reshape(-1, 3)
        gflat = [g.reshape(-1, g.shape[-1]) for g in gs]
        rows_k = rows
    got, again = run(), run()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "%s: two launches differ" % label)
    want_gpu = plain()
    if single:
        want_cpu = (sa.scatter_accum1_reference(one.cpu(), gs[0].cpu(),
                                                rows[0]),)
    else:
        want_cpu = sa.scatter_accum3_reference(
            idx.cpu(), *(g.cpu() for g in gs), *rows[:2])
    torch.cuda.synchronize()
    err_gpu = max(float((a - b).abs().max()) for a, b in zip(got, want_gpu))
    err_cpu = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(got, want_cpu))
    scale = max(float(b.abs().max()) for b in want_cpu)
    log("  %-44s max|diff| vs card plain %.3e, vs CPU in-order %.3e "
        "(scale %.1f)" % (label, err_gpu, err_cpu, scale))
    # the kernel sums each row in update order with f32 adds, as index_add_
    # does on the CPU: bitwise equal; the card's plain version sums with
    # atomics in another order: 1e-5 of the largest sum
    check(err_cpu == 0.0, "%s: differs from the in-order sum" % label)
    check(err_gpu <= 1e-5 * scale, "%s: differs from the plain version"
          % label)
    perm, offsets = sa.sort_by_row(flat, rows_k)
    outs = [torch.empty_like(o) for o in got]
    ms = median_ms(torch, lambda: sa.launch_sorted(gflat, outs, perm,
                                                   offsets))
    sort_ms = median_ms(torch, lambda: sa.sort_by_row(flat, rows_k))
    plain_ms = median_ms(torch, plain)
    check(all(torch.equal(a, b) for a, b in zip(outs, got)),
          "%s: timed launches differ" % label)
    upd = sum(g.numel() * g.element_size() for g in gflat)
    out = sum(o.numel() * o.element_size() for o in got)
    floor_us = (upd + out) / 3.35e12 * 1e6
    log("  %-44s kernel %.4f ms, sort %.4f ms, plain %.4f ms; bytes floor "
        "%.1f us (%.1f MB)" % ("", ms, sort_ms, plain_ms, floor_us,
                               (upd + out) / 1e6))
    return err_gpu, ms, sort_ms, plain_ms


def scatter_checks(torch, spec, raw, local, caps):
    """Phase 6, on the ctx indices of one structured batch (`raw`) and of
    the same batch localized (`local`, tables of `caps` rows). Returns
    {entry: {max_abs_err, ms, plain_ms}} at split-scale tables (the numbers
    of the kernels line)."""
    idx_full, idx_loc = ctx_idx(torch, raw), ctx_idx(torch, local)
    idx_dup = idx_full % 8  # every update into 8 rows of each table
    g = torch.Generator(device="cuda").manual_seed(6)
    d_clip, d_tr = 2 * spec.joint_dim, spec.joint_dim
    base = [torch.randn(*idx_full.shape[:2], d, device="cuda", generator=g)
            for d in (d_clip, d_tr, d_tr)]
    full = (N_CLIPS, N_TRACKS, N_TRACKS)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        gs = [t.to(dtype) for t in base]
        err, ms, sort_ms, plain_ms = scatter_case(
            torch, "3 tables %dx%d rows %s" % (N_CLIPS, N_TRACKS, tag),
            idx_full, gs, full, single=False)
        results[tag] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "sort_ms": sort_ms}
        scatter_case(torch, "3 tables at caps %dx%d %s" % (caps[0], caps[1],
                                                           tag),
                     idx_loc, gs, (caps[0], caps[1], caps[1]), single=False)
        scatter_case(torch, "3 tables, all updates into 8 rows, %s" % tag,
                     idx_dup, gs, full, single=False)
        err, ms, _, plain_ms = scatter_case(
            torch, "flattened [23040, d] %s" % tag, idx_full.reshape(-1, 3),
            [t.reshape(-1, t.shape[-1]) for t in gs], full, single=False)
        results[tag + "@flat"] = {"max_abs_err": err, "ms": ms,
                                  "plain_ms": plain_ms}
        err, ms, _, plain_ms = scatter_case(
            torch, "single table (clip) %s" % tag, idx_full, gs, full,
            single=True)
        results[tag + "@single_table"] = {"max_abs_err": err, "ms": ms,
                                          "plain_ms": plain_ms}
    del base, gs
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------ train path


def step_grads(torch, bundle, batch, tables, use_kernel):
    """Gradients of one training forward + loss (dropout on, the step's
    generators reseeded identically each call)."""
    from lirec_tpu_torch.train.loop import MODEL_KEYS, _to_device, \
        step_generators

    model = bundle.model
    model.zero_grad(set_to_none=True)
    b = _to_device(batch, "cuda")
    gen_drop, gen_loss = step_generators(0, 7, "cuda")
    out = bundle.apply(model, {k: b[k] for k in MODEL_KEYS if k in b},
                       tables=tables, deterministic=False, rng=gen_drop,
                       use_kernel=use_kernel)
    bundle.loss(out, b, rng=gen_loss).backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def train_path(torch, batches):
    """Phase 7 on localized host batches. Returns ({kernel name:
    launches}, {compute: ms/step})."""
    import numpy as np

    from lirec_tpu import config as config_lib
    from lirec_tpu.utils.fake_batch import make_tables
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.scatter_accum import KERNEL_NAMES
    from lirec_tpu_torch.train.loop import make_train_step, step_generators
    from lirec_tpu_torch.train.optim import make_optimizer

    cfg = config_lib.preset("int_rel_ch")
    counts, step_ms = {}, {}
    tables = None
    for compute in ("bfloat16", "float32"):
        bundle = create_model(cfg.with_runtime(compute_dtype=compute), 101,
                              n_rels=15, seed=0, device="cuda")
        check((bundle.spec.text_dim, bundle.spec.visual_dim,
               bundle.spec.track_dim, bundle.spec.joint_dim)
              == (768, 2048, 2048, 512), "published widths")
        if tables is None:
            tables = {k: torch.from_numpy(v).cuda() for k, v in make_tables(
                bundle.spec, N_CLIPS, N_TRACKS, seed=0).items()}
        name = KERNEL_NAMES[torch.bfloat16 if compute == "bfloat16"
                            else torch.float32]

        # one step's gradients, kernel against the plain scatter (not counted)
        with_kernel = step_grads(torch, bundle, batches[0], tables, True)
        plain = step_grads(torch, bundle, batches[0], tables, False)
        torch.cuda.synchronize()
        # f32: the plain scatter's atomics sum the table grads in another
        # order (1e-5 of each tensor's scale); bf16: the table grads are
        # then rounded to bf16, where such a difference can flip a rounding
        # (the bf16 contract, 4.1e-3 of scale)
        rel = 4.1e-3 if compute == "bfloat16" else 1e-5
        worst = 0.0
        for n, g in with_kernel.items():
            p = plain[n]
            check(bool(torch.isfinite(g).all()), "%s: non-finite grad %s"
                  % (compute, n))
            scale = float(p.abs().max())
            err = float((g - p).abs().max())
            worst = max(worst, err / scale if scale else err)
            check(err <= rel * scale, "%s: grad %s differs from the plain "
                  "scatter's by %.3e (scale %.3e)" % (compute, n, err, scale))
        log("  %s: step grads with the kernel vs the plain scatter: worst "
            "|diff| / scale %.3e (bound %.1e)" % (compute, worst, rel))

        before = {n: p.detach().clone()
                  for n, p in bundle.model.named_parameters()}
        opt = make_optimizer(bundle.model.parameters(), cfg.optim.lr,
                             cfg.optim.weight_decay)
        step = make_train_step(bundle, opt)
        # ---- the counted run: only the training steps launch kernels here
        dispatch.reset_launches()
        times, losses = [], []
        for i, batch in enumerate(batches):
            t = time.perf_counter()
            loss = step(batch, tables, step_generators(0, i, "cuda"))
            losses.append(float(loss))  # waits for the step
            times.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        counted = dispatch.launches()
        # ---- end of the counted run
        check(all(np.isfinite(losses)), "%s: losses %s" % (compute, losses))
        check(counted.get(name, 0) == len(batches),
              "%s: %d launches of %s for %d steps" % (
                  compute, counted.get(name, 0), name, len(batches)))
        check(set(counted) == {name}, "%s: other launches %s"
              % (compute, counted))
        for n, p in bundle.model.named_parameters():
            check(not torch.equal(p.detach(), before[n]),
                  "%s: parameter %s did not move" % (compute, n))
        counts[name] = counted[name]
        step_ms[compute] = statistics.median(times[1:])
        log("  %s: %d steps, losses %.4f .. %.4f, %d launches of %s; "
            "median %.2f ms/step (first %.1f ms), %.0f clips/s"
            % (compute, len(batches), losses[0], losses[-1], counted[name],
               name, step_ms[compute], times[0],
               TRAIN_B / step_ms[compute] * 1e3))
        del bundle, opt, step, before, with_kernel, plain
        torch.cuda.empty_cache()
    return counts, step_ms


def train_entry(torch):
    """Phase 8: train() on a synthetic fixture, on the card."""
    import numpy as np

    from lirec_tpu import config as config_lib
    from lirec_tpu.data import synthetic
    from lirec_tpu.data.dataset import InteractionDataset
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.scatter_accum import KERNEL_NAMES
    from lirec_tpu_torch.train.loop import train

    with tempfile.TemporaryDirectory() as root:
        synthetic.generate(root)
        base = synthetic.make_config(root)
        cfg = config_lib.preset("int_rel_ch", data_root=root)
        cfg = cfg.replace(dims=base.dims, paths=base.paths).with_optim(
            batch_size=8, epochs=2, save_model=False)
        ds = InteractionDataset(cfg, mode="train")
        ds.cache()
        ds.init_relships()
        bundle = create_model(cfg, ds.n_classes,
                              n_rels=max(len(ds.rels_list) - 1, 0),
                              device="cuda")
        dispatch.reset_launches()
        out = train(cfg, bundle, ds, verbose=False)
        torch.cuda.synchronize()
        counted = dispatch.launches()
    name = KERNEL_NAMES[torch.bfloat16]  # the preset computes in bf16
    steps = 2 * -(-len(ds) // 8)
    check(len(out["losses"]) == 2 and all(np.isfinite(out["losses"])),
          "train() losses %s" % out["losses"])
    check(counted.get(name, 0) == steps, "train(): %d launches of %s for "
          "%d steps" % (counted.get(name, 0), name, steps))
    log("  train() on %d synthetic samples, batch 8, 2 epochs: losses %s, "
        "%d launches of %s" % (len(ds), out["losses"], counted[name], name))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    from lirec_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== 1. card")
    log(card_line())
    log("torch %s, CUDA %s, python %s, %d device(s), using %s"
        % (torch.__version__, torch.version.cuda, sys.version.split()[0],
           torch.cuda.device_count(), torch.cuda.get_device_name(0)))

    log("== 2. build")
    t0 = time.perf_counter()
    sources = ("fused_ctx_pool", "scatter_accum")
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(build.build, sources))
    log("  built in %.2f s (one nvcc per source, in parallel)"
        % (time.perf_counter() - t0))
    for name, path in zip(sources, paths):
        info = build.BUILD_LOGS.get(name)
        log("  %s: %s" % (name, "built in %.2f s" % info["seconds"]
                          if info else "reused"))
        if info:
            log("  " + info["cmd"])
            for line in info["log"].splitlines():
                log("  " + line)
        log("  -> %s" % os.path.relpath(path, ROOT))

    log("== 3. kernels vs plain PyTorch on the card")
    perf = kernel_checks(torch)

    log("== 4. int_rel_ch served at published widths")
    counts, latency = main_path(torch)

    log("== 5. CLI entry point")
    entry_point(torch)

    log("== 6. scatter kernel vs plain PyTorch on the card")
    from lirec_tpu_torch.models.spec import ModelSpec

    spec = ModelSpec(n_classes=101, n_rels=15)  # the published widths
    t0 = time.perf_counter()
    raw, local, caps = train_batches(spec)
    log("  %d structured B=%d batches, localized in %.1f s: caps %d clip / "
        "%d track rows" % (len(raw), TRAIN_B, time.perf_counter() - t0,
                           *caps))
    scatter = scatter_checks(torch, spec, raw[0], local[0], caps)

    log("== 7. int_rel_ch training at published widths (counted run)")
    train_counts, step_ms = train_path(torch, local)

    log("== 8. train() on a synthetic fixture")
    train_entry(torch)

    from lirec_tpu_torch.ops import scatter_accum
    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES

    f32, bf16 = KERNEL_NAMES[torch.float32], KERNEL_NAMES[torch.bfloat16]
    entries = [
        (f32, "split_f32", "%s:178" % TPU_SRC),
        (bf16, "split_bf16", "%s:218" % TPU_SRC),
        (f32 + "@giant_tables", "giant", "%s:334" % TPU_SRC),
    ]
    kernels = []
    for name, key, replaces in entries:
        launches = counts.get(name.split("@")[0], 0)
        check(launches > 0, "%s was not launched by the main path" % name)
        kernels.append({
            "name": name, "route": "cuda", "source": CU,
            "replaces": replaces, "launches": launches, **perf[key],
        })
    # scatter: one entry per instantiation, as the train path launches it
    # (three tables); the flattened and single-table cases of phase 6 are
    # the same kernel and go on a line of their own
    variants = {}
    for dtype, tag in ((torch.float32, "float32"),
                       (torch.bfloat16, "bfloat16")):
        name = scatter_accum.KERNEL_NAMES[dtype]
        launches = train_counts.get(name, 0)
        check(launches > 0, "%s was not launched by the train path" % name)
        r = scatter[tag]
        kernels.append({
            "name": name, "route": "cuda", "source": SCATTER_CU,
            "replaces": "%s:91" % SCATTER_TPU_SRC, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
        })
        for suffix, line in (("@flat", 49), ("@single_table", 282)):
            variants[name + suffix] = dict(
                scatter[tag + suffix],
                replaces="%s:%d" % (SCATTER_TPU_SRC, line))
        log("scatter %s: sort %.4f ms beside the kernel's %.4f ms"
            % (tag, r["sort_ms"], r["ms"]))
    log("scatter_variants (phase 6 only, not counted launches): "
        + json.dumps(variants))
    log("train_ms_per_step: " + json.dumps(step_ms))
    log("latency_ms: " + json.dumps(
        {"%s_B%d" % k: v for k, v in latency.items()}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
