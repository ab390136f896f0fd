"""Where the time of the int_rel_ch eval sweep goes, on one CUDA card.

    python -m lirec_tpu_torch.tools.profile_eval

The configuration of ``chip_smoke.py`` phase 9: int_rel_ch at its
published widths, seeded weights, split-scale tables (12,288 clip / 24,576
track rows), structured B = 64 batches, in bf16 and f32 compute, without
ctx localisation and in the triple tier. For each: the sweep over
N1 = 40 and N2 = 80 full batches, timed on the host clock (3 runs each,
unprofiled), then once each under ``torch.profiler``. Every per-batch
number is a slope over the two batch counts, so the set-up of a call
(table upload, ``embed_all``, staging, the final fetch) drops out. It
prints

- ms/batch and clips/s of the unprofiled sweeps;
- device busy ms/batch: the slope of the union of the kernel spans;
- the idle share: 1 - busy / the unprofiled ms/batch;
- the ctx pool kernels' µs per batch (the 3-table or the triple kernel),
  and the profiler's table of the largest device items of the N2 sweep.

Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import statistics
import sys
import time

from lirec_tpu_torch.tools.profile_train import _kernel_spans, _union_us

N_CLIPS, N_TRACKS, BATCH = 12288, 24576, 64
N1, N2, RUNS = 40, 80, 3
POOL_KERNELS = ("fused_ctx_pool_kernel<", "triple_pool_kernel<")


def profile(compute: str, tier, data, tables) -> dict:
    import types

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.evaluation.packed import evaluate_packed
    from lirec_tpu_torch.models.factory import create_model

    cfg = config_lib.preset("int_rel_ch").with_optim(
        batch_size=BATCH).with_runtime(compute_dtype=compute)
    bundle = create_model(cfg, 101, n_rels=15, seed=0, device="cuda")
    splits = {n: {k: v[: n * BATCH] for k, v in data.items()}
              for n in (N1, N2)}
    datasets = {n: types.SimpleNamespace(n_classes=101, n_rels=16,
                                         hashidx_rels=None)
                for n in (N1, N2)}

    def sweep(n):
        evaluate_packed(datasets[n], bundle, bundle.model, cfg, mode="test",
                        verbose=False, data=splits[n], tables=tables,
                        localize_ctx=tier)

    secs = {n: [] for n in (N1, N2)}
    for n in (N1, N2):
        sweep(n)  # warm-up; computes the localisation
    for _ in range(RUNS):
        for n in (N1, N2):
            t = time.perf_counter()
            sweep(n)
            secs[n].append(time.perf_counter() - t)
    spans = {}
    for n in (N1, N2):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            sweep(n)
            torch.cuda.synchronize()
        spans[n] = list(_kernel_spans(prof))
        if not spans[n]:
            raise RuntimeError("the profiler recorded no kernel on the card")

    def slope(f):
        return (f(N2) - f(N1)) / (N2 - N1)

    batch_ms = slope(lambda n: statistics.median(secs[n])) * 1e3
    busy_ms = slope(lambda n: _union_us(
        (s, e) for _, s, e in spans[n])) / 1e3
    pool_us = slope(lambda n: sum(e - s for name, s, e in spans[n]
                                  if any(k in name for k in POOL_KERNELS)))
    return {
        "batch_ms": batch_ms, "clips_per_s": BATCH / batch_ms * 1e3,
        "busy_ms": busy_ms, "idle_share": 1 - busy_ms / batch_ms,
        "pool_us": pool_us,
        "table": prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=20,
                                           max_name_column_width=60),
    }


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_eval: no CUDA device", file=sys.stderr)
        return 2
    from lirec_tpu_torch.models.spec import ModelSpec
    from lirec_tpu_torch.utils.fake_batch import (
        make_structured_batch, make_tables,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    spec = ModelSpec(n_classes=101, n_rels=15)
    parts = [make_structured_batch(spec, BATCH, N_CLIPS, N_TRACKS,
                                   seed=900 + i) for i in range(N2)]
    data = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    tables = make_tables(spec, N_CLIPS, N_TRACKS, seed=0)
    for compute in ("bfloat16", "float32"):
        for tier in (False, "triple"):
            r = profile(compute, tier, data, tables)
            label = "%s localize=%s" % (compute, tier or "off")
            print("%s: %.4f ms/batch (%.0f clips/s), device busy %.4f "
                  "ms/batch, idle share %.3f, ctx pool kernel %.1f us/batch"
                  % (label, r["batch_ms"], r["clips_per_s"], r["busy_ms"],
                     r["idle_share"], r["pool_us"]))
            print(r["table"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
