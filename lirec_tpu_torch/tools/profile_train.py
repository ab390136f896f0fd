"""Where the time of one int_rel_ch train step goes, on one CUDA card.

    python -m lirec_tpu_torch.tools.profile_train

The configuration of ``chip_smoke.py`` phase 7: int_rel_ch at its
published widths, seeded weights, split-scale tables (12,288 clip / 24,576
track rows), B = 64 structured batches localized together by the port's
Localizer, in bf16 and f32 compute. For each compute dtype: 3 warm-up
steps, then 10 unprofiled steps timed on the host clock (each waits for
its loss, as ``train()`` does), then 5 steps under ``torch.profiler``.
It prints

- the unprofiled steps' median ms/step and clips/s;
- device busy ms/step: the union of the profiled steps' kernel spans,
  divided by the number of profiled steps;
- the scatter's kernels (``scatter_hot_kernel`` and
  ``scatter_short_kernel``, concurrent) and its counting sort
  (``sort_count_kernel``, ``sort_prefix_kernel``, ``sort_place_kernel``,
  and past one pass ``sort_zero_kernel``, ``sort_digits_kernel``,
  ``sort_tile_kernel``, ``sort_bounds_kernel``),
  each group as the union of its spans in µs per step and as a share of
  device busy;
- the profiler's table of the largest device items.

The device's idle share of the epoch sweep is the benchmark's, over one
traced window of whole epochs (``benchmark/metrics/device_idle.train*``),
and which host phase leaves the card idle the program's own spans
(``staging_idle_ms.*``, ``replay_idle_ms.train*``; PERF.md §3).

Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import statistics
import sys
import time

N_CLIPS, N_TRACKS, BATCH = 12288, 24576, 64
WARMUP, STEPS, PROFILED = 3, 10, 5
SCATTER_KERNELS = ("scatter_hot_kernel<", "scatter_short_kernel<")
SORT_KERNELS = ("sort_count_kernel<", "sort_prefix_kernel<",
                "sort_place_kernel<", "sort_zero_kernel",
                "sort_digits_kernel<", "sort_tile_kernel<",
                "sort_bounds_kernel<")


def _batches(spec, n):
    from lirec_tpu_torch.utils.fake_batch import make_structured_batch
    from lirec_tpu_torch.data.localize import Localizer

    raw = [make_structured_batch(spec, BATCH, N_CLIPS, N_TRACKS, seed=400 + i)
           for i in range(n)]
    localizer = Localizer(spec, N_CLIPS, N_TRACKS)
    return localizer.maybe_localize(raw)


def _union_us(spans):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _kernel_spans(prof):
    import torch

    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            yield evt.name, evt.time_range.start, evt.time_range.end


def profile(compute: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.utils.fake_batch import make_tables
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.train.loop import make_train_step, step_generators
    from lirec_tpu_torch.train.optim import make_optimizer

    cfg = config_lib.preset("int_rel_ch").with_runtime(compute_dtype=compute)
    bundle = create_model(cfg, 101, n_rels=15, seed=0, device="cuda")
    tables = {k: torch.from_numpy(v).cuda() for k, v in make_tables(
        bundle.spec, N_CLIPS, N_TRACKS, seed=0).items()}
    batches = _batches(bundle.spec, WARMUP + STEPS + PROFILED)
    step = make_train_step(bundle, make_optimizer(
        bundle.model.parameters(), cfg.optim.lr, cfg.optim.weight_decay))

    def run(i):
        float(step(batches[i], tables, step_generators(0, i, "cuda")))

    for i in range(WARMUP):
        run(i)
    times = []
    for i in range(WARMUP, WARMUP + STEPS):
        t = time.perf_counter()
        run(i)
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for i in range(WARMUP + STEPS, WARMUP + STEPS + PROFILED):
            run(i)
        torch.cuda.synchronize()
    spans = list(_kernel_spans(prof))
    if not spans:
        raise RuntimeError("the profiler recorded no kernel on the card")

    def per_step(names):
        return _union_us((s, e) for n, s, e in spans
                         if any(k in n for k in names)) / PROFILED

    step_ms = statistics.median(times)
    busy_us = _union_us((s, e) for _, s, e in spans) / PROFILED
    scatter_us, sort_us = per_step(SCATTER_KERNELS), per_step(SORT_KERNELS)
    return {
        "compute": compute, "step_ms": step_ms, "step_ms_all": times,
        "clips_per_s": BATCH / step_ms * 1e3,
        "busy_ms": busy_us / 1e3,
        "scatter_us": scatter_us, "sort_us": sort_us,
        "scatter_share": scatter_us / busy_us, "sort_share": sort_us / busy_us,
        "table": prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=25, max_name_column_width=60),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    for compute in ("bfloat16", "float32"):
        r = profile(compute)
        print("%s: median %.4f ms/step over %d unprofiled steps (%.0f "
              "clips/s); steps %s" % (
                  compute, r["step_ms"], STEPS, r["clips_per_s"],
                  ["%.2f" % t for t in r["step_ms_all"]]))
        print("%s: device busy %.4f ms/step (union of kernel spans over %d "
              "profiled steps)" % (compute, r["busy_ms"], PROFILED))
        print("%s: scatter kernel %.1f us/step (%.3f of busy), its sort "
              "%.1f us/step (%.3f of busy)" % (
                  compute, r["scatter_us"], r["scatter_share"], r["sort_us"],
                  r["sort_share"]))
        print(r["table"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
