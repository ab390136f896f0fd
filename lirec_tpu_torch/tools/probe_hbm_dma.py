"""Probe: how much of the ctx pool's time is the issue of its row loads?

    python -m lirec_tpu_torch.tools.probe_hbm_dma [--device cuda]

The fused ctx pool (kernel 1, ``ops/gather_pool.fused_ctx_pool``) reads
R = 18 scattered rows of each of three tables per pooled row. This probe
times, at the main path's shapes (f32 tables of 12,288 x 1024 clip rows and
2 x 24,576 x 256 track rows, M = 1280 pooled rows, idx [M, R, 3] with
run-safe random starts, 80% of the weights 1):

  a) per-row: kernel 1 on the random indices (guard_zero=True);
  b) per-row on the runs: kernel 1 on the explicit run indices
     (``run_indices``): the function of (c), the same rows, read as R x 3
     row loads per pooled row;
  c) per-run: the run pool (kernel 9, ``ops/probes.run_pool``), which reads
     each (m, table) as one contiguous [R, d] run (rows idx[m, 0, k] ..
     idx[m, 0, k] + R - 1: a different function of the indices than (a),
     the same traffic), streamed by bulk copies through a ring of shared
     memory stages;
  d) the plain version of (a) (``fused_ctx_pool_reference``).

(b) against (c) is the question: whether bulk copies of whole runs beat
row loads of the same rows, so that a run-contiguous ctx layout would pay.

Each time is ms per call: the slope of CUDA-event times between 20 and 120
back-to-back calls (set-up and launch latency drop out), the median of 3
repetitions, as the TPU probe measured. Each run of calls is captured in
one CUDA graph and replayed, as the TPU probe runs its calls in one
compiled loop: the wrappers' host work does not enter the time. With
``--device cpu`` the three run once on the CPU (a check of shapes and
control flow) and no time is measured. The counterpart of the TPU probe
``tools/probe_hbm_dma.py``.
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np

N_CLIPS, N_TRACKS, M, R, D_CLIP, D_TR = 12288, 24576, 1280, 18, 1024, 256
SHORT, LONG, REPS = 20, 120, 3


def slope_ms(torch, fn, short=SHORT, long=LONG, reps=REPS):
    """(median, reps) of the ms per call of `fn` on the card: the CUDA-event
    time of a replay of `long` calls captured in one CUDA graph, minus that
    of `short` calls, over the difference."""
    fn()
    torch.cuda.synchronize()
    graphs = {}
    for n in (short, long):
        graphs[n] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[n]):
            for _ in range(n):
                fn()

    def timed(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graphs[n].replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    timed(short)
    timed(long)
    per = [(timed(long) - timed(short)) / (long - short) for _ in range(reps)]
    return statistics.median(per), per


def make_inputs(torch, device, n_clips=N_CLIPS, n_tracks=N_TRACKS, m=M, r=R,
                d_clip=D_CLIP, d_tr=D_TR, seed=0):
    """f32 tables, idx [m, r, 3] int32 whose starts keep every run inside
    its table, and 0/1 weights with 80% ones, from a numpy seed (as the
    TPU probe makes them)."""
    from lirec_tpu_torch.models.tabular import EmbeddedTables

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    emb = EmbeddedTables(
        t(rng.standard_normal((n_clips, d_clip)).astype(np.float32)),
        t(rng.standard_normal((n_tracks, d_tr)).astype(np.float32)),
        t(rng.standard_normal((n_tracks, d_tr)).astype(np.float32)))
    idx = np.stack([rng.integers(0, n_clips - r, (m, r)),
                    rng.integers(0, n_tracks - r, (m, r)),
                    rng.integers(0, n_tracks - r, (m, r))],
                   axis=-1).astype(np.int32)
    mask = (rng.random((m, r)) < 0.8).astype(np.float32)
    return emb, t(idx), t(mask)


def run_indices(torch, idx):
    """The explicit rows the run pool reads: idx_run[m, r, k] =
    idx[m, 0, k] + r, int32 [M, R, 3]."""
    steps = torch.arange(idx.shape[1], dtype=torch.int32, device=idx.device)
    return (idx[:, :1, :] + steps[None, :, None]).contiguous()


def measure(device, n_clips=N_CLIPS, n_tracks=N_TRACKS, m=M) -> dict:
    """The four calls on `device` at the given sizes (``main`` runs the
    main path's): ms per call on the card, a finiteness check on the
    CPU."""
    import torch

    from lirec_tpu_torch.ops.gather_pool import (
        fused_ctx_pool, fused_ctx_pool_reference,
    )
    from lirec_tpu_torch.ops.probes import run_pool

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_hbm_dma: no CUDA device (pass --device cpu "
                         "for a check without times)")
    emb, idx, mask = make_inputs(torch, device, n_clips, n_tracks, m)
    run = run_indices(torch, idx)
    calls = {
        "per_row": lambda: fused_ctx_pool(emb, idx, mask, True),
        "per_row_runs": lambda: fused_ctx_pool(emb, run, mask, True),
        "per_run": lambda: run_pool(emb, idx, mask),
        "plain": lambda: fused_ctx_pool_reference(emb, idx, mask, True),
    }
    out = {"shapes": dict(clip=tuple(emb.clip.shape),
                          tr=tuple(emb.tr1.shape), idx=tuple(idx.shape)),
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    for name, fn in calls.items():
        if device.type != "cuda":
            res = fn()
            if not bool(torch.isfinite(res).all()):
                raise RuntimeError("probe_hbm_dma: %s is not finite" % name)
            out[name + "_ms"] = None
            print("%s: ran on the CPU, time not measured" % name)
            continue
        med, reps = slope_ms(torch, fn)
        out[name + "_ms"] = med
        out[name + "_reps"] = reps
        print("%s: %.4f ms/call (reps %s)"
              % (name, med, [round(x, 4) for x in reps]))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="lirec_tpu_torch.tools.probe_hbm_dma")
    p.add_argument("--device", default="cuda")
    return measure(p.parse_args(argv).device)


if __name__ == "__main__":
    main()
