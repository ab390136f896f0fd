"""Probe: does a bf16 row gather load faster as packed 32-bit words?

    python -m lirec_tpu_torch.tools.probe_bf16_pack [--device cuda]

The TPU package stored bf16 tables as int32 words (column d in the low
half, column d + D/2 in the high half) because Mosaic could not gather
single rows of a 16-bit array. On the card bf16 rows load directly
(``ops/gather_pool.gather_masked_sum``, kernel 5). This probe runs the
packed layout's masked gather-sum (kernel 10, ``ops/probes.
packed_gather_sum``) at the TPU probe's own shapes (a [512, 1024] table,
M = 64, R = 18) and at the clip table's (12,288 x 1024, M = 1280, R = 18),
half of the weights 1. For each it prints max|diff| against the plain
version on the bf16-rounded table (and fails at 1e-5 or more, as the TPU
probe does) and, on the card, the ms per call of kernel 10 beside kernel 5
on the native bf16 table of the same values: the question of how wide a
row load should be. Times are slopes between 20 and 120 back-to-back calls
(each run captured in one CUDA graph, CUDA events), medians of 3
repetitions; ``--device cpu`` checks the values only. The counterpart of the TPU probe ``tools/probe_bf16_pack.py``.
"""

from __future__ import annotations

import argparse

import numpy as np

from lirec_tpu_torch.tools.probe_hbm_dma import slope_ms

SHAPES = {"probe": (512, 1024, 64, 18), "clip": (12288, 1024, 1280, 18)}


def make_inputs(torch, device, n, d, m, r, seed=0):
    """An f32 [n, d] table, idx [m, r] int32 and 0/1 weights (half ones),
    from a numpy seed (as the TPU probe makes them)."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, (m, r)).astype(np.int32)
    mask = (rng.random((m, r)) < 0.5).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (table, idx, mask))


def measure(device, shapes=SHAPES) -> dict:
    """Kernel 10 at each of `shapes` ({name: (n, d, m, r)}; ``main`` runs
    all of SHAPES) on `device`: its max|diff| against the plain version
    and, on the card, its ms per call beside kernel 5's."""
    import torch

    from lirec_tpu_torch.ops.gather_pool import gather_masked_sum
    from lirec_tpu_torch.ops.probes import (
        pack_bf16, packed_gather_sum, packed_gather_sum_reference,
    )

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_bf16_pack: no CUDA device (pass --device "
                         "cpu for a check without times)")
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    for name, (n, d, m, r) in shapes.items():
        table, idx, mask = make_inputs(torch, device, n, d, m, r)
        packed = pack_bf16(table)
        got = packed_gather_sum(packed, idx, mask)
        want = packed_gather_sum_reference(packed, idx, mask)
        err = float((got - want).abs().max())
        res = {"shape": (n, d, m, r), "max_abs_err": err}
        print("%s [%d, %d] M=%d R=%d: max|diff| vs plain %.3e"
              % (name, n, d, m, r, err))
        if not err < 1e-5:
            raise RuntimeError("packed-bf16 gather mismatch: %.3e" % err)
        if device.type == "cuda":
            native = table.to(torch.bfloat16)
            for key, fn in (
                ("packed_ms", lambda: packed_gather_sum(packed, idx, mask)),
                ("native_bf16_ms", lambda: gather_masked_sum(native, idx,
                                                             mask)),
            ):
                res[key], res[key[:-3] + "_reps"] = slope_ms(torch, fn)
            print("  packed i32 (kernel 10) %.4f ms/call, native bf16 "
                  "(kernel 5) %.4f ms/call" % (res["packed_ms"],
                                              res["native_bf16_ms"]))
        out[name] = res
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="lirec_tpu_torch.tools.probe_bf16_pack")
    p.add_argument("--device", default="cuda")
    return measure(p.parse_args(argv).device)


if __name__ == "__main__":
    main()
