"""The one-table pool kernels' geometry, on one CUDA card: the triple pool
(kernel 4) and the masked gather-sum (kernel 5) as built beside variants of
``csrc/fused_ctx_pool_triple.cu`` and of its launch plan.

    python -m lirec_tpu_torch.tools.pool_variants

Inputs: ``chip_smoke.py`` phase 3's eval batch (a structured B = 64 batch
over split-scale tables: kernel 4 on its local table of 1536-wide rows,
kernel 5 on its clip column, f32 and bf16) and the bf16 probe's two shapes
(``tools/probe_bf16_pack.SHAPES``, kernel 5 on the native bf16 table).
Variants:

- ``built``: the kernels and plan as the wrappers launch them (6 gathered
  rows loaded ahead, at least two lanes per thread, column slabs at small
  M);
- ``ahead9`` / ``ahead12`` / ``ahead18``: that many rows loaded ahead;
- ``regs64`` / ``regs48``: registers capped through ``__launch_bounds__``
  (8 / 10 blocks of 128 threads per SM);
- ``threads256``: 256 threads per block;
- ``lanes3``: about three lanes per thread (``pool_plan``'s rule);
- ``no_slabs``: no column slabs: one block per group of pooled rows.

For each, in two rounds: the median ms of each case (L2 flushed, as
``chip_smoke.median_ms``), the kernel-5 cases checked bit for bit against
the r-ordered loop and kernel 4 against the 3-table kernel. The variants
are built with nvcc into ``lirec_tpu_torch/_build/variants/``. Needs a
CUDA card; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

# source variants, as substitutions of csrc/fused_ctx_pool_triple.cu
_AHEAD = r"constexpr int kChunk = 6;"
_THREADS = r"constexpr int kThreads = 128;"
_BOUNDS = r"__launch_bounds__\(kThreads\)"
SOURCE_VARIANTS = {
    "ahead9": ((_AHEAD, "constexpr int kChunk = 9;"),),
    "ahead12": ((_AHEAD, "constexpr int kChunk = 12;"),),
    "ahead18": ((_AHEAD, "constexpr int kChunk = 18;"),),
    "regs64": ((_BOUNDS, "__launch_bounds__(kThreads, 8)"),),
    "regs48": ((_BOUNDS, "__launch_bounds__(kThreads, 10)"),),
    "threads256": ((_THREADS, "constexpr int kThreads = 256;"),),
}


def _build_variant(name, subs):
    from lirec_tpu_torch.ops import build

    src = build.source_path("fused_ctx_pool_triple").read_text()
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        if n != 1:
            raise RuntimeError("variant %s: %r matched %d times"
                               % (name, pat, n))
    out = build.source_path("fused_ctx_pool_triple").parent.parent / \
        "_build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / ("fused_ctx_pool_triple_%s.cu" % name)
    cu.write_text(src)
    so = out / ("libfused_ctx_pool_triple_%s.so" % name)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], check=True, capture_output=True,
                          text=True)
    regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                              proc.stdout + proc.stderr)})
    spills = any(int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                            proc.stdout + proc.stderr))
    return ctypes.CDLL(str(so)), regs, spills


def _plan_variants(gp):
    built = gp.gather_plan

    def lanes3(M, R, width, elem_size, vec, sms=gp.CARD_SMS):
        plan = built(M, R, width, elem_size, vec, sms)
        if plan["slabs"] > 1:
            return plan
        rows = max(1, gp.POOL_THREADS * 3 // plan["lanes"])
        rows = min(rows, max(1, gp.POOL_SMEM_BYTES // (8 * R)))
        return dict(plan, rows_per_block=rows, blocks=-(-M // rows))

    def no_slabs(M, R, width, elem_size, vec, sms=gp.CARD_SMS):
        plan = built(M, R, width, elem_size, vec, sms)
        return dict(plan, slab_lanes=plan["lanes"], slabs=1,
                    blocks=-(-M // plan["rows_per_block"]))

    return {"lanes3": lanes3, "no_slabs": no_slabs}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pool_variants: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke as cs

    from lirec_tpu_torch.models.spec import ModelSpec
    from lirec_tpu_torch.ops import build
    from lirec_tpu_torch.ops import gather_pool as gp
    from lirec_tpu_torch.tools import probe_bf16_pack

    print(cs.card_line(), flush=True)
    spec = ModelSpec(n_classes=101, n_rels=15)
    cases = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        emb, idx, mask, fused, _, tidx = cs.local_table_inputs(
            torch, dtype, spec, seed=7)
        three = gp.fused_ctx_pool(emb, idx, mask, True)
        clip, one = emb.clip, idx[..., 0].contiguous()
        cases["k4_" + tag] = (
            lambda f=fused, t=tidx, m=mask: gp.fused_ctx_pool_triple(
                f, t, m, True), three)
        cases["k5_eval_" + tag] = (
            lambda c=clip, o=one, m=mask: gp.gather_masked_sum(c, o, m),
            cs.masked_sum_loop(torch, clip, one, mask))
    for name, (n, d, m, r) in probe_bf16_pack.SHAPES.items():
        table, pidx, pmask = probe_bf16_pack.make_inputs(torch, "cuda", n, d,
                                                         m, r)
        native = table.to(torch.bfloat16)
        cases["k5_" + name] = (
            lambda t=native, i=pidx, k=pmask: gp.gather_masked_sum(t, i, k),
            cs.masked_sum_loop(torch, native, pidx, pmask))
    torch.cuda.synchronize()

    built_lib = build.load("fused_ctx_pool_triple")
    built_plan = gp.gather_plan
    runs = [("built", built_lib, built_plan, "")]
    for name, subs in SOURCE_VARIANTS.items():
        lib, regs, spills = _build_variant(name, subs)
        runs.append((name, lib, built_plan, " (registers %s%s)" % (
            regs, ", spills" if spills else "")))
    runs += [(name, built_lib, plan, "")
             for name, plan in _plan_variants(gp).items()]
    try:
        for (name, lib, plan, note), round_ in (
                (run, k) for k in (1, 2) for run in runs):
            build._LIBS["fused_ctx_pool_triple"] = lib
            gp.gather_plan = plan
            times = {}
            for key, (fn, want) in cases.items():
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(torch.nan_to_num(got),
                                   torch.nan_to_num(want)):
                    raise RuntimeError("%s %s: not bitwise its reference"
                                       % (name, key))
                times[key] = round(cs.median_ms(torch, fn), 4)
            print("round %d %-10s %s%s" % (round_, name, json.dumps(times),
                                          note), flush=True)
    finally:
        build._LIBS["fused_ctx_pool_triple"] = built_lib
        gp.gather_plan = built_plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
