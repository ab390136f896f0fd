"""The run pool's ring geometry (kernel 9, ``csrc/probe_hbm_dma.cu``), on
one CUDA card: the kernel as built, launched on variants of
``ops/probes.run_pool_plan``, and variants of its source that split its
time.

    python -m lirec_tpu_torch.tools.run_pool_variants

Inputs: the pool probe's (``tools/probe_hbm_dma.make_inputs``: M = 1280
pooled rows, R = 18, clip rows of 1024 and track rows of 256 f32, 12,288 /
24,576-row tables), and the same at a quarter of the table rows
(``quarter_tables``: the runs' distinct rows, ~25 MB, fit in the 50 MB L2,
where the probe's ~73 MB do not). Plans, as run rows per stage x stages
(a 1536-wide row of the three tables is 6 KB):

- ``rows2_x8``: 2 rows (12 KB) x 8;
- ``rows5_x6``: 5 rows (30 KB) x 6;
- ``rows6_x6``: 6 rows (36 KB) x 6, the largest ring of six;
- ``rows9_x4``: 9 rows (54 KB) x 4;
- ``whole_x2``: a pooled row's whole runs (18 rows, 108 KB) x 2, the
  first design's shared memory per row, pipelined (the built plan);
- ``two_blocks``: two persistent blocks per SM (registers capped through
  ``__launch_bounds__``), each with 3 rows x 6;
- ``built``: the plan as the wrapper launches it.

and variants of the source that split the built kernel's time (their
outputs are not the pool's): ``copies_only`` (the consumers wait for each
stage and release it without adding), ``adds_only`` (the producer issues
no copy, the consumers add whatever the stages hold) and ``waits_only``
(neither: the ring's waits, releases and staged headers alone).

For each, in two rounds: the median ms (L2 flushed, as
``chip_smoke.median_ms``), checked bit for bit against kernel 1 on the
explicit run indices (but the split variants); kernel 1 on those indices
is timed in each round beside them. The source variants are built with
nvcc into ``lirec_tpu_torch/_build/variants/``. Needs a CUDA card; exits 2
without one.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

# run rows per stage (at the probe's widths), stages, blocks per SM
PLANS = {"rows2_x8": (2, 8, 1), "rows5_x6": (5, 6, 1), "rows6_x6": (6, 6, 1),
         "rows9_x4": (9, 4, 1), "whole_x2": (18, 2, 1),
         "two_blocks": (3, 6, 2)}
# source variants, as substitutions of csrc/probe_hbm_dma.cu
_NO_ADDS = (r"if \(i >= nl \|\| !\(ok >> tab\[i\] & 1\)\) continue;",
            "continue;")
_NO_COPIES = ((r'"r"\(expect\)', '"r"(0u)'),
              (r"if \(ok & (\d)\)\n", "if (false)\n"))
SOURCE_VARIANTS = {
    "two_blocks": ((r"__launch_bounds__\(kThreads, 1\)",
                    "__launch_bounds__(kThreads, 2)"),),
    "copies_only": (_NO_ADDS,),
    "adds_only": _NO_COPIES,
    "waits_only": _NO_COPIES + (_NO_ADDS,),
}
SPLITS = ("copies_only", "adds_only", "waits_only")


def _build_variant(name, subs):
    from lirec_tpu_torch.ops import build

    src = build.source_path("probe_hbm_dma").read_text()
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        if not n:
            raise RuntimeError("variant %s: %r matched nothing" % (name, pat))
    out = build.source_path("probe_hbm_dma").parent.parent / "_build" / \
        "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / ("probe_hbm_dma_%s.cu" % name)
    cu.write_text(src)
    so = out / ("libprobe_hbm_dma_%s.so" % name)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], check=True, capture_output=True,
                          text=True)
    regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                              proc.stdout + proc.stderr)})
    spills = any(int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                            proc.stdout + proc.stderr))
    return ctypes.CDLL(str(so)), regs, spills


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("run_pool_variants: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke as cs

    from lirec_tpu_torch.ops import build, probes
    from lirec_tpu_torch.ops import gather_pool as gp
    from lirec_tpu_torch.ops.gather_pool import fused_ctx_pool
    from lirec_tpu_torch.tools import probe_hbm_dma

    print(cs.card_line(), flush=True)
    cases = {}
    for case, rows in (("probe", 1), ("quarter_tables", 4)):
        emb, idx, mask = probe_hbm_dma.make_inputs(
            torch, "cuda", probe_hbm_dma.N_CLIPS // rows,
            probe_hbm_dma.N_TRACKS // rows)
        run = probe_hbm_dma.run_indices(torch, idx)
        cases[case] = (emb, idx, mask, run,
                       fused_ctx_pool(emb, run, mask, True))
    emb = cases["probe"][0]
    R = probe_hbm_dma.R
    row = cs.emb_width(emb) * 4
    built = probes.run_pool_plan

    def plan_of(rows, stages, per_sm):
        def plan(M, R, d_clip, d_tr, sms=gp.CARD_SMS):
            return built(M, R, d_clip, d_tr, per_sm * sms, stages=stages,
                         stage_bytes=rows * row)
        return plan

    plans = {name: plan_of(*geometry) for name, geometry in PLANS.items()}
    built_lib = build.load("probe_hbm_dma")
    runs = []
    for name, subs in SOURCE_VARIANTS.items():
        lib, regs, spills = _build_variant(name, subs)
        runs.append((name, lib, plans.pop(name, built),
                     " %s: registers %s%s" % (name, regs,
                                              ", spills" if spills else "")))
    runs = [(name, built_lib, plan, "") for name, plan in plans.items()] + runs
    runs.append(("built", built_lib, built, ""))
    print("".join(note for *_, note in runs), flush=True)
    try:
        for round_ in (1, 2):
            for case, (emb, idx, mask, run, want) in cases.items():
                times = {"kernel1_on_runs": round(cs.median_ms(
                    torch, lambda: fused_ctx_pool(emb, run, mask, True)), 4)}
                for name, lib, plan, _ in runs:
                    if case != "probe" and name in PLANS:
                        continue
                    build._LIBS["probe_hbm_dma"] = lib
                    probes.run_pool_plan = plan
                    got = probes.run_pool(emb, idx, mask)
                    torch.cuda.synchronize()
                    if name not in SPLITS and not torch.equal(got, want):
                        raise RuntimeError("%s %s: not bitwise kernel 1 on "
                                           "the run indices" % (name, case))
                    times[name] = round(cs.median_ms(
                        torch, lambda: probes.run_pool(emb, idx, mask)), 4)
                print("round %d %s %s" % (round_, case, json.dumps(times)),
                      flush=True)
        for name, _, plan, _ in runs:
            print(name, plan(probe_hbm_dma.M, R, emb.clip.shape[1],
                             emb.tr1.shape[1]), flush=True)
    finally:
        build._LIBS["probe_hbm_dma"] = built_lib
        probes.run_pool_plan = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
