"""Where the scatter's time goes at the train step's shapes, on one CUDA card:
the kernel as built beside variants of ``csrc/scatter_accum.cu`` that each
leave part of the work out.

    python -m lirec_tpu_torch.tools.scatter_variants

The inputs are ``chip_smoke.py`` phase 6's train-path case: one
structured B = 64 batch localized by the port's Localizer (tables of
``caps`` rows), updates 1024 / 512 / 512 wide, f32 and bf16. Variants:

- ``built``: the kernel as the wrapper launches it;
- ``hot_only``: the hot tiles (long rows), no short items;
- ``adder_only``: ``hot_only`` with the copier warps issuing no copies:
  the adder warp's in-order chain and the ring's handshakes alone;
- ``short_only``: the short items; the hot blocks exit.

For each: the median ms of the kernel on updates the built counting sort
ordered (L2 flushed, as ``chip_smoke.median_ms``) and the device ms of
each launch inside it (``torch.profiler``). Only
``built`` computes the whole sum; it is checked bitwise against the CPU's
in-order sum. The variants are built with nvcc into
``lirec_tpu_torch/_build/variants/``. Needs a CUDA card; exits 2 without
one.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

# the variants, as substitutions of csrc/scatter_accum.cu
_NO_SHORT = (r"  if \(n_items > 0\) \{\n    scatter_short_kernel",
             "  if (0) {\n    scatter_short_kernel")
_NO_COPY = (r"if \(copies && p \* kRowsPerPass < left\)", "if (0)")
_NO_HOT = (r"  if \(static_cast<int>\(blockIdx\.x\) >= n_hot\) return;",
           "  if (n_hot >= 0) return;")
VARIANTS = {
    "hot_only": (_NO_SHORT,),
    "adder_only": (_NO_SHORT, _NO_COPY),
    "short_only": (_NO_HOT,),
}


def _build_variant(name, subs):
    from lirec_tpu_torch.ops import build

    src = build.source_path("scatter_accum").read_text()
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        if n != 1:
            raise RuntimeError("variant %s: %r matched %d times"
                               % (name, pat, n))
    out = build.source_path("scatter_accum").parent.parent / "_build" / \
        "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / ("scatter_accum_%s.cu" % name)
    cu.write_text(src)
    so = out / ("libscatter_accum_%s.so" % name)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scatter_variants: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke as cs

    from lirec_tpu_torch.models.spec import ModelSpec
    from lirec_tpu_torch.ops import build
    from lirec_tpu_torch.ops import scatter_accum as sa

    print(cs.card_line(), flush=True)
    libs = {"built": build.load("scatter_accum")}
    libs.update((name, _build_variant(name, subs))
                for name, subs in VARIANTS.items())
    spec = ModelSpec(n_classes=101, n_rels=15)
    _, local, caps = cs.train_batches(spec)
    idx = cs.ctx_idx(torch, local[0]).reshape(-1, 3)
    rows = (caps[0], caps[1], caps[1])
    g = torch.Generator(device="cuda").manual_seed(6)
    base = [torch.randn(idx.shape[0], d, device="cuda", generator=g)
            for d in (1024, 512, 512)]
    for dtype in (torch.float32, torch.bfloat16):
        gs = [t.to(dtype).contiguous() for t in base]
        perm, offsets, workspace = sa.sort_updates(idx, gs, rows)
        want = sa.scatter_accum3_reference(idx.cpu(), *(t.cpu() for t in gs),
                                           *caps)
        for name, lib in libs.items():
            build._LIBS["scatter_accum"] = lib
            outs = [torch.empty(r, t.shape[1], device="cuda")
                    for r, t in zip(rows, gs)]

            def run():
                sa.launch_sorted(gs, outs, perm, offsets, workspace)

            run()
            torch.cuda.synchronize()
            note = ""
            if name == "built":
                same = all(torch.equal(o.cpu(), w) for o, w in zip(outs, want))
                if not same:
                    raise RuntimeError("the built scatter is not the in-order "
                                       "sum")
                note = ", bitwise the in-order sum"
            ms = cs.median_ms(torch, run)
            split = cs.launch_split_ms(torch, run)
            print("%s %-10s %.4f ms%s; device ms per launch %s" % (
                str(dtype).split(".")[1], name, ms, note,
                {k.split("<")[0]: round(v, 4) for k, v in split.items()}),
                flush=True)
        build._LIBS["scatter_accum"] = libs["built"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
