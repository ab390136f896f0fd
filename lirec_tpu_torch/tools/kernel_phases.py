"""Phases 3 and 6 of ``chip_smoke.py``, and phase 11's holds and times,
alone, on one CUDA card, against the kernels of a checkout: the pool
kernels (the 3-table pool on the eval sweep's batch, the triple kernel and
one batch's ctx pool in each tier, the masked sum), the probe kernels
(kernel 9 at the pool probe's inputs beside kernel 1 on the same runs and
the three-``embedding_bag`` yardstick; kernel 10 at the bf16 probe's two
shapes beside kernel 5 on the native bf16 table and ``embedding_bag``;
``chip_smoke.probe_checks``), and the scatter (at the Localizer's tables,
and its split-scale, all-into-8-rows, flattened and single-table cases),
each against its plain version, with median times (L2 flushed), bounds
and the scatter's device time per launch inside the op.

    python lirec_tpu_torch/tools/kernel_phases.py [TREE] [--label L]
        [--scatter]

TREE (default: this checkout) is the root of a checkout whose
``lirec_tpu_torch`` (kernels and wrappers) is imported; the phase code is
this checkout's ``chip_smoke.py``. So a parent and a change are measured
in one call, in turns, by the same code (unpack the parent with ``git
archive`` into a git-ignored directory). Run it by path, not with ``-m``:
the package must come from TREE. ``--scatter`` runs the scatter's phase
alone. The phases' lines go to stdout, and last a line ``RESULT <L>
<json>`` with the numbers.
"""

import importlib.util
import json
import os
import sys
import time


def main(argv) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    label = "change"
    if "--label" in argv:
        k = argv.index("--label")
        label = argv[k + 1]
        del argv[k:k + 2]
    scatter_only = "--scatter" in argv
    if scatter_only:
        argv.remove("--scatter")
    tree = os.path.abspath(argv[0]) if argv else here
    sys.path.insert(0, tree)
    import lirec_tpu_torch
    import torch

    got = os.path.dirname(os.path.dirname(os.path.abspath(
        lirec_tpu_torch.__file__)))
    if got != tree:
        raise RuntimeError("lirec_tpu_torch came from %s, not %s"
                           % (got, tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from lirec_tpu_torch.models.spec import ModelSpec
    from lirec_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(label, tree, cs.card_line(), flush=True)
    t0 = time.perf_counter()
    sources = ("fused_ctx_pool", "scatter_accum", "fused_ctx_pool_triple",
               "probe_hbm_dma", "probe_bf16_pack")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    print("built in %.1f s" % (time.perf_counter() - t0), flush=True)
    model = ModelSpec(n_classes=101, n_rels=15)
    out = {} if scatter_only else {"triple": cs.triple_checks(torch, model),
                                   "probes": cs.probe_checks(torch)}
    raw, local, caps = cs.train_batches(model)
    out["caps"] = caps
    out["scatter"] = cs.scatter_checks(torch, model, raw[0], local[0], caps)
    print("RESULT", label, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
