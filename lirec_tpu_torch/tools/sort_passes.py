"""Where the counting sort should stop sorting in one pass, and which tile
the sort by digits should take, on one CUDA card: ``count_sort`` on the
train step's updates of three tables (360 a sample and table, a quarter of
them on row 0, as the masked ctx slots) at B = 64, 128, 256, 512 and 1,024
(69,120 to 1,105,920 positions) into split-scale tables (12,288 / 24,576 /
24,576 rows) and, at B = 64 and 1,024, into the Localizer's caps at B = 64
(2,816 / 5,376 / 5,376): in one pass over the S + 2 buckets, and by digits
of 8 bits in tiles of ``SORT_SMALL_TILE`` and of ``SORT_TILE`` positions
(``SORT_MATRIX_INTS`` and ``SORT_LARGE_TILES`` moved so the case takes
each path), beside ``torch.sort(stable=True)`` of the keys alone.

    python -m lirec_tpu_torch.tools.sort_passes

For each case and path: the passes, the median ms (L2 flushed, as
``chip_smoke.median_ms``), the device ms of each launch
(``torch.profiler``) and which path and tile ``sort_plan``'s rule takes;
each sort is first checked bitwise against ``sort_by_row``. The last line is ``RESULT
<json>``. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import json
import os
import sys

SPLIT = (12288, 24576, 24576)
CAPS = (2816, 5376, 5376)
CASES = ((64, SPLIT), (128, SPLIT), (256, SPLIT), (512, SPLIT),
         (1024, SPLIT), (64, CAPS), (1024, CAPS))
PER_SAMPLE = 360  # updates of a table a sample: T = 20 x R = 18


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sort_passes: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke as cs

    from lirec_tpu_torch.ops import scatter_accum as sa

    print(cs.card_line(), flush=True)
    shipped = sa.SORT_MATRIX_INTS, sa.SORT_LARGE_TILES
    g = torch.Generator(device="cuda").manual_seed(17)
    out = {}
    for batch, rows in CASES:
        M = batch * PER_SAMPLE
        idx = torch.stack([torch.randint(0, n, (M,), device="cuda",
                                         generator=g) for n in rows], 1)
        idx[torch.rand(M, device="cuda", generator=g) < 0.25] = 0
        idx = idx.to(torch.int32).contiguous()
        want = sa.sort_by_row(idx, rows)
        ruled = sa.sort_plan(idx.numel(), rows)
        keys = idx.reshape(-1)
        library_ms = cs.median_ms(torch, lambda: torch.sort(keys,
                                                            stable=True))
        matrix = ruled["units"] * (sum(rows) + 2)
        for label, cap, large in (("one pass", matrix, 1),
                                  ("small tiles", matrix - 1, 1 << 40),
                                  ("large tiles", matrix - 1, 1)):
            sa.SORT_MATRIX_INTS, sa.SORT_LARGE_TILES = cap, large
            try:
                sp = sa.sort_plan(idx.numel(), rows)
                got = sa.count_sort(idx, rows)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise RuntimeError("%s at B = %d into %s differs from "
                                       "sort_by_row" % (label, batch, rows))
                ms = cs.median_ms(torch, lambda: sa.count_sort(idx, rows))
                split = cs.launch_split_ms(torch,
                                           lambda: sa.count_sort(idx, rows))
            finally:
                sa.SORT_MATRIX_INTS, sa.SORT_LARGE_TILES = shipped
            rule = (sp["passes"], sp["tile"]) == (ruled["passes"],
                                                  ruled["tile"])
            print("B = %4d, S = %6d, %7d positions, %-11s %d pass(es), "
                  "%.4f ms%s, torch.sort %.4f; device ms per launch %s"
                  % (batch, sum(rows), idx.numel(), label, sp["passes"], ms,
                     " (the rule's)" if rule else "", library_ms,
                     {k.split("(")[0]: round(v, 4)
                      for k, v in split.items()}), flush=True)
            out["%d %d %s" % (batch, sum(rows), label)] = dict(
                passes=sp["passes"], tile=sp["tile"], ms=ms, rule=rule,
                library_ms=library_ms, split=split)
    print("RESULT", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
