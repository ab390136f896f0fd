"""Where the counting sort should stop sorting in one pass, on one CUDA card:
``count_sort`` on the train step's 23,040 updates of three tables (a
quarter of them on row 0, as the masked ctx slots) into tables of
S = 13,568 (the Localizer's caps) to 61,440 rows (split-scale), once as
``sort_plan`` rules and once with ``SORT_MATRIX_INTS`` moved so the case
takes the other path: one pass over the S + 2 buckets, or passes by digit.

    python -m lirec_tpu_torch.tools.sort_passes

For each case and path: the passes, the median ms (L2 flushed, as
``chip_smoke.median_ms``) and the device ms of each launch
(``torch.profiler``); each sort is first checked bitwise against
``sort_by_row``. The last line is ``RESULT <json>``. Needs a CUDA card;
exits 2 without one.
"""

from __future__ import annotations

import json
import os
import sys

# clip rows of the three tables (the track tables twice as many): S = 5 x
CLIP_ROWS = (2816, 4096, 6144, 8192, 12288)
UPDATES = 23040


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
    shipped = sa.SORT_MATRIX_INTS
    g = torch.Generator(device="cuda").manual_seed(17)
    out = {}
    for clip in CLIP_ROWS:
        rows = (clip, 2 * clip, 2 * clip)
        idx = torch.stack([torch.randint(0, n, (UPDATES,), device="cuda",
                                         generator=g) for n in rows], 1)
        idx[torch.rand(UPDATES, device="cuda", generator=g) < 0.25] = 0
        idx = idx.to(torch.int32).contiguous()
        want = sa.sort_by_row(idx, rows)
        units = sa.sort_plan(idx.numel(), rows)["units"]
        # the matrix that takes one pass, and one that takes two
        for label, cap in (("one pass", units * (sum(rows) + 2)),
                           ("by digit", units * (sum(rows) + 2) - 1)):
            sa.SORT_MATRIX_INTS = cap
            try:
                passes = sa.sort_plan(idx.numel(), rows)["passes"]
                got = sa.count_sort(idx, rows)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise RuntimeError("%s at S = %d differs from "
                                       "sort_by_row" % (label, sum(rows)))
                ms = cs.median_ms(torch, lambda: sa.count_sort(idx, rows))
                split = cs.launch_split_ms(torch,
                                           lambda: sa.count_sort(idx, rows))
            finally:
                sa.SORT_MATRIX_INTS = shipped
            ruled = (units * (sum(rows) + 2) <= shipped) == (passes == 1)
            print("S = %6d %-8s %d pass(es), %.4f ms%s; device ms per "
                  "launch %s" % (sum(rows), label, passes, ms,
                                 " (the rule's)" if ruled else "",
                                 {k.split("<")[0]: round(v, 4)
                                  for k, v in split.items()}), flush=True)
            out["%d %s" % (sum(rows), label)] = dict(passes=passes, ms=ms,
                                                     split=split)
    print("RESULT", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
