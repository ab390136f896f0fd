"""Readings that the limits of a cell's comparison are set from (the
benchmark's own runs do not run this): for each seed, at the cell's own
size, the numbers the run compares for the program, for the control (the
plain reference computed in float8 e4m3 in the program's place: the
configuration computes in bfloat16), and for the faults a cell can have
in the program's place. One JSON line per seed.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness.cells import Spec  # noqa: E402
from harness.runner import Context, OUT_DIR, forbidden_modules  # noqa: E402


# the faults are planted in the program (a build and a capture each) on
# this many of the first seeds
PLANTED_SEEDS = 3


def readings(workload, seeds, root, device="cuda", bench_dir=HERE):
    """Yield one seed's readings at a time ({"program": {number: value},
    "control": ..., fault: ..., "seed", "seconds"}); the faults planted in
    the program on the first PLANTED_SEEDS seeds."""
    import torch

    torch.set_num_threads(1)  # as a run sets it
    spec = Spec(root, bench_dir)
    ctx = Context(spec, spec.cell(workload), argparse.Namespace(
        seed=seeds[0], seconds=0.0, trace=0), device, time.perf_counter(),
        os.path.join(root, OUT_DIR))
    kind = spec.kind(ctx.mix)
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        row = kind.readings(ctx, seed, ctx.reference.fp8_quant,
                            planted=i < PLANTED_SEEDS)
        row.update(seed=seed, seconds=time.perf_counter() - t)
        yield row
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for row in readings(args.workload, args.seeds, os.getcwd()):
        print(json.dumps(row), flush=True)
    bad = forbidden_modules()
    if bad:
        print("error: loaded %s" % bad, file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
