"""Run one cell of the benchmark of ``lirec_tpu_torch`` once, from the root
of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cells, their configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the root; harness/runner.py says what a run does.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))  # the checkout: the program

from harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
