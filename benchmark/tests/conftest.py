"""Shared set-up of the benchmark's tests: the benchmark's directory and
the checkout on the import path, and a toy checkout made in a temporary
directory (tests/toy.py)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
