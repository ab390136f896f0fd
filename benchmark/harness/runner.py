"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result's line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's traffic kind (``traffic/<kind>.py``) does the work through a
``Context``; this module reads what it measured, the trace (``--trace 1``)
through the per-layer metrics' readers, checks that no JAX module was
loaded, and prints the comparison's numbers beside their limits as the
last lines on standard error and the result as the last line on standard
output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

from harness.cells import BENCH_DIR, Spec
from harness.trace import (NothingToRead, TraceView, WINDOW_SPAN,
                           load_events, profiled)

__all__ = ["main", "Context", "forbidden_modules", "FORBIDDEN"]

# top-level module names no run may load: JAX and the JAX package (the
# port's own name begins with the latter's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "lirec_tpu")
# the checkout's fixed directories for what a run leaves: the kernel caches
# a library may keep, and the traced window's trace
CACHE_DIR = ".benchcache"
OUT_DIR = ".benchout"


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among the loaded modules'."""
    loaded = {n.split(".", 1)[0] for n in
              (sys.modules if names is None else names)}
    return sorted(loaded & set(FORBIDDEN))


class Context:
    """What a traffic kind's ``run`` gets: the cell's data, the run's
    arguments, its device, and the spans and clocks of the run."""

    def __init__(self, spec: Spec, cell: Dict, args, device: str, t0: float,
                 out_dir: str):
        self.spec, self.cell = spec, cell
        self.cfg = spec.config(cell["config"])
        self.mix = spec.mix(cell["traffic"])
        self.limits = spec.limits(cell["name"])
        self.reference = spec.reference(self.cfg)
        model = {k: self.cfg[k] for k in self.reference.MODEL}
        if model != self.reference.MODEL:
            raise ValueError("configuration %s is %s; its reference computes "
                             "%s" % (cell["config"], model,
                                     self.reference.MODEL))
        self.seed, self.seconds = args.seed, args.seconds
        self.trace = bool(args.trace)
        self.device = device
        self.t0 = t0
        self.setup_s: Optional[float] = None
        self.unit_ends: List[float] = []
        self.trace_path = os.path.join(out_dir, "trace-%s.json"
                                       % cell["name"])

    def span(self, name: str):
        """A host span of the benchmark in the trace (traced runs only)."""
        if not self.trace:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def note(self, what: str) -> None:
        """A line on standard error: how far into the run `what` is."""
        print("at %.3f s: %s" % (time.perf_counter() - self.t0, what),
              file=sys.stderr)

    def setup_done(self) -> None:
        """Set-up ends here: the next thing is the window's first unit."""
        self.setup_s = time.perf_counter() - self.t0

    def unit_done(self, elapsed: float) -> None:
        """A unit of the window (a sweep, an epoch) ended `elapsed` seconds
        into it."""
        self.unit_ends.append(elapsed)

    def note_window(self) -> None:
        """A line on standard error: the window's units, and the mean
        seconds of a unit in each quarter of them (how steady the window
        ran)."""
        ends = [0.0] + self.unit_ends
        n = len(ends) - 1
        if n < 4:
            return
        cut = [round(n * q / 4) for q in range(5)]
        means = ["%.6f" % ((ends[b] - ends[a]) / (b - a))
                 for a, b in zip(cut, cut[1:])]
        print("window: %d units in %.3f s; mean unit s by quarter: %s"
              % (n, ends[-1], " ".join(means)), file=sys.stderr)

    @contextlib.contextmanager
    def window(self):
        with profiled(self.trace_path, self.trace):
            with self.span(WINDOW_SPAN):
                yield


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def main(argv, t0: float, root: Optional[str] = None,
         device: Optional[str] = None, bench_dir: Optional[str] = None
         ) -> int:
    """Run a cell once and print its result; the exit code. `device`: None
    on the card (the run refuses to start without enough of them); tests
    pass "cpu" to drive the rest of a run without one."""
    args = _parse(argv)
    root = os.path.abspath(root or os.getcwd())
    spec = Spec(root, bench_dir or BENCH_DIR)
    cell = spec.cell(args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print("error: %s needs %d CUDA card(s); this machine has %s"
                  % (cell["name"], cell["chips"],
                     torch.cuda.device_count() if torch.cuda.is_available()
                     else "none"), file=sys.stderr)
            return 3
        device = "cuda"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(root, CACHE_DIR, sub)
    # one intra-op thread: the host's share of a run is one thread's work,
    # and a pool of them contending with it makes runs spread
    torch.set_num_threads(1)
    out_dir = os.path.join(root, OUT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    ctx = Context(spec, cell, args, device, t0, out_dir)
    outcome = spec.kind(ctx.mix).run(ctx)
    ctx.note_window()

    bad = forbidden_modules()
    if bad:
        print("error: the run loaded %s (JAX or the JAX package)" % bad,
              file=sys.stderr)
        return 4

    on_card = device.startswith("cuda")
    kind = torch.cuda.get_device_name(0) if on_card else device
    dev = {"platform": "gpu" if on_card else device, "kind": kind,
           "count": cell["chips"],
           "memory_peak_bytes": outcome["memory_peak_bytes"]}
    metrics: Dict[str, Dict] = {}
    result: Dict = {}
    if not ctx.trace:
        values = dict(outcome["end_to_end"], setup_s=ctx.setup_s)
        for m in spec.end_to_end(cell["name"]):
            # <quantity>.<group>: the quantity, bounded for a group of
            # cells apart
            name = m["name"] if m["name"] in values else \
                m["name"].split(".", 1)[0]
            metrics[m["name"]] = {"value": values[name], "unit": m["unit"]}
    else:
        view = TraceView(load_events(ctx.trace_path), outcome["counts"],
                         kind, outcome["capture_s"])
        for m in spec.per_layer(cell["name"]):
            reader = spec.metric_module(m)
            try:
                value = reader.read(view)
            except NothingToRead as e:
                print("error: per-layer metric %s read nothing: %s"
                      % (m["name"], e), file=sys.stderr)
                continue
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=view.busy_s, window_s=view.window_s)
        result["breakdown"] = {"device_ops": view.top_ops(),
                               "idle_gaps": view.idle_gaps()}

    checks = outcome["checks"]
    correct = (outcome["failed"] == 0 and
               all(_finite(v) and v <= lim for v, lim in checks.values()))
    line = {"correct": correct, "attempted": outcome["attempted"],
            "failed": outcome["failed"], "metrics": metrics,
            "device": dev}
    line.update(result)
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print("check %s %r limit %r" % (k, v, lim), file=sys.stderr)
    print("check failed %d of %d attempted limit 0"
          % (outcome["failed"], outcome["attempted"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0
