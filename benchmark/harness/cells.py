"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, a configuration's file, a traffic mix's file and the module
of its kind, a per-layer metric's module, a configuration's reference
module and a cell's limits. Nothing here names a configuration, a mix or
a metric: a later cell brings its own files."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List

__all__ = ["Spec", "load_module", "BENCH_DIR"]

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_FIELDS = ("LAYER", "UNIT", "SOURCE", "MOVES")


def load_module(path: str, name: str) -> ModuleType:
    """The Python file at `path` as module `name` (file names may hold
    dots and dashes, as metric and mix names do)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _read(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the files it names, under the checkout at
    `root` (the benchmark's own files under `bench_dir`)."""

    def __init__(self, root: str, bench_dir: str = BENCH_DIR):
        self.root = root
        self.bench_dir = bench_dir
        self.doc = _read(os.path.join(root, "BENCHMARK.json"))

    def cell(self, workload: str) -> Dict:
        for w in self.doc["workloads"]:
            if w["name"] == workload:
                return w
        raise KeyError("no workload %r in BENCHMARK.json (it has %s)"
                       % (workload, [w["name"] for w in
                                     self.doc["workloads"]]))

    def config(self, name: str) -> Dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return _read(os.path.join(self.root, c["file"]))
        raise KeyError("no configuration %r in BENCHMARK.json" % name)

    def mix(self, traffic: str) -> Dict:
        return _read(os.path.join(self.bench_dir, "traffic",
                                  traffic + ".json"))

    def kind(self, mix: Dict) -> ModuleType:
        return load_module(os.path.join(self.bench_dir, "traffic",
                                        mix["kind"] + ".py"),
                           "bench_kind_" + mix["kind"])

    def reference(self, config: Dict) -> ModuleType:
        if self.bench_dir not in sys.path:
            sys.path.insert(0, self.bench_dir)
        return load_module(os.path.join(self.bench_dir, "reference",
                                        config["reference"] + ".py"),
                           "reference." + config["reference"])

    def limits(self, workload: str) -> Dict[str, float]:
        return _read(os.path.join(self.bench_dir, "limits",
                                  workload + ".json"))["limits"]

    def _applies(self, metric: Dict, workload: str) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    def end_to_end(self, workload: str) -> List[Dict]:
        return [m for m in self.doc["end_to_end"]
                if self._applies(m, workload)]

    def per_layer(self, workload: str) -> List[Dict]:
        """The per-layer metrics this cell reports: those that list it
        (every per-layer entry lists its cells)."""
        return [m for m in self.doc["per_layer"]
                if workload in m["workloads"]]

    def metric_module(self, metric: Dict) -> ModuleType:
        """A per-layer metric's reader, checked against its entry."""
        mod = load_module(os.path.join(self.bench_dir, "metrics",
                                       metric["name"] + ".py"),
                          "bench_metric_" + metric["name"])
        want = {"LAYER": metric["layer"], "UNIT": metric["unit"],
                "SOURCE": metric["source"], "MOVES": metric["moves"]}
        got = {k: getattr(mod, k, None) for k in METRIC_FIELDS}
        if got != want:
            raise ValueError("metrics/%s.py declares %s; BENCHMARK.json "
                             "says %s" % (metric["name"], got, want))
        return mod
