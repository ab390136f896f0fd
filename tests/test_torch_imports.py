"""lirec_tpu_torch never imports jax, flax or optax, nor anything of the
JAX package lirec_tpu, not even transitively or at run time (its target
machine has no jax; the port carries its own copy of the host tier), and
chip_smoke.py refuses to run without a CUDA card or without the repository
around it."""

import ast
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import lirec_tpu_torch
names = ["lirec_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(lirec_tpu_torch.__path__,
                                          "lirec_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules if m.split(".")[0]
             in ("jax", "jaxlib", "flax", "optax", "lirec_tpu"))
print(len(names), "modules")
print("BAD", bad)
"""


_RUN_WITHOUT_JAX = r"""
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "lirec_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import math, os
import torch
from lirec_tpu_torch import config as config_lib
from lirec_tpu_torch.cli import common, int_rel_ch
from lirec_tpu_torch.cli.serve import build_engine_from_args, make_parser
from lirec_tpu_torch.data import synthetic
from lirec_tpu_torch.data.dataset import InteractionDataset
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.train.loop import train

root = sys.argv[1]
synthetic.generate(root)
base = synthetic.make_config(root)
cfg = config_lib.preset("int_rel_ch", data_root=root)
cfg = cfg.replace(dims=base.dims, paths=base.paths).with_optim(
    batch_size=8, epochs=1, save_model=False)
ds = InteractionDataset(cfg, mode="train")
ds.cache()
ds.init_relships()
bundle = create_model(cfg, ds.n_classes, n_rels=max(len(ds.rels_list) - 1, 0),
                      device="cpu")
out = train(cfg, bundle, ds, verbose=False, localize_tables=True)
assert out["localized_tables"], out
print("LOSSES", out["losses"])

dims = ["--text-dim", "16", "--visual-dim", "32", "--text-layers", "4",
        "--joint-dim", "16"]
engine = build_engine_from_args(make_parser().parse_args(
    ["--data-root", root, "--device", "cpu"] + dims))
print("ENGINE", engine.bundle.spec.n_classes)

ckpt = os.path.join(root, "weights.pth.tar")
args = ["--data-root", root, "--resume-path", ckpt, "--batch-size", "8",
        "--device", "cpu", "--quiet"] + dims
cfg = common.config_from_args(
    "int_rel_ch", common.build_parser("int_rel_ch").parse_args(args))
train_ds, _, _ = common.build_datasets(cfg, "int_rel_ch")
model = create_model(cfg, train_ds.n_classes,
                     n_rels=max(len(train_ds.rels_list) - 1, 0),
                     device="cpu").model
torch.save({"state_dict": model.state_dict()}, ckpt)
metrics = int_rel_ch.main(args)
assert all(math.isfinite(v) for m in metrics.values() for v in m.values())
print("CLI", sorted(metrics))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    return env


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    n = int(proc.stdout.split()[0])
    assert n >= 15  # every module of the package was found and imported


def test_train_runs_with_jax_blocked(tmp_path):
    """In a process where importing jax, jaxlib, optax, flax or anything of
    lirec_tpu raises, on a fixture from the port's own generator: one epoch
    of the port's train(), the serve CLI's engine builder and the
    int_rel_ch eval CLI (the run-time paths: assembly plan, Localizer,
    native libraries, eval localisation, the sweep)."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_WITHOUT_JAX, str(tmp_path / "mg")],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOSSES [" in proc.stdout, proc.stdout
    assert "ENGINE" in proc.stdout and "CLI ['test', 'val']" in proc.stdout


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_source_names_no_jax_package_import():
    """No `import lirec_tpu...` / `from lirec_tpu... import` anywhere in
    the port or in chip_smoke.py, at any depth of the code."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "lirec_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 40
    bad = [(os.path.relpath(p, ROOT), m) for p in paths
           for m in _imported_modules(p)
           if m.split(".")[0] in ("lirec_tpu", "jax", "jaxlib", "flax",
                                  "optax")]
    assert bad == []


def test_chip_smoke_fails_without_a_card():
    assert not torch.cuda.is_available()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository it must fail and print no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
