"""lirec_tpu_torch never imports jax, flax or optax, not even transitively
or at run time (its target machine has no jax), and chip_smoke.py refuses
to run without a CUDA card or without the repository around it."""

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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
print(len(names), "modules")
print("BAD", bad)
"""


_TRAIN_WITHOUT_JAX = r"""
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Refuse())
from lirec_tpu import config as config_lib
from lirec_tpu.data import synthetic
from lirec_tpu.data.dataset import InteractionDataset
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
bundle = create_model(cfg, ds.n_classes, n_rels=max(len(ds.rels_list) - 1, 0))
out = train(cfg, bundle, ds, verbose=False, localize_tables=True)
assert out["localized_tables"], out
print("LOSSES", out["losses"])
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
    """One epoch of the port's train() on a synthetic fixture in a process
    where importing jax, jaxlib, optax or flax raises: the run-time paths
    (assembly plan, Localizer, the loop) stay off the JAX package's
    jax-importing modules."""
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_WITHOUT_JAX, str(tmp_path / "mg")],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOSSES [" in proc.stdout, proc.stdout


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
