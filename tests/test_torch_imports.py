"""lirec_tpu_torch never imports jax, flax, optax or msgpack, nor anything
of the JAX package lirec_tpu or of the repo-root tools/ directory (the TPU
probes), not even transitively or at run time (its target
machine has no jax; the port carries its own copy of the host tier and its
own msgpack decoder and encoder); neither do the rank processes that
parallel/dist.spawn starts, nor the rank functions of the two-rank tests
(tests/torch_dist_worker.py); and
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
import tests.torch_dist_worker  # noqa: F401
bad = sorted(m for m in sys.modules if m.split(".")[0]
             in ("jax", "jaxlib", "flax", "optax", "msgpack", "lirec_tpu",
                 "tools"))
print(len(names), "modules")
print("BAD", bad)
"""


_RUN_WITHOUT_JAX = r"""
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "msgpack", "lirec_tpu", "tools"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import math, os
import torch
from lirec_tpu_torch import config as config_lib
from lirec_tpu_torch.cli import common, int_rel_ch
from lirec_tpu_torch.cli import train as train_cli
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

store = os.path.join(root, "store")
out = train_cli.main(["--data-root", root, "--store-root", store,
                      "--batch-size", "8", "--device", "cpu", "--quiet",
                      "--sanity-check", "--epochs", "1",
                      "--checkpoint-every", "1"] + dims)
assert all(math.isfinite(v) for v in out["train"]["losses"])
assert os.path.exists(os.path.join(store, "latest.pth.tar"))
from lirec_tpu_torch.tools import probe_bf16_pack, probe_hbm_dma
probe_hbm_dma.measure("cpu", n_clips=64, n_tracks=96, m=8)
probe_bf16_pack.measure("cpu", {"probe": probe_bf16_pack.SHAPES["probe"]})
print("TRAIN_CLI", out["train"]["losses"])

# the text-only CLI: one epoch, then the eval of the JAX package's .ckpt
from lirec_tpu_torch.checkpoint import load_jax_checkpoint
from lirec_tpu_torch.cli import text_only
text_root, ckpt = sys.argv[2], sys.argv[3]
state, adam, epoch = load_jax_checkpoint(ckpt)
assert state and adam is None and epoch == 4, (adam, epoch)
text = ["--data-root", text_root, "--store-root", os.path.join(root, "st"),
        "--text-dim", "16", "--text-layers", "4", "--joint-dim", "16",
        "--batch-size", "8", "--device", "cpu", "--quiet"]
out = text_only.main(text + ["--train", "--epochs", "1"])
assert all(math.isfinite(v) for v in out["train"]["losses"])
metrics = text_only.main(text + ["--resume-path", ckpt])
assert all(math.isfinite(v) for m in metrics.values() for v in m.values())
print("TEXT_ONLY", sorted(metrics))


def main():
    # rank processes start from a fresh interpreter: each reports what it
    # imported, after running the two-rank training CLI's entry
    from lirec_tpu_torch.parallel import dist
    from tests import torch_dist_worker

    ranks = dist.spawn(torch_dist_worker.foreign_modules, 2, timeout=240)
    print("RANKS", [r.value for r in ranks])


if __name__ == "__main__":
    main()
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


def _jax_text_only_ckpt(root, path):
    """A save_params .ckpt of the JAX package's text-only model, sized for
    the fixture at `root` (written here, where flax may be imported)."""
    from lirec_tpu.checkpoint import save_params
    from lirec_tpu.data.text_dataset import TextOnlyDataset, preset_text_only
    from lirec_tpu.models.factory import create_model as jax_create_model

    cfg = preset_text_only(data_root=root).with_dims(
        text_dim=16, visual_dim=0, text_layers=4, joint_dim=16)
    n_classes = TextOnlyDataset(cfg, mode="train").n_classes
    save_params(path, jax_create_model(cfg, n_classes).params,
                extra={"epoch": 4})


def test_train_runs_with_jax_blocked(tmp_path):
    """In a process where importing jax, jaxlib, optax, flax, msgpack or
    anything of lirec_tpu raises, on a fixture from the port's own
    generator: one epoch of the port's train(), the serve CLI's engine
    builder, the int_rel_ch eval CLI, one epoch of the training CLI with
    cadence evaluation and checkpoints, the two probes on the CPU (the
    run-time paths: assembly plan, Localizer, native libraries, eval
    localisation, the sweep, the saver), and the text-only CLI's training
    and its eval of a .ckpt that the JAX package wrote."""
    from lirec_tpu_torch.data import synthetic

    text_root = str(tmp_path / "text")
    synthetic.generate(text_root)
    ckpt = str(tmp_path / "jax_text.ckpt")
    _jax_text_only_ckpt(text_root, ckpt)
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_WITHOUT_JAX, str(tmp_path / "mg"),
         text_root, ckpt],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOSSES [" in proc.stdout, proc.stdout
    assert "ENGINE" in proc.stdout and "CLI ['test', 'val']" in proc.stdout
    assert "TRAIN_CLI [" in proc.stdout, proc.stdout
    assert "TEXT_ONLY ['test', 'val']" in proc.stdout, proc.stdout
    assert "RANKS [[], []]" in proc.stdout, proc.stdout


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_source_names_no_jax_package_import():
    """No `import lirec_tpu...` / `from lirec_tpu... import` (nor of jax
    or the repo-root tools/) anywhere in the port (parallel/ included), in
    chip_smoke.py or in the two-rank tests' rank functions, at any depth
    of the code."""
    paths = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "torch_dist_worker.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "lirec_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 40
    bad = [(os.path.relpath(p, ROOT), m) for p in paths
           for m in _imported_modules(p)
           if m.split(".")[0] in ("lirec_tpu", "jax", "jaxlib", "flax",
                                  "optax", "msgpack", "tools")]
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
