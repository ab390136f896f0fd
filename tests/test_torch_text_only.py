"""The port's text-only ablation (data/text_dataset.py, cli/text_only.py)
against the JAX package's, on the CPU: the Modalities model with modality
't' on 0-wide visual and track tables, trained through the port's
train(), evaluated through the host loop, from the port's own
checkpoints and from the JAX package's msgpack ``.ckpt`` files."""

import os

import numpy as np
import pytest
import torch

from lirec_tpu.checkpoint import params_from_torch_state_dict
from lirec_tpu.cli import text_only as jax_text_only
from lirec_tpu.data.text_dataset import TextOnlyDataset as JaxTextOnly
from lirec_tpu.data.text_dataset import preset_text_only as jax_preset
from lirec_tpu.evaluation.runner import evaluate as jax_evaluate
from lirec_tpu.models.factory import create_model as jax_create_model
from lirec_tpu_torch.checkpoint import load_torch_checkpoint
from lirec_tpu_torch.cli import text_only

DIMS = ["--text-dim", "16", "--text-layers", "4", "--joint-dim", "16",
        "--batch-size", "8", "--quiet"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    for split in ("val", "test"):
        assert set(got[split]) == set(want[split]) == {"total", "ints",
                                                       "loss"}
        for key, v in want[split].items():
            np.testing.assert_allclose(got[split][key], v, rtol=2e-6,
                                       atol=1e-7, err_msg=key)


def test_cli_trains_and_evaluates_its_own_checkpoint(synth_root, tmp_path):
    """--train for 2 epochs (finite losses; the cadence evaluation takes
    the host loop), then the eval of the written 1.pth.tar: the JAX
    package's host eval of the same weights gives the same metrics."""
    store = str(tmp_path / "st")
    base = ["--data-root", synth_root, "--store-root", store] + DIMS
    out = text_only.main(base + ["--train", "--epochs", "2", "--device",
                                 "cpu"])
    losses = out["train"]["losses"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    ckpt = os.path.join(store, "1.pth.tar")
    got = text_only.main(base + ["--resume-path", ckpt, "--device", "cpu"])

    cfg = jax_preset(data_root=synth_root, store_root=store).with_dims(
        text_dim=16, visual_dim=0, text_layers=4, joint_dim=16
    ).with_runtime(compute_dtype="float32").with_optim(batch_size=8)
    train_ds = JaxTextOnly(cfg, mode="train")
    train_ds.cache()
    bundle = jax_create_model(cfg, train_ds.n_classes)
    params = params_from_torch_state_dict(load_torch_checkpoint(ckpt)[0])
    want = {}
    for mode in ("val", "test"):
        ds = JaxTextOnly(cfg, mode=mode)
        ds.cache()
        want[mode] = jax_evaluate(ds, bundle, params, cfg, mode=mode,
                                  verbose=False)
    _close(got, want)


def test_eval_of_jax_ckpt_files_gives_the_jax_metrics(synth_root, tmp_path):
    """The JAX text-only CLI trains one epoch and writes its train state
    0.ckpt and its best-n save_params files; the port's text-only CLI
    evaluates each of them to the JAX CLI's metrics."""
    store = str(tmp_path / "jst")
    base = ["--data-root", synth_root, "--store-root", store] + DIMS
    jax_text_only.main(base + ["--train", "--epochs", "1"])
    best = os.path.join(store, "total",
                        os.listdir(os.path.join(store, "total"))[0])
    for path in (os.path.join(store, "0.ckpt"), best):
        want = jax_text_only.main(base + ["--resume-path", path])
        got = text_only.main(base + ["--resume-path", path, "--device",
                                     "cpu"])
        _close(got, want)
