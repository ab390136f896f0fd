"""The port's ``convert-checkpoint`` (lirec_tpu_torch/cli/convert_checkpoint.py)
against the JAX package's CLI: the ``.ckpt`` it writes from a reference
``.pth.tar`` is byte for byte the JAX CLI's (with an epoch and without
one, wrapped in DataParallel's ``module.`` prefix or not), the eval CLIs
of both packages read it, and ``--verify`` is refused by name where the
reference tree is absent; its comparison runs only where that tree is
(tests/test_checkpoint_import.py's cases, skipped as they are).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from lirec_tpu.checkpoint import load_params
from lirec_tpu.cli import convert_checkpoint as jax_cc
from lirec_tpu_torch import config as config_lib
from lirec_tpu_torch.checkpoint import load_jax_checkpoint
from lirec_tpu_torch.cli import common
from lirec_tpu_torch.cli import convert_checkpoint as cc
from lirec_tpu_torch.compat import reference as bridge
from lirec_tpu_torch.models.factory import create_model
from tests.jax_cache_guard import isolated_xla_cache  # noqa: F401

TEXT, VIS, JOINT = 16, 32, 16
PRESETS = [("modalities", 0), ("int_rels", 6), ("int_ch", 0),
           ("int_rel_ch", 6)]
DIM_ARGS = ["--text-dim", "16", "--visual-dim", "32", "--text-layers", "4",
            "--joint-dim", "16", "--compute-dtype", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state_dict(preset, n_rels, seed=0):
    cfg = config_lib.preset(preset, data_root="/nonexistent").with_dims(
        text_dim=TEXT, visual_dim=VIS, joint_dim=JOINT)
    return create_model(cfg, 7, n_rels=n_rels, seed=seed,
                        device="cpu").model.state_dict()


def _convert_both(src, tmp_path):
    want, got = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    out = (jax_cc.main(["--src", src, "--dst", want]),
           cc.main(["--src", src, "--dst", got]))
    with open(want, "rb") as f:
        want_bytes = f.read()
    with open(got, "rb") as f:
        got_bytes = f.read()
    return out, want_bytes, got_bytes, got


@pytest.mark.parametrize("epoch", [3, None])
@pytest.mark.parametrize("preset,n_rels", PRESETS)
def test_the_ckpt_is_the_jax_clis_byte_for_byte(tmp_path, preset, n_rels,
                                                epoch):
    """A reference-format .pth.tar ({'epoch', 'state_dict', 'optimizer'};
    without 'epoch' the file's extra epoch is None): the same bytes as the
    JAX CLI's file, the same result, and the weights read back bitwise."""
    sd = _state_dict(preset, n_rels)
    payload = {"state_dict": sd, "optimizer": {}}
    if epoch is not None:
        payload["epoch"] = epoch
    src = str(tmp_path / "m.pth.tar")
    torch.save(payload, src)
    (want, got), want_bytes, got_bytes, path = _convert_both(src, tmp_path)
    assert got == want == {"layers": len(sd) // 2, "epoch": epoch}
    assert got_bytes == want_bytes
    state, adam, read_epoch = load_jax_checkpoint(path)
    assert adam is None and read_epoch == (epoch or 0)
    assert list(state) == list(sd)
    for key, value in sd.items():
        assert torch.equal(state[key], value), key


def test_a_data_parallel_checkpoint_converts_as_the_jax_cli(tmp_path):
    """DataParallel's ``module.`` prefix, a batch-norm counter and a
    non-tensor entry: skipped or stripped as the JAX CLI does, the same
    bytes."""
    sd = {"module." + k: v for k, v in _state_dict("int_ch", 0).items()}
    sd["module.bn.num_batches_tracked"] = torch.tensor(5)
    sd["step_counter"] = 7
    src = str(tmp_path / "dp.pth.tar")
    torch.save({"epoch": 1, "state_dict": sd}, src)
    (want, got), want_bytes, got_bytes, _ = _convert_both(src, tmp_path)
    assert got == want and got_bytes == want_bytes


def test_both_eval_clis_read_the_converted_ckpt(synth_root, tmp_path):
    """The port's eval CLI on the converted .ckpt gives its metrics on the
    .pth.tar exactly; the JAX package's load_params reads the file."""
    argv = ["--data-root", synth_root, "--batch-size", "8", "--quiet",
            "--device", "cpu"] + DIM_ARGS
    cfg = common.config_from_args(
        "int_rel_ch", common.build_parser("int_rel_ch").parse_args(argv))
    train_ds, _, _ = common.build_datasets(cfg, "int_rel_ch")
    model = create_model(cfg, train_ds.n_classes,
                         n_rels=max(len(train_ds.rels_list) - 1, 0),
                         seed=5, device="cpu").model
    src, dst = str(tmp_path / "w.pth.tar"), str(tmp_path / "w.ckpt")
    torch.save({"epoch": 2, "state_dict": model.state_dict()}, src)
    cc.main(["--src", src, "--dst", dst])
    want = common.run_entry("int_rel_ch", argv + ["--resume-path", src])
    got = common.run_entry("int_rel_ch", argv + ["--resume-path", dst])
    assert got == want
    params = load_params(dst)
    np.testing.assert_array_equal(
        np.asarray(params["out_ints"]["kernel"]),
        model.state_dict()["out_ints.weight"].numpy().T)


@pytest.mark.parametrize("preset,n_rels", PRESETS)
def test_inferred_config_is_the_jax_clis(preset, n_rels):
    """Dims and head sizes read from the checkpoint's shapes: the JAX CLI's
    config and counts."""
    sd = _state_dict(preset, n_rels)
    cfg, n_classes, got_rels = cc._infer_cfg(preset, sd)
    params = {k.rsplit(".", 1)[0].replace("gates_ints.fc_out",
                                          "gates_ints"): {} for k in sd}
    for key, value in sd.items():
        base, kind = key.rsplit(".", 1)
        base = "gates_ints" if base == "gates_ints.fc_out" else base
        params[base]["kernel" if kind == "weight" else "bias"] = (
            value.numpy().T if kind == "weight" else value.numpy())
    want_cfg, want_classes, want_rels = jax_cc._infer_cfg(preset, params)
    assert (n_classes, got_rels) == (want_classes, want_rels) == (7, n_rels)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)


def test_verify_is_refused_without_the_reference_tree(tmp_path):
    """--verify names the missing tree and the flag and variable that set
    it (the JAX CLI's message), after writing the .ckpt."""
    src = str(tmp_path / "m.pth.tar")
    torch.save({"epoch": 1, "state_dict": _state_dict("int_ch", 0)}, src)
    missing = str(tmp_path / "no_reference")
    with pytest.raises(SystemExit, match="--verify needs the reference repo "
                       "at .*no_reference.*LIREC_TPU_REFERENCE"):
        cc.main(["--src", src, "--dst", str(tmp_path / "m.ckpt"),
                 "--verify", "--preset", "int_ch", "--reference", missing,
                 "--device", "cpu"])
    assert os.path.exists(tmp_path / "m.ckpt")
    assert cc.main(["--src", src, "--dst", str(tmp_path / "m2.ckpt")])[
        "epoch"] == 1


@pytest.mark.parametrize(
    "preset,ref_cls,n_rels",
    [
        ("modalities", "Modalities", 0),
        ("int_rels", "MidFusionMultiClip", 6),
        ("int_ch", "MidFusionMultiClipMaxTracks", 0),
        ("int_rel_ch", "MidFusionMultiClipMaxTracks", 6),
    ],
)
def test_convert_verify_cli(tmp_path, preset, ref_cls, n_rels):
    """`convert-checkpoint --verify --device cpu`: synthesized reference
    checkpoints for every preset convert and pass the activation
    comparison against the live torch reference. Skips without the
    reference tree, as the JAX package's test does."""
    if not bridge.reference_available():
        pytest.skip("the reference tree is not mounted (%s)"
                    % bridge.REFERENCE)
    cfg = config_lib.preset(preset, data_root="/tmp/x")
    cfg = cfg.with_dims(text_dim=TEXT, visual_dim=VIS, joint_dim=JOINT)
    bridge.configure_opt(cfg)
    ref = bridge.import_reference()
    torch.manual_seed(sum(map(ord, preset)))
    kwargs = {"n_classes": 7}
    if n_rels:
        kwargs["n_rels"] = n_rels
    ref_model = getattr(ref.model, ref_cls)(**kwargs).eval()
    src = str(tmp_path / "ckpt.pth.tar")
    torch.save(
        {"epoch": 1, "state_dict": ref_model.state_dict(), "optimizer": {}},
        src,
    )
    out = cc.main([
        "--src", src, "--dst", str(tmp_path / "out.ckpt"),
        "--verify", "--preset", preset, "--reference", bridge.REFERENCE,
        "--device", "cpu",
    ])
    assert out["verify"] and max(out["verify"].values()) < 2e-5
