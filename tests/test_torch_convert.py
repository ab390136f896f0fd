"""Weights into the port: from the JAX package's params and from reference
.pth.tar checkpoints. Both must arrive bit for bit."""

import jax
import numpy as np
import pytest
import torch

from lirec_tpu import config as config_lib
from lirec_tpu.checkpoint.torch_import import load_torch_checkpoint as jax_load
from lirec_tpu.checkpoint.torch_import import params_from_torch_state_dict
from lirec_tpu.models.factory import create_model as jax_create_model
from lirec_tpu_torch.checkpoint import (
    clean_state_dict,
    load_torch_checkpoint,
    params_from_jax,
)
from lirec_tpu_torch.cli.serve import load_checkpoint_state
from lirec_tpu_torch.models.factory import create_model


def _cfg():
    cfg = config_lib.preset("int_rel_ch")
    return cfg.with_dims(text_dim=16, visual_dim=32, joint_dim=16)


def _assert_params_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for leaf in want[name]:
            a = np.asarray(got[name][leaf])
            b = np.asarray(want[name][leaf])
            assert a.dtype == b.dtype and a.shape == b.shape, (name, leaf)
            np.testing.assert_array_equal(a, b, err_msg="%s.%s"
                                          % (name, leaf))


def test_params_from_jax_round_trip():
    """JAX params -> port modules -> state_dict -> the JAX package's own
    torch mapping -> the same params, bitwise."""
    jb = jax_create_model(_cfg(), 9, n_rels=6)
    params = jax.tree.map(np.asarray, jb.params)
    pb = create_model(_cfg(), 9, n_rels=6, seed=5, device="cpu")
    pb.model.load_state_dict(params_from_jax(params))
    back = params_from_torch_state_dict(pb.model.state_dict())
    _assert_params_equal(back, params)


def test_pth_tar_loads_like_the_jax_importer(tmp_path, capsys):
    """A reference-layout checkpoint (DataParallel `module.` prefix, a
    non-tensor entry and a batch-norm buffer, which both importers skip)
    loads into the port's modules with the values the JAX importer reads,
    bitwise."""
    src = create_model(_cfg(), 9, n_rels=6, seed=7,
                       device="cpu").model.state_dict()
    state = {"module." + k: v for k, v in src.items()}
    state["module.bn.num_batches_tracked"] = torch.tensor(3)
    state["module.step_count"] = 11
    path = tmp_path / "weak_int_rel_ch_sum_max.pth.tar"
    torch.save({"epoch": 12, "state_dict": state, "optimizer": {}}, path)

    loaded, meta = load_torch_checkpoint(str(path))
    assert meta == {"epoch": 12, "has_optimizer": True}
    pb = create_model(_cfg(), 9, n_rels=6, seed=8, device="cpu")
    pb.model.load_state_dict(loaded)  # strict: names and shapes match
    for k, v in src.items():
        assert torch.equal(pb.model.state_dict()[k], v), k

    jax_params, jax_meta = jax_load(str(path))
    assert jax_meta["epoch"] == 12
    _assert_params_equal(
        params_from_torch_state_dict(pb.model.state_dict()), jax_params
    )
    assert torch.equal(load_checkpoint_state(str(path))["txt_ints.weight"],
                       src["txt_ints.weight"])
    assert "skipping" in capsys.readouterr().err


def test_clean_state_dict_rejects_unknown_entries():
    with pytest.raises(ValueError, match="unexpected"):
        clean_state_dict({"txt_ints.scale": torch.zeros(2)})
    with pytest.raises(ValueError, match="unexpected"):
        clean_state_dict({"weights": torch.zeros(2)})


def test_serve_reads_only_pth_checkpoints(tmp_path):
    """Serving reads .pth.tar files and the JAX package's msgpack .ckpt
    files (tests/test_torch_jax_checkpoints.py); an Orbax checkpoint
    directory is refused, naming the formats it reads."""
    with pytest.raises(ValueError, match=".pth.tar"):
        load_checkpoint_state(str(tmp_path))
