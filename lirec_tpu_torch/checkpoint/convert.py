"""Weights in and out of the port's modules.

* ``params_from_jax``: a lirec_tpu params pytree (``{name: {"kernel" [in,
  out], "bias"}}``, numpy or jax arrays) -> a ``state_dict`` of the port's
  modules (``name.weight [out, in]``, ``name.bias``; the gate's
  ``gates_ints`` becomes ``gates_ints.fc_out``).
* ``load_torch_checkpoint``: a reference ``.pth.tar`` file (ref
  ``mlp/train.py:99-106``: ``{'epoch', 'state_dict', 'optimizer'}``) -> the
  ``state_dict`` the port's modules load, with the DataParallel
  ``module.`` prefix stripped and non-tensor entries and batch-norm buffers
  skipped, as lirec_tpu/checkpoint/torch_import.py does.

Both feed ``model.load_state_dict``; the module names already are the
reference's.
"""

from __future__ import annotations

import sys
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["params_from_jax", "clean_state_dict", "load_torch_checkpoint"]

_SKIPPED_BUFFERS = ("num_batches_tracked", "running_mean", "running_var")


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """lirec_tpu params pytree -> port state_dict (bitwise: f32 values are
    copied, the kernel transposed)."""
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        base = "gates_ints.fc_out" if name == "gates_ints" else name
        kernel = np.asarray(leaf["kernel"], np.float32)
        state[base + ".weight"] = torch.from_numpy(kernel.T.copy())
        state[base + ".bias"] = torch.from_numpy(
            np.array(leaf["bias"], np.float32)
        )
    return state


def clean_state_dict(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """Reference state_dict -> the entries the port's modules hold."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in state_dict.items():
        if name.startswith("module."):
            name = name[len("module."):]
        if not hasattr(value, "shape"):  # non-tensor entry (e.g. a counter)
            print("checkpoint: skipping non-tensor entry %r" % name,
                  file=sys.stderr)
            continue
        if "." not in name:
            raise ValueError("unexpected checkpoint entry %r" % name)
        kind = name.rsplit(".", 1)[1]
        if kind in _SKIPPED_BUFFERS:
            print("checkpoint: skipping buffer entry %r" % name,
                  file=sys.stderr)
            continue
        if kind not in ("weight", "bias"):
            raise ValueError("unexpected checkpoint entry %r" % name)
        out[name] = torch.as_tensor(value).to(torch.float32)
    return out


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Load a reference .pth.tar -> (state_dict, metadata incl. epoch).

    The released checkpoints predate the weights_only format, so this
    unpickles in full (ref utils/util_functions.py:274-281): load only
    files from a trusted source.
    """
    checkpoint = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = checkpoint.get("state_dict", checkpoint)
    meta = {
        "epoch": checkpoint.get("epoch"),
        "has_optimizer": "optimizer" in checkpoint,
    }
    return clean_state_dict(state_dict), meta
