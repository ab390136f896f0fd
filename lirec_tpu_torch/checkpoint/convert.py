"""Weights in and out of the port's modules.

* ``params_from_jax``: a lirec_tpu params pytree (``{name: {"kernel" [in,
  out], "bias"}}``, numpy or jax arrays) -> a ``state_dict`` of the port's
  modules (``name.weight [out, in]``, ``name.bias``; the gate's
  ``gates_ints`` becomes ``gates_ints.fc_out``).
* ``opt_state_from_jax``: the optax Adam state of a lirec_tpu training run
  (``ScaleByAdamState(count, mu, nu)`` inside the make_optimizer chain) ->
  a ``torch.optim.Adam`` ``state_dict`` (``step``, ``exp_avg``,
  ``exp_avg_sq`` per parameter, the moments laid out as the weights), so a
  JAX training state carries on in the port.
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

__all__ = ["params_from_jax", "opt_state_from_jax", "clean_state_dict",
           "load_torch_checkpoint"]

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


def _adam_state(opt_state):
    """The (count, mu, nu) entry of an optax state (a chain's tuple)."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def opt_state_from_jax(opt_state, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> Dict:
    """optax Adam state (numpy or jax leaves) -> a state_dict that
    ``optimizer.load_state_dict`` takes, for an optimizer over
    ``model.parameters()``. The step count becomes each parameter's
    ``step``; mu and nu are mapped like the params (kernels transposed)."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the state")
    mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
    step = float(np.asarray(adam.count))
    names = {id(p): n for n, p in model.named_parameters()}
    template = optimizer.state_dict()
    state = {}
    for group, saved in zip(optimizer.param_groups,
                            template["param_groups"]):
        for param, index in zip(group["params"], saved["params"]):
            name = names[id(param)]
            state[index] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": mu[name].reshape(param.shape),
                "exp_avg_sq": nu[name].reshape(param.shape),
            }
    return {"state": state, "param_groups": template["param_groups"]}


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
