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
* ``params_to_jax`` / ``opt_state_to_jax``: their inverses, the port's
  weights and ``torch.optim.Adam`` state as the JAX package's params tree
  and the state-dict form of its optax chain (add_decayed_weights ->
  scale_by_adam -> scale_by_learning_rate, lirec_tpu/train/optim.py), as
  numpy arrays, for checkpoint/saver.py's msgpack files.
* ``load_torch_checkpoint``: a reference ``.pth.tar`` file (ref
  ``mlp/train.py:99-106``: ``{'epoch', 'state_dict', 'optimizer'}``) -> the
  ``state_dict`` the port's modules load, with the DataParallel
  ``module.`` prefix stripped and non-tensor entries and batch-norm buffers
  skipped, as lirec_tpu/checkpoint/torch_import.py does.
* ``load_jax_checkpoint``: a msgpack file of the JAX package's
  checkpoint/saver.py (``save_params``: ``{'params', 'extra'}``, the best-n
  and converted ``.ckpt`` files; ``save_train_state``: ``{'params',
  'opt_state', 'epoch'}``, ``latest.ckpt`` and ``<epochs-1>.ckpt``) ->
  the ``state_dict``, the Adam state and the epoch, decoded by
  checkpoint/msgpack.py (neither flax nor msgpack is imported).

All feed ``model.load_state_dict``; the module names already are the
reference's.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["params_from_jax", "opt_state_from_jax", "params_to_jax",
           "opt_state_to_jax", "clean_state_dict", "load_torch_checkpoint",
           "load_jax_checkpoint"]

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


def params_to_jax(state_dict: Dict) -> Dict[str, Dict[str, np.ndarray]]:
    """Port state_dict (tensors on any device) -> the JAX package's params
    tree of f32 numpy arrays, the inverse of ``params_from_jax`` (bitwise:
    the weight transposed back into the kernel)."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in state_dict.items():
        base, kind = key.rsplit(".", 1)
        name = "gates_ints" if base == "gates_ints.fc_out" else base
        value = value.detach().to("cpu", torch.float32).numpy()
        leaf = params.setdefault(name, {})
        leaf["kernel" if kind == "weight" else "bias"] = (
            np.ascontiguousarray(value.T) if kind == "weight" else
            value.copy())
    return params


_ADAM_FIELDS = ("count", "mu", "nu")


def _adam_state(opt_state):
    """(count, mu, nu) of the ScaleByAdamState in an optax state: the live
    state (a chain's tuple of namedtuples) or its flax state-dict form, as
    a msgpack file holds it (tuples as {"0": ..., "1": ...}, namedtuples
    as dicts of their fields)."""
    if isinstance(opt_state, dict):
        if all(f in opt_state for f in _ADAM_FIELDS):
            return tuple(opt_state[f] for f in _ADAM_FIELDS)
        parts = opt_state.values()
    elif all(hasattr(opt_state, f) for f in _ADAM_FIELDS):
        return tuple(getattr(opt_state, f) for f in _ADAM_FIELDS)
    elif isinstance(opt_state, (tuple, list)):
        parts = opt_state
    else:
        return None
    for part in parts:
        found = _adam_state(part)
        if found is not None:
            return found
    return None


def opt_state_from_jax(opt_state, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> Dict:
    """optax Adam state (numpy or jax leaves, live or in its state-dict
    form) -> a state_dict that ``optimizer.load_state_dict`` takes, for an
    optimizer over ``model.parameters()``. The step count becomes each
    parameter's ``step``; mu and nu are mapped like the params (kernels
    transposed)."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the state")
    count, mu, nu = adam
    mu, nu = params_from_jax(mu), params_from_jax(nu)
    step = float(np.asarray(count))
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


def _sorted(tree):
    """A nest of dicts with every level's keys in sorted order, as optax
    lays out the moments (it builds them with jax.tree.map)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def opt_state_to_jax(model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> Dict:
    """A ``torch.optim.Adam`` over ``model.parameters()`` -> the state-dict
    form of the JAX package's optax chain, as flax writes it: {"0": {}
    (add_decayed_weights, only with a weight decay), "1": {"count", "mu",
    "nu"} (scale_by_adam), "2": {} (scale_by_learning_rate)}, with the
    moments laid out as ``params_to_jax`` lays out the weights (in optax's
    sorted order) and the step count as an int32 scalar array; the
    inverse of
    ``opt_state_from_jax``. Before the first step the moments are zero."""
    groups = optimizer.param_groups
    decays = {g["weight_decay"] for g in groups}
    if len(groups) != 1 or len(decays) != 1:
        raise ValueError("opt_state_to_jax maps one parameter group; the "
                         "optimizer has %d" % len(groups))
    names = {id(p): n for n, p in model.named_parameters()}
    mu, nu, steps = {}, {}, set()
    for param in groups[0]["params"]:
        state = optimizer.state.get(param) or {}
        zero = torch.zeros_like(param)
        mu[names[id(param)]] = state.get("exp_avg", zero)
        nu[names[id(param)]] = state.get("exp_avg_sq", zero)
        steps.add(int(state["step"]) if "step" in state else 0)
    if len(steps) != 1:
        raise ValueError("parameters at different Adam steps: %s"
                         % sorted(steps))
    adam = {"count": np.asarray(steps.pop(), np.int32),
            "mu": _sorted(params_to_jax(mu)), "nu": _sorted(params_to_jax(nu))}
    chain = ([{}] if decays.pop() else []) + [adam, {}]
    return {str(i): part for i, part in enumerate(chain)}


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


def load_jax_checkpoint(path: str, model: Optional[torch.nn.Module] = None,
                        optimizer: Optional[torch.optim.Optimizer] = None):
    """A msgpack checkpoint of the JAX package -> (state_dict, Adam
    state_dict or None, epoch).

    Both payloads of lirec_tpu/checkpoint/saver.py are read: a
    ``save_params`` file (``{'params', 'extra'}``; its epoch is
    ``extra['epoch']``, 0 where it has none) and a ``save_train_state``
    file (``{'params', 'opt_state', 'epoch'}``). The Adam state is
    ``opt_state_from_jax`` of the file's optax state for `optimizer` over
    `model`'s parameters, where the file has one and both are given; else
    None."""
    from lirec_tpu_torch.checkpoint.msgpack import msgpack_restore

    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError("%s is not a checkpoint of the JAX package: no "
                         "'params' entry" % path)
    state_dict = params_from_jax(tree["params"])
    epoch = tree.get("epoch", (tree.get("extra") or {}).get("epoch"))
    adam = None
    if tree.get("opt_state") is not None and optimizer is not None:
        adam = opt_state_from_jax(tree["opt_state"], model, optimizer)
    return state_dict, adam, int(epoch or 0)
