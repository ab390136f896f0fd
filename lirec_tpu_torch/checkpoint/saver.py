"""Checkpoint writing: the best-n-per-metric policy and resumable train
states, in the reference's own ``.pth.tar`` layout or in the JAX
package's msgpack files (counterpart of lirec_tpu/checkpoint/saver.py and
``save_train_state_any`` of lirec_tpu/checkpoint/__init__.py, ref
``utils/model_saver.py``).

``BestNSaver`` keeps the best ``n = 4`` checkpoints **per metric key**
('total' / 'ints' / 'rels' / 'tracks' / 'joint'), evicts the worst, and
``save()`` writes the kept ones as ``<path>/<key>/v%.4f_ep%d.pth.tar``,
deletes stale files there and writes ``<path>/index.json``: the JAX
package's policy, file stems and index. Every file is a ``torch.save`` of
``{'epoch', 'state_dict', 'optimizer'}`` (ref ``mlp/train.py:99-106``),
so ``checkpoint.load_torch_checkpoint``, the eval CLIs and ``cli/serve``
read them as they read the reference's. With ``backend="msgpack"`` the
files are the JAX package's instead: the best-n files
``v%.4f_ep%d.ckpt`` are ``save_params`` payloads (``{'params', 'extra':
{'epoch'}}``) and ``save_train_state_any`` writes ``{'params',
'opt_state', 'epoch'}``, both encoded by checkpoint/msgpack.py as
``flax.serialization.to_bytes`` encodes them (the same bytes as the JAX
package's file of the same state), so the JAX package's
``load_params`` / ``load_train_state`` read them and the port reads them
back with ``load_jax_checkpoint``. With ``backend="orbax"``
``save_train_state_any`` writes the same tree as an Orbax checkpoint
directory (checkpoint/orbax_backend.py), which the JAX package's
``orbax_backend.restore`` reads, and the best-n files stay msgpack
``save_params`` files, as the JAX package's ``BestNSaver`` writes them
under either backend.

The port's parameters change in place under ``optimizer.step()``, so
``update`` keeps a detached CPU copy of what it is given (the JAX package
can keep a reference to its immutable arrays): a kept checkpoint holds
the weights of its own epoch.
"""

from __future__ import annotations

import json
import os
import os.path as ops
from collections import defaultdict
from typing import Dict, Optional

import torch

__all__ = ["BestNSaver", "save_train_state", "load_train_state",
           "save_params", "save_train_state_any", "BACKENDS"]

# backend -> the suffix of its files
BACKENDS = {"torch": ".pth.tar", "msgpack": ".ckpt", "orbax": ".ckpt"}


def _cpu_copy(tree):
    """A detached CPU clone of every tensor in a nest of dicts / lists."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_copy(v) for v in tree)
    return tree


def _write(path: str, payload: Dict) -> None:
    """torch.save (bytes: written as they are) through a temporary file,
    so a crash never leaves a truncated checkpoint under the final
    name."""
    os.makedirs(ops.dirname(ops.abspath(path)), exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    if isinstance(payload, bytes):
        with open(tmp, "wb") as f:
            f.write(payload)
    else:
        torch.save(payload, tmp)
    os.replace(tmp, path)


def save_params(path: str, state_dict: Dict,
                extra: Optional[Dict] = None) -> None:
    """The JAX package's ``save_params`` file of the port's weights:
    ``{'params'[, 'extra']}`` in msgpack (params_to_jax layout)."""
    from lirec_tpu_torch.checkpoint.convert import params_to_jax
    from lirec_tpu_torch.checkpoint.msgpack import to_bytes

    payload = {"params": params_to_jax(state_dict)}
    if extra:
        payload["extra"] = extra
    _write(path, to_bytes(payload))


def save_train_state_any(path: str, model, optimizer, epoch: int,
                         backend: str = "torch") -> None:
    """A resumable train state of `model` and its Adam `optimizer`:
    'torch' writes the ``.pth.tar`` of ``save_train_state``; 'msgpack' the
    JAX package's ``save_train_state`` file, ``{'params', 'opt_state'
    (opt_state_to_jax), 'epoch'}``; 'orbax' the same tree as the JAX
    package's Orbax directory."""
    if backend == "torch":
        from lirec_tpu_torch.train.optim import file_state

        save_train_state(path, model.state_dict(), file_state(optimizer),
                         epoch)
    elif backend in ("msgpack", "orbax"):
        from lirec_tpu_torch.checkpoint import orbax_backend
        from lirec_tpu_torch.checkpoint.convert import (
            opt_state_to_jax, params_to_jax,
        )
        from lirec_tpu_torch.checkpoint.msgpack import to_bytes

        params = params_to_jax(model.state_dict())
        opt_state = opt_state_to_jax(model, optimizer)
        if backend == "orbax":
            orbax_backend.save(path, params, opt_state, int(epoch))
        else:
            _write(path, to_bytes({"params": params, "opt_state": opt_state,
                                   "epoch": int(epoch)}))
    else:
        raise ValueError("unknown checkpoint backend %r" % backend)


def save_train_state(path: str, state_dict: Dict,
                     optimizer_state: Optional[Dict], epoch: int) -> None:
    """Weights, Adam state and epoch, for --resume-train (ref
    mlp/train.py:99-106)."""
    _write(path, {"epoch": int(epoch), "state_dict": _cpu_copy(state_dict),
                  "optimizer": _cpu_copy(optimizer_state)})


def load_train_state(path: str):
    """(state_dict, optimizer state dict or None, epoch) of a train state
    (ref utils/util_functions.py:274-291). The state_dict is cleaned as
    ``load_torch_checkpoint`` cleans a reference checkpoint."""
    from lirec_tpu_torch.checkpoint.convert import clean_state_dict

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return (clean_state_dict(ckpt["state_dict"]), ckpt.get("optimizer"),
            int(ckpt.get("epoch") or 0))


class BestNSaver:
    """Best-n checkpoints per metric key (ref utils/model_saver.py:17-64)."""

    def __init__(self, path: str = "", n: int = 4, backend: str = "torch"):
        self.n = n
        self.path = path
        self.backend = backend
        self.suffix = BACKENDS[backend]
        self.eval: Dict[str, Dict[int, float]] = defaultdict(dict)
        self.models: Dict[str, Dict[int, Dict]] = defaultdict(dict)
        self.worst_idx: Dict[str, int] = defaultdict(lambda: -1)
        self.saved: Dict[str, Dict[int, str]] = defaultdict(dict)
        if path:
            os.makedirs(path, exist_ok=True)

    def check(self, val: Dict[str, float]) -> bool:
        """True if any metric improves on its current worst kept value
        (ref :31-35)."""
        for key in val:
            if len(self.eval[key]) < self.n:
                return True
            if val[key] > self.eval[key][self.worst_idx[key]]:
                return True
        return False

    def update(self, val: Dict[str, float], save_dict: Dict,
               epoch: int) -> None:
        """Keep `save_dict` (a CPU copy of it, shared by every key) for
        each metric of `val`, evicting the worst beyond n."""
        save_dict = _cpu_copy(save_dict)
        for key in val:
            self.eval[key][epoch] = val[key]
            self.models[key][epoch] = save_dict
            if len(self.eval[key]) > self.n:
                self.eval[key].pop(self.worst_idx[key])
                self.models[key].pop(self.worst_idx[key])
                self.saved[key].pop(self.worst_idx[key], None)
            worst = val[key]
            self.worst_idx[key] = epoch
            for epoch_other, val_other in self.eval[key].items():
                if val_other <= worst:
                    worst = val_other
                    self.worst_idx[key] = epoch_other
            assert len(self.eval[key]) <= self.n

    def save(self) -> None:
        """Write kept checkpoints under <path>/<key>/, GC stale files
        (ref :53-64)."""
        for key in self.eval:
            key_dir = ops.join(self.path, key)
            os.makedirs(key_dir, exist_ok=True)
            kept = set(self.saved[key].values())
            for filename in os.listdir(key_dir):
                full = ops.join(key_dir, filename)
                if full not in kept:
                    os.remove(full)
            for epoch, val in self.eval[key].items():
                full = ops.join(key_dir, "v%.4f_ep%d%s"
                                % (val, epoch, self.suffix))
                if full not in kept:
                    self.saved[key][epoch] = full
                    save_dict = self.models[key][epoch]
                    kept_epoch = save_dict.get("epoch", epoch)
                    if self.backend in ("msgpack", "orbax"):
                        save_params(full, save_dict["state_dict"],
                                    extra={"epoch": kept_epoch})
                        continue
                    _write(full, {
                        "epoch": kept_epoch,
                        "state_dict": save_dict["state_dict"],
                        "optimizer": save_dict.get("optimizer"),
                    })
        with open(ops.join(self.path, "index.json"), "w") as f:
            json.dump(
                {k: {str(e): v for e, v in d.items()}
                 for k, d in self.eval.items()},
                f,
                indent=2,
            )
