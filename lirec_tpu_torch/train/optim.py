"""The optimizer (counterpart of lirec_tpu/train/optim.make_optimizer).

The reference trains with ``torch.optim.Adam(lr, weight_decay)`` (ref
mlp/model.py:599-601), whose weight decay adds ``wd * param`` to the
gradient before the moment updates; the JAX package copies that with the
optax chain add_decayed_weights -> scale_by_adam -> scale(-lr). Here it is
torch's own Adam again.

On a card Adam is ``capturable`` on every path, so that the epoch sweep's
CUDA graph (train/sweep.py) can hold its step and the per-batch path takes
the same arithmetic: its step count is then an f32 tensor on the card and
its bias corrections are f32 device arithmetic, where a non-capturable
Adam computes them in Python doubles (the two are not bitwise equal). On
the CPU it is not capturable. A train state's file keeps the
non-capturable form (``file_state``: the step count on the host,
``capturable`` off), the form the reference's Adam reads, and
``load_state`` puts a file's state into either kind.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["make_optimizer", "file_state", "load_state"]


def _on_card(params) -> bool:
    return any(p.is_cuda for p in params)


def make_optimizer(params, lr: float, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> torch.optim.Adam:
    """torch's Adam, capturable where the parameters are on a card."""
    params = list(params)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay,
                            capturable=_on_card(params))


def file_state(optimizer: torch.optim.Optimizer) -> Dict:
    """``optimizer.state_dict()`` as a train state's file holds it: each
    group's ``capturable`` off (step counts go to the host with the rest of
    the file, checkpoint/saver.py)."""
    state = optimizer.state_dict()
    state["param_groups"] = [dict(g, capturable=False) if "capturable" in g
                             else g for g in state["param_groups"]]
    return state


def load_state(optimizer: torch.optim.Optimizer, state: Dict) -> None:
    """``optimizer.load_state_dict(state)`` keeping the optimizer's own
    kind: capturable with its step counts on the card where its parameters
    are there, else not, with them on the host."""
    optimizer.load_state_dict(state)
    for group in optimizer.param_groups:
        card = _on_card(group["params"])
        group["capturable"] = card
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(
                    device=p.device if card else "cpu", dtype=torch.float32)
