"""The optimizer (counterpart of lirec_tpu/train/optim.make_optimizer).

The reference trains with ``torch.optim.Adam(lr, weight_decay)`` (ref
mlp/model.py:599-601), whose weight decay adds ``wd * param`` to the
gradient before the moment updates; the JAX package copies that with the
optax chain add_decayed_weights -> scale_by_adam -> scale(-lr). Here it is
torch's own Adam again.
"""

from __future__ import annotations

import torch

__all__ = ["make_optimizer"]


def make_optimizer(params, lr: float, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)
