"""One element per output position along an axis (counterpart of
lirec_tpu/ops/select.py).

The JAX package selected with an iota-compare + ``where`` + sum because a
TPU gather issues one row per cycle; here it is ``torch.gather``, whose
backward writes each selected element's gradient into its own position.
The rules stay: nothing is multiplied by a one-hot (``0 * -inf`` is NaN,
and the losses mask logits to ``-inf``), and out-of-range indices clamp
into the axis, as ``take_along_axis``'s "clip" mode does.
"""

from __future__ import annotations

import torch

__all__ = ["select_along_axis"]


def select_along_axis(x: torch.Tensor, idx: torch.Tensor,
                      axis: int) -> torch.Tensor:
    """``take_along_axis(x, expand_dims(idx, axis), axis)`` squeezed.

    ``idx`` must broadcast against ``x``'s shape with ``axis`` removed.
    Returns ``x``'s dtype and that reduced shape.
    """
    axis = axis % x.dim()
    k = x.shape[axis]
    out_shape = x.shape[:axis] + x.shape[axis + 1:]
    idx = torch.as_tensor(idx, device=x.device).long().clamp(0, k - 1)
    idx = idx.broadcast_to(out_shape).unsqueeze(axis)
    return torch.gather(x, axis, idx).squeeze(axis)
