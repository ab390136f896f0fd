"""Host-side metric helpers (the eval-sweep metrics are a later slice)."""

from __future__ import annotations

import numpy as np

__all__ = ["_sigmoid"]


def _sigmoid(x: np.ndarray) -> np.ndarray:
    """Sigmoid preserving the input float dtype (counterpart of
    lirec_tpu/evaluation/metrics._sigmoid: the reference's scipy `expit`
    keeps float32, so float32 saturation and ties are part of parity;
    float64 inputs stay float64)."""
    dtype = x.dtype if np.issubdtype(x.dtype, np.floating) else np.float64
    out = np.clip(x, -500, 500).astype(dtype)
    return 1.0 / (1.0 + np.exp(-out))
