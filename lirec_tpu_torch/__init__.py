"""lirec-tpu-torch: the PyTorch + CUDA port of lirec_tpu for one NVIDIA
Hopper GPU (sm_90a).

The JAX package ``lirec_tpu`` stays the reference; this package mirrors its
layout (``models/``, ``ops/``, ``evaluation/``, ``cli/``, ``checkpoint/``)
and carries its own copy of the numpy host tier (``config``, ``data/``,
``native/``, ``utils/``). It imports nothing of ``lirec_tpu`` and never
imports jax, flax or optax.
"""

__version__ = "0.1.0"
