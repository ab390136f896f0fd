"""lirec-tpu-torch: the PyTorch + CUDA port of lirec_tpu for one NVIDIA
Hopper GPU (sm_90a).

The JAX package ``lirec_tpu`` stays the reference; this package mirrors its
layout (``models/``, ``ops/``, ``cli/``, ``checkpoint/``) and imports only
its jax-free host tier (``lirec_tpu.config``, ``lirec_tpu.data``,
``lirec_tpu.utils.fake_batch``). It never imports jax, flax or optax.
"""

__version__ = "0.1.0"
