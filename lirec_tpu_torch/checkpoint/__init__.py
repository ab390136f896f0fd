"""Checkpoint import for the port (reference .pth.tar files, lirec_tpu
params and Adam state, and the JAX package's checkpoints: msgpack files
and Orbax directories, checkpoint/orbax_backend.py)."""

from lirec_tpu_torch.checkpoint.convert import (  # noqa: F401
    clean_state_dict,
    load_jax_checkpoint,
    load_torch_checkpoint,
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
