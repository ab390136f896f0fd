"""Checkpoint import for the port (reference .pth.tar files and lirec_tpu
params)."""

from lirec_tpu_torch.checkpoint.convert import (  # noqa: F401
    clean_state_dict,
    load_torch_checkpoint,
    params_from_jax,
)
