"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (see ``dispatch`` for the launch counts)."""

from lirec_tpu_torch.ops.gather_pool import (  # noqa: F401
    fused_ctx_pool,
    fused_ctx_pool_reference,
)
