"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (see ``dispatch`` for the launch counts)."""

from lirec_tpu_torch.ops.gather_pool import (  # noqa: F401
    fused_ctx_pool,
    fused_ctx_pool_reference,
)
from lirec_tpu_torch.ops.scatter_accum import (  # noqa: F401
    gather_h1,
    scatter_accum1,
    scatter_accum1_reference,
    scatter_accum3,
    scatter_accum3_reference,
)
