"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version (the path CPU tensors take) and a launch counter."""

from .getrf import (  # noqa: F401
    getrf_panel,
    getrf_panel_plain,
    lu_plain,
    packed_getrf,
)
from .matmul import matmul, matmul_plain  # noqa: F401
from .potrf import potrf_block_inv, potrf_block_inv_plain  # noqa: F401
