"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version (the path CPU tensors take) and a launch counter."""

from .elementwise import (  # noqa: F401
    axpby,
    axpby_plain,
    fill,
    fill_plain,
    hadamard,
    hadamard_plain,
    scale,
    scale_plain,
    transpose,
    transpose_plain,
)
from .getrf import (  # noqa: F401
    getrf_panel,
    getrf_panel_plain,
    lu_plain,
    packed_getrf,
)
from .latrd import latrd_panel, latrd_panel_plain  # noqa: F401
from .matmul import matmul, matmul_plain  # noqa: F401
from .potrf import (  # noqa: F401
    potrf_block_inv,
    potrf_block_inv_plain,
    potrf_panel_tail,
    potrf_panel_tail_full,
    potrf_panel_tail_full_plain,
    potrf_panel_tail_plain,
)
from .ring_summa import ring_summa_kernel, ring_summa_plain  # noqa: F401
from .sb2tr import sb2tr, sb2tr_plain  # noqa: F401
from .symv import (  # noqa: F401
    symv_lower,
    symv_lower_plain,
    symv_lower_trailing,
)
from .trinv import trinv, trinv_plain  # noqa: F401
from .trrk import masked_rank_k, masked_rank_k_plain  # noqa: F401
