"""BLAS-like operations: Gemm, Trsm, levels 1, 2 and 3."""

from .gemm import Gemm, Gemm3D, local_gemm, use_explicit_summa  # noqa: F401
from . import level1  # noqa: F401
from .level1 import *  # noqa: F401,F403
from .level2 import (  # noqa: F401
    ApplyGivensSequence,
    Gemv,
    Ger,
    Geru,
    Hemv,
    Her,
    Her2,
    Symv,
    Syr,
    Syr2,
    Trmv,
    Trr,
    Trr2,
    Trsv,
)
from .level3 import (  # noqa: F401
    Hemm,
    Her2k,
    Herk,
    HermitianFromEVD,
    NormalFromEVD,
    Symm,
    Syr2k,
    Syrk,
    Trdtrmm,
    Trmm,
    Trr2k,
    Trrk,
    Trtrmm,
    TwoSidedTrmm,
    TwoSidedTrsm,
)
from .trinv import tri_inv_lower, tri_inv_lower_unit, tri_inv_upper  # noqa: F401
from .trsm import Trsm  # noqa: F401
