"""BLAS-like operations of the HPD-solve slice."""

from .gemm import Gemm, local_gemm  # noqa: F401
from .level1 import (  # noqa: F401
    Adjoint,
    MakeHermitian,
    MakeTrapezoidal,
    MaxAbs,
    Nrm2,
    Transpose,
)
from .trinv import tri_inv_lower, tri_inv_lower_unit, tri_inv_upper  # noqa: F401
from .trsm import Trsm  # noqa: F401
