"""LAPACK-like drivers of the ported slices: HPD solve, LU and
HermitianEig."""

from . import (  # noqa: F401
    cholesky,
    condense,
    hermitian_eig,
    lu,
    perm,
    qr,
    reflect,
    sbr,
    solve,
    tridiag_eig,
)
from .cholesky import Cholesky, HPDSolve, SolveAfter  # noqa: F401
from .lu import LU, LUFullPiv, LUMod, LinearSolve  # noqa: F401
from .perm import Permutation  # noqa: F401
from .condense import HermitianTridiag  # noqa: F401
from .hermitian_eig import (  # noqa: F401
    HermitianEig,
    HermitianEigCtrl,
    HermitianEigSubset,
    HermitianEigValueSubset,
)
from .tridiag_eig import HermitianTridiagEig  # noqa: F401
