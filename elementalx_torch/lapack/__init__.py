"""LAPACK-like drivers of the ported slices: HPD solve and LU."""

from . import cholesky, lu, perm, solve  # noqa: F401
from .cholesky import Cholesky, HPDSolve, SolveAfter  # noqa: F401
from .lu import LU, LUFullPiv, LUMod, LinearSolve  # noqa: F401
from .perm import Permutation  # noqa: F401
