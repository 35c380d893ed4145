"""Linear solve drivers (reference: src/lapack_like/solve/).

Counterpart of ``elementalx/lapack/solve.py``, reduced to the drivers the
port has: the general solve through pivoted LU and the HPD solve through
Cholesky. SymmetricSolve, HermitianSolve and SQSDSolve wait for LDL, and
MultiShiftHessSolve for more of core (ROADMAP).
"""

from .cholesky import HPDSolve  # noqa: F401  (reference: solve/HPD.cpp)
from .lu import LinearSolve  # noqa: F401  (reference: solve/Linear.cpp)
