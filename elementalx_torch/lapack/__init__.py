"""LAPACK-like drivers of the HPD-solve slice."""

from .cholesky import Cholesky, HPDSolve, SolveAfter  # noqa: F401
