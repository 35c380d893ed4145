"""BLAS-like level 1: the entrywise and reduction operations of the slice.

Counterpart of the same-named functions in ``elementalx/blas/level1.py``
(reference: include/El/blas_like/level1/*.hpp). Each is a plain tensor
expression on the padded data; all preserve the zero padding.
"""

from __future__ import annotations

import torch

from ..core.dmatrix import DistMatrix
from ..core.types import UPPER, UpperOrLower


def MakeTrapezoidal(uplo: UpperOrLower, A: DistMatrix,
                    offset: int = 0) -> DistMatrix:
    """Zero outside the upper/lower trapezoid (reference: MakeTrapezoidal.hpp)."""
    d = torch.triu(A.data, offset) if uplo == UPPER else torch.tril(A.data, offset)
    return A.with_data(d)


def MakeHermitian(uplo: UpperOrLower, A: DistMatrix) -> DistMatrix:
    """Reflect the conjugate of the uplo triangle to the other side, with
    a real diagonal (reference: MakeSymmetric.hpp, conjugated)."""
    d = A.data
    P, Q = d.shape
    i = torch.arange(P, device=d.device)[:, None]
    j = torch.arange(Q, device=d.device)[None, :]
    take_own = (j >= i) if uplo == UPPER else (j <= i)
    out = torch.where(take_own, d, d.mH)
    if out.is_complex():
        out = torch.where(i == j, out.real.to(out.dtype), out)
    return A.with_data(out)


def Transpose(A: DistMatrix, conjugate: bool = False) -> DistMatrix:
    """B = A^T (or A^H) as a view; the dist tags transpose with the data
    (reference: Transpose.hpp)."""
    d = A.data.mH if conjugate else A.data.mT
    return DistMatrix.from_padded(d, A.n, A.m, A.row_dist, A.col_dist,
                                  A.grid, A.wrap)


def Adjoint(A: DistMatrix) -> DistMatrix:
    return Transpose(A, conjugate=True)


def Nrm2(A: DistMatrix) -> torch.Tensor:
    """Frobenius/2-norm via scaled squares for overflow safety
    (reference: Nrm2.hpp, NormsFromScaledSquares.hpp)."""
    absa = torch.abs(A.data)
    scale = torch.max(absa)
    one = torch.ones((), dtype=scale.dtype, device=scale.device)
    safe = torch.where(scale == 0, one, scale)
    ss = torch.sum((absa / safe) ** 2)
    return torch.where(scale == 0, torch.zeros_like(scale), safe * torch.sqrt(ss))


def MaxAbs(A: DistMatrix) -> torch.Tensor:
    return torch.max(torch.abs(A.data))
