"""BLAS-like level 1: the entrywise, structural and reduction operations
the ported slices and levels 2 and 3 need.

Counterpart of the same-named functions in ``elementalx/blas/level1.py``
(reference: include/El/blas_like/level1/*.hpp). Each is a plain tensor
expression on the padded data; all preserve the zero padding. The rest of
the JAX module (and its Pallas kernels K9) waits for the next slice.
"""

from __future__ import annotations

import torch

from ..core.dmatrix import DistMatrix, pad_array
from ..core.types import ADJOINT, LEFT, MD, STAR, UPPER, UpperOrLower


def _iota(A: DistMatrix):
    """Row and column index grids of the padded data."""
    P, Q = A.data.shape
    i = torch.arange(P, device=A.device)[:, None]
    j = torch.arange(Q, device=A.device)[None, :]
    return i, j


def MakeTrapezoidal(uplo: UpperOrLower, A: DistMatrix,
                    offset: int = 0) -> DistMatrix:
    """Zero outside the upper/lower trapezoid (reference: MakeTrapezoidal.hpp)."""
    d = torch.triu(A.data, offset) if uplo == UPPER else torch.tril(A.data, offset)
    return A.with_data(d)


def MakeSymmetric(uplo: UpperOrLower, A: DistMatrix,
                  conjugate: bool = False) -> DistMatrix:
    """Reflect the uplo triangle to the other side, conjugated (with a real
    diagonal) when ``conjugate`` (reference: MakeSymmetric.hpp)."""
    d = A.data
    i, j = _iota(A)
    take_own = (j >= i) if uplo == UPPER else (j <= i)
    out = torch.where(take_own, d, d.mH if conjugate else d.mT)
    if conjugate and out.is_complex():
        out = torch.where(i == j, out.real.to(out.dtype), out)
    return A.with_data(out)


def MakeHermitian(uplo: UpperOrLower, A: DistMatrix) -> DistMatrix:
    return MakeSymmetric(uplo, A, conjugate=True)


def FillDiagonal(A: DistMatrix, alpha, offset: int = 0) -> DistMatrix:
    """Set the given diagonal of the logical region to alpha (reference:
    FillDiagonal.hpp)."""
    i, j = _iota(A)
    on_diag = (j - i == offset) & A.pad_mask()
    val = torch.full((), alpha, dtype=A.dtype, device=A.device)
    return A.with_data(torch.where(on_diag, val, A.data))


def GetDiagonal(A: DistMatrix, offset: int = 0) -> DistMatrix:
    """d = diag(A, offset) as a column vector tagged [MD,*] like the
    reference (reference: GetDiagonal.hpp)."""
    if offset >= 0:
        dlen = max(min(A.m, A.n - offset), 0)
    else:
        dlen = max(min(A.m + offset, A.n), 0)
    d = torch.diagonal(A.data, offset)[:dlen]
    col = pad_array(d[:, None], A.grid)
    return DistMatrix.from_padded(col, dlen, 1, MD, STAR, A.grid, A.wrap)


def DiagonalSolve(side, orientation, d: DistMatrix,
                  A: DistMatrix) -> DistMatrix:
    """A := diag(d)^{-1} A (LEFT) or A diag(d)^{-1} (RIGHT), conjugating d
    for ADJOINT (reference: DiagonalSolve.hpp). Zero entries of d (its
    padding) divide by 1, so the padding stays zero."""
    dvec = d.data[:, 0]
    if orientation == ADJOINT:
        dvec = dvec.conj()
    safe = torch.where(dvec == 0, torch.ones_like(dvec), dvec).to(A.dtype)
    if side == LEFT:
        return A.with_data(A.data / safe[: A.data.shape[0], None])
    return A.with_data(A.data / safe[None, : A.data.shape[1]])


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
