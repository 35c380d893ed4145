"""Euclidean minimization: least squares and constrained variants.

Counterpart of ``elementalx/lapack/euclidean_min.py`` (reference:
src/lapack_like/euclidean_min/): LeastSquares through QR (overdetermined)
or LQ (underdetermined, the minimum-norm solution), Ridge and Tikhonov
through HPDSolve on the normal equations, LSE and GLM through LinearSolve
on their KKT systems.
"""

from __future__ import annotations

import torch

from ..blas.gemm import Gemm
from ..blas.level1 import Adjoint, GetSubmatrix, ShiftDiagonal
from ..blas.trsm import Trsm
from ..core.dmatrix import DistMatrix, padded_extent
from ..core.types import (
    ADJOINT,
    LEFT,
    LOWER,
    MC,
    MR,
    NON_UNIT,
    NORMAL,
    Orientation,
    UPPER,
)
from ..kernels.elementwise import fill


def LeastSquares(orientation: Orientation, A: DistMatrix, B: DistMatrix
                 ) -> DistMatrix:
    """min_X ||op(A) X - B||_F; underdetermined systems get the
    minimum-norm solution (reference: euclidean_min/LeastSquares.cpp via
    QR/LQ)."""
    if orientation != NORMAL:
        return LeastSquares(NORMAL, Adjoint(A.redistribute(MC, MR)), B)
    m, n = A.m, A.n
    if m >= n:
        # X = R^{-1} Q^H B
        from .qr import ApplyQ, QR

        fact = QR(A)
        QhB = ApplyQ(True, fact, B)
        Rtop = GetSubmatrix(fact.packed, slice(0, n), slice(0, n))
        Btop = GetSubmatrix(QhB, slice(0, n), slice(0, B.n))
        return Trsm(LEFT, UPPER, NORMAL, NON_UNIT, 1.0, Rtop, Btop)
    # minimum norm: A = L Q with A^H = Q^H R, so L = R^H and
    # X = Q^H L^{-1} B = Q_qr (R^H)^{-1} B. The JAX package goes through
    # LQ(A) and takes the adjoint of its factor back; factoring A^H here
    # leaves one K9 transpose, and R^H is Trsm's ADJOINT view of R.
    from .qr import ApplyQ, QR

    fact = QR(Adjoint(A))
    Rsq = GetSubmatrix(fact.packed, slice(0, m), slice(0, m))
    Y = Trsm(LEFT, UPPER, ADJOINT, NON_UNIT, 1.0, Rsq, B)
    # embed Y into n rows (a K9 fill of zeros), then apply Q
    Ydat = Y.redistribute(MC, MR).data
    full = fill((padded_extent(n, A.grid), Ydat.shape[1]), 0.0, Ydat.dtype,
                Ydat.device)
    full[:m, : Y.n] = Ydat[:m, : Y.n]
    Yfull = DistMatrix.from_padded(full, n, Y.n, MC, MR, A.grid, A.wrap)
    return ApplyQ(False, fact, Yfull)


def Ridge(orientation: Orientation, A: DistMatrix, B: DistMatrix,
          gamma: float) -> DistMatrix:
    """min ||A X - B||^2 + gamma^2 ||X||^2 through the HPD normal equations
    (reference: euclidean_min/Ridge.cpp)."""
    from .cholesky import HPDSolve

    if orientation != NORMAL:
        A = Adjoint(A.redistribute(MC, MR))
    G = ShiftDiagonal(Gemm(ADJOINT, NORMAL, 1.0, A, A), gamma * gamma)
    AhB = Gemm(ADJOINT, NORMAL, 1.0, A, B)
    return HPDSolve(LOWER, NORMAL, G, AhB)


def Tikhonov(orientation: Orientation, A: DistMatrix, B: DistMatrix,
             G: DistMatrix) -> DistMatrix:
    """min ||A X - B||^2 + ||G X||^2 (reference: euclidean_min/Tikhonov.cpp)."""
    from .cholesky import HPDSolve

    if orientation != NORMAL:
        A = Adjoint(A.redistribute(MC, MR))
    N = Gemm(ADJOINT, NORMAL, 1.0, A, A)
    GtG = Gemm(ADJOINT, NORMAL, 1.0, G, G)
    Nfull = N.with_data(N.data + GtG.data.to(N.dtype))
    AhB = Gemm(ADJOINT, NORMAL, 1.0, A, B)
    return HPDSolve(LOWER, NORMAL, Nfull, AhB)


def LSE(A: DistMatrix, B: DistMatrix, C: DistMatrix, D: DistMatrix
        ) -> DistMatrix:
    """min ||A X - C|| s.t. B X = D (reference: euclidean_min/LSE.cpp via
    generalized RQ; here, as in the JAX package, the KKT saddle system
    solved by pivoted LU):
        [2 A^H A  B^H] [X]   [2 A^H C]
        [B        0  ] [l] = [D      ]
    """
    from .lu import LinearSolve

    n = A.n
    p = B.m
    AhA = Gemm(ADJOINT, NORMAL, 2.0, A, A)
    AhC = Gemm(ADJOINT, NORMAL, 2.0, A, C)
    Bd = B.redistribute(MC, MR).data[:p, :n]
    top = torch.cat([AhA.data[:n, :n], Bd.mH], dim=1)
    bot = torch.cat([Bd, Bd.new_zeros((p, p))], dim=1)
    K = torch.cat([top, bot], dim=0)
    rhs = torch.cat([AhC.data[:n, : C.n],
                     D.redistribute(MC, MR).data[:p, : C.n]], dim=0)
    Kdm = DistMatrix.from_global(K, MC, MR, A.grid)
    Rdm = DistMatrix.from_global(rhs, MC, MR, A.grid)
    Z = LinearSolve(Kdm, Rdm)
    return GetSubmatrix(Z, slice(0, n), slice(0, C.n))


def GLM(A: DistMatrix, B: DistMatrix, D: DistMatrix):
    """General Gauss-Markov: min_{X,Y} ||Y|| s.t. D = A X + B Y (reference:
    euclidean_min/GLM.cpp via generalized QR; here, as in the JAX package,
    the equivalent KKT system):
        [0    0    A^H ] [X]   [0]
        [0    I    B^H ] [Y] = [0]
        [A    B    0   ] [l]   [D]
    """
    from .lu import LinearSolve

    n, p, m = A.n, B.n, A.m
    Ad = A.redistribute(MC, MR).data[:m, :n]
    Bd = B.redistribute(MC, MR).data[:m, :p]

    def Z(r, c):
        return Ad.new_zeros((r, c))

    eye = torch.eye(p, dtype=Ad.dtype, device=Ad.device)
    K = torch.cat([torch.cat([Z(n, n), Z(n, p), Ad.mH], dim=1),
                   torch.cat([Z(p, n), eye, Bd.mH], dim=1),
                   torch.cat([Ad, Bd, Z(m, m)], dim=1)], dim=0)
    nrhs = D.n
    rhs = torch.cat([Z(n, nrhs), Z(p, nrhs),
                     D.redistribute(MC, MR).data[:m, :nrhs]], dim=0)
    Kdm = DistMatrix.from_global(K, MC, MR, A.grid)
    Rdm = DistMatrix.from_global(rhs, MC, MR, A.grid)
    S = LinearSolve(Kdm, Rdm)
    X = GetSubmatrix(S, slice(0, n), slice(0, nrhs))
    Y = GetSubmatrix(S, slice(n, n + p), slice(0, nrhs))
    return X, Y
