"""BLAS-like level 3 beyond Gemm and Trsm.

Counterpart of ``elementalx/blas/level3.py`` (reference:
src/blas_like/level3/): Herk/Syrk, Her2k/Syr2k, Trrk/Trr2k, Symm/Hemm,
Trmm, Trtrmm, TwoSidedTrsm/TwoSidedTrmm, Trdtrmm and the EVD
reconstruction helpers.

The JAX package computes every triangle-restricted update as a full
product merged into the target triangle with a mask (on the MXU a full
tile at full rate beats a ragged one). Here each such update is the K2
kernel (kernels/trrk.py), the masked rank-k update that the JAX package
wrote for exactly this: on a CUDA tensor it computes only the output
tiles that meet the triangle and leaves the rest of C as it was, so
there is no full-matrix select pass, and the JAX package's
``_tri_mask``/``_merge_triangle`` pair is K2's epilogue here. A two-term
update (Her2k, Syr2k, Trr2k) is two launches, the second adding into the
first's output with beta = 1. Full products (Symm, Trmm) go through Gemm
and so K1.

``MultiShiftTrsm`` is not ported yet: it needs ``multishift.py``,
``quasi.py`` and ``DistMatrix.replicated`` (ROADMAP queue 1 items 1, 10).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.dmatrix import DistMatrix, check_same_grid
from ..core.types import (
    ADJOINT,
    LEFT,
    LOWER,
    LeftOrRight,
    MC,
    MR,
    NON_UNIT,
    NORMAL,
    Orientation,
    RIGHT,
    UNIT,
    UPPER,
    UnitOrNonUnit,
    UpperOrLower,
)
from ..kernels.trrk import masked_rank_k
from .gemm import Gemm, _orient as _op
from .level1 import (
    DiagonalSolve,
    FillDiagonal,
    GetDiagonal,
    MakeSymmetric,
    MakeTrapezoidal,
)
from .trsm import Trsm


def _data(X: DistMatrix) -> torch.Tensor:
    return X.redistribute(MC, MR).canonical().data


def _rank_k(uplo: UpperOrLower, alpha, a: torch.Tensor, b: torch.Tensor,
            beta, c: torch.Tensor) -> torch.Tensor:
    """C := alpha a b + beta C on the uplo triangle of C, the rest of C
    unchanged: one K2 launch on a CUDA tensor. Operands of another type
    than C are cast to it (bfloat16 operands keep their type for a
    float32 C, K2 accumulating in float32)."""
    if not (a.dtype == b.dtype and (a.dtype == c.dtype or (
            a.dtype == torch.bfloat16 and c.dtype == torch.float32))):
        a, b = a.to(c.dtype), b.to(c.dtype)
    return masked_rank_k(uplo == LOWER, alpha, a, b, beta, c)


def _target(C: Optional[DistMatrix], like: DistMatrix,
            m: int) -> DistMatrix:
    """C as [MC,MR] in its canonical shape, or an m x m zero matrix of
    ``like``'s type (then beta does not matter: the JAX package's
    MakeTrapezoidal of the bare product)."""
    if C is not None:
        return C.redistribute(MC, MR).canonical()
    return DistMatrix.from_global(
        torch.zeros((m, m), dtype=like.dtype, device=like.device),
        grid=like.grid)


# ---------------------------------------------------------------------------
# rank-k updates
# ---------------------------------------------------------------------------


def Herk(uplo: UpperOrLower, orientation: Orientation, alpha, A: DistMatrix,
         beta=0.0, C: Optional[DistMatrix] = None) -> DistMatrix:
    """C := alpha op(A) op(A)^H + beta C on the uplo triangle
    (reference: level3/Herk.cpp)."""
    Aop = _op(A.redistribute(MC, MR), orientation)
    Ct = _target(C, A, Aop.m)
    a = _data(Aop)
    return Ct.with_data(_rank_k(uplo, alpha, a, a.mH, beta, Ct.data))


def Syrk(uplo: UpperOrLower, orientation: Orientation, alpha, A: DistMatrix,
         beta=0.0, C: Optional[DistMatrix] = None) -> DistMatrix:
    """C := alpha op(A) op(A)^T + beta C on the triangle (Syrk.cpp)."""
    Aop = _op(A.redistribute(MC, MR), orientation)
    Ct = _target(C, A, Aop.m)
    a = _data(Aop)
    return Ct.with_data(_rank_k(uplo, alpha, a, a.mT, beta, Ct.data))


def Her2k(uplo: UpperOrLower, orientation: Orientation, alpha, A: DistMatrix,
          B: DistMatrix, beta=0.0, C: Optional[DistMatrix] = None
          ) -> DistMatrix:
    """C := alpha op(A) op(B)^H + conj(alpha) op(B) op(A)^H + beta C on the
    triangle (reference: Her2k.cpp); two K2 launches."""
    check_same_grid(A, B)
    a = _data(_op(A.redistribute(MC, MR), orientation))
    b = _data(_op(B.redistribute(MC, MR), orientation))
    Ct = _target(C, A, a.shape[0])
    calpha = alpha.conjugate() if isinstance(alpha, complex) else alpha
    half = _rank_k(uplo, alpha, a, b.mH, beta, Ct.data)
    return Ct.with_data(_rank_k(uplo, calpha, b, a.mH, 1.0, half))


def Syr2k(uplo: UpperOrLower, orientation: Orientation, alpha, A: DistMatrix,
          B: DistMatrix, beta=0.0, C: Optional[DistMatrix] = None
          ) -> DistMatrix:
    """C := alpha (op(A) op(B)^T + op(B) op(A)^T) + beta C on the triangle
    (reference: Syr2k.cpp); two K2 launches."""
    check_same_grid(A, B)
    a = _data(_op(A.redistribute(MC, MR), orientation))
    b = _data(_op(B.redistribute(MC, MR), orientation))
    Ct = _target(C, A, a.shape[0])
    half = _rank_k(uplo, alpha, a, b.mT, beta, Ct.data)
    return Ct.with_data(_rank_k(uplo, alpha, b, a.mT, 1.0, half))


def Trrk(uplo: UpperOrLower, orientA: Orientation, orientB: Orientation,
         alpha, A: DistMatrix, B: DistMatrix, beta, C: DistMatrix
         ) -> DistMatrix:
    """Triangle-restricted C := alpha op(A) op(B) + beta C (reference:
    Trrk.cpp; the LocalTrrk workhorse of the factorizations); one K2
    launch."""
    check_same_grid(A, B, C)
    a = _data(_op(A.redistribute(MC, MR), orientA))
    b = _data(_op(B.redistribute(MC, MR), orientB))
    Ct = C.redistribute(MC, MR).canonical()
    return Ct.with_data(_rank_k(uplo, alpha, a, b, beta, Ct.data))


def Trr2k(uplo: UpperOrLower, orientA: Orientation, orientB: Orientation,
          orientC: Orientation, orientD: Orientation,
          alpha, A: DistMatrix, B: DistMatrix,
          beta, C: DistMatrix, D: DistMatrix,
          gamma, E: DistMatrix) -> DistMatrix:
    """Triangle-restricted E := alpha op(A) op(B) + beta op(C) op(D) +
    gamma E (reference: Trr2k.cpp); two K2 launches."""
    check_same_grid(A, B, C, D, E)
    a = _data(_op(A.redistribute(MC, MR), orientA))
    b = _data(_op(B.redistribute(MC, MR), orientB))
    c = _data(_op(C.redistribute(MC, MR), orientC))
    d = _data(_op(D.redistribute(MC, MR), orientD))
    Et = E.redistribute(MC, MR).canonical()
    half = _rank_k(uplo, alpha, a, b, gamma, Et.data)
    return Et.with_data(_rank_k(uplo, beta, c, d, 1.0, half))


# ---------------------------------------------------------------------------
# symmetric / triangular multiplies
# ---------------------------------------------------------------------------


def Symm(side: LeftOrRight, uplo: UpperOrLower, alpha, A: DistMatrix,
         B: DistMatrix, beta=0.0, C: Optional[DistMatrix] = None,
         conjugate: bool = False) -> DistMatrix:
    """C := alpha A B (LEFT) or alpha B A (RIGHT) + beta C with A symmetric
    stored in uplo (reference: Symm.cpp): the symmetrized A and one
    Gemm."""
    Afull = MakeSymmetric(uplo, A.redistribute(MC, MR), conjugate=conjugate)
    if side == LEFT:
        return Gemm(NORMAL, NORMAL, alpha, Afull, B, beta=beta, C=C)
    return Gemm(NORMAL, NORMAL, alpha, B, Afull, beta=beta, C=C)


def Hemm(side: LeftOrRight, uplo: UpperOrLower, alpha, A: DistMatrix,
         B: DistMatrix, beta=0.0, C: Optional[DistMatrix] = None
         ) -> DistMatrix:
    """Reference: Hemm.cpp."""
    return Symm(side, uplo, alpha, A, B, beta=beta, C=C, conjugate=True)


def _tri_data(A: DistMatrix, uplo: UpperOrLower,
              diag: UnitOrNonUnit) -> DistMatrix:
    T = MakeTrapezoidal(uplo, A.redistribute(MC, MR))
    if diag == UNIT:
        T = FillDiagonal(T, 1.0)
    return T


def Trmm(side: LeftOrRight, uplo: UpperOrLower, orientation: Orientation,
         diag: UnitOrNonUnit, alpha, A: DistMatrix, B: DistMatrix
         ) -> DistMatrix:
    """B := alpha op(A) B (LEFT) or alpha B op(A) (RIGHT), A triangular
    (reference: Trmm.cpp)."""
    T = _tri_data(A, uplo, diag)
    if side == LEFT:
        return Gemm(orientation, NORMAL, alpha, T, B)
    return Gemm(NORMAL, orientation, alpha, B, T)


def Trtrmm(uplo: UpperOrLower, A: DistMatrix, conjugate: bool = False
           ) -> DistMatrix:
    """A := L^T L (LOWER) or U U^T (UPPER) on the triangle, the other
    triangle kept from A (reference: Trtrmm.cpp): one K2 launch with
    beta = 0 and C = A."""
    Am = A.redistribute(MC, MR).canonical()
    t = _tri_data(Am, uplo, NON_UNIT).data
    tt = t.mH if conjugate else t.mT
    a, b = (tt, t) if uplo == LOWER else (t, tt)
    return Am.with_data(_rank_k(uplo, 1.0, a, b, 0.0, Am.data))


# ---------------------------------------------------------------------------
# two-sided solves/multiplies (generalized eigenproblem reductions)
# ---------------------------------------------------------------------------


def TwoSidedTrsm(uplo: UpperOrLower, diag: UnitOrNonUnit, A: DistMatrix,
                 B: DistMatrix) -> DistMatrix:
    """A := inv(B) A inv(B)^H for Hermitian A and triangular B, the
    reduction of A x = lambda B x to standard form after Cholesky
    (reference: TwoSidedTrsm.cpp); uplo=LOWER, B=L: inv(L) A inv(L)^H.
    Two Trsm calls."""
    if uplo == LOWER:
        half = Trsm(LEFT, LOWER, NORMAL, diag, 1.0, B, A)
        return Trsm(RIGHT, LOWER, ADJOINT, diag, 1.0, B, half)
    half = Trsm(LEFT, UPPER, ADJOINT, diag, 1.0, B, A)
    return Trsm(RIGHT, UPPER, NORMAL, diag, 1.0, B, half)


def TwoSidedTrmm(uplo: UpperOrLower, diag: UnitOrNonUnit, A: DistMatrix,
                 B: DistMatrix) -> DistMatrix:
    """A := B^H A B (uplo=LOWER: L^H A L; reference: TwoSidedTrmm.cpp).
    Two Trmm calls."""
    if uplo == LOWER:
        half = Trmm(LEFT, LOWER, ADJOINT, diag, 1.0, B, A)
        return Trmm(RIGHT, LOWER, NORMAL, diag, 1.0, B, half)
    half = Trmm(LEFT, UPPER, NORMAL, diag, 1.0, B, A)
    return Trmm(RIGHT, UPPER, ADJOINT, diag, 1.0, B, half)


# ---------------------------------------------------------------------------
# EVD reconstruction helpers (reference: HermitianFromEVD.cpp etc.)
# ---------------------------------------------------------------------------


def HermitianFromEVD(uplo: UpperOrLower, Q: DistMatrix, w) -> DistMatrix:
    """A := Q diag(w) Q^H (reference: HermitianFromEVD.cpp); w is a
    tensor or an array."""
    Qd = Q.redistribute(MC, MR).canonical()
    w = torch.as_tensor(w, device=Qd.device).to(Qd.dtype)
    wv = w.new_zeros((Qd.data.shape[1],))
    wv[: w.shape[0]] = w
    scaled = Qd.with_data(Qd.data * wv[None, :])
    return Gemm(NORMAL, ADJOINT, 1.0, scaled, Qd)


def NormalFromEVD(Q: DistMatrix, w) -> DistMatrix:
    """A := Q diag(w) Q^H with complex w (reference: NormalFromEVD.cpp)."""
    return HermitianFromEVD(LOWER, Q, w)


def Trdtrmm(uplo: UpperOrLower, A: DistMatrix, conjugate: bool = False
            ) -> DistMatrix:
    """From an LDL-packed factor (unit triangle, D on the diagonal):
    LOWER gives L inv(D) L^T on the lower triangle, as the JAX package
    computes it; UPPER gives op(U) (U inv(D)) on the upper one, the JAX
    package's order of the product (reference: level3/Trdtrmm.cpp). One
    K2 launch with beta = 0 and C = A."""
    Am = A.redistribute(MC, MR).canonical()
    d = GetDiagonal(Am)
    T = _tri_data(Am, uplo, UNIT)
    ls = DiagonalSolve(RIGHT, NORMAL, d, T).data
    t = T.data.mH if conjugate else T.data.mT
    a, b = (ls, t) if uplo == LOWER else (t, ls)
    return Am.with_data(_rank_k(uplo, 1.0, a, b, 0.0, Am.data))
