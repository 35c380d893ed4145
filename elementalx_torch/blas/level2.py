"""BLAS-like level 2.

Counterpart of ``elementalx/blas/level2.py`` (reference:
src/blas_like/level2/). A matrix-vector product is a thin Gemm (K1 on
the card); the triangle-restricted rank-1 and rank-2 updates (Her, Syr,
Her2, Syr2, Trr, Trr2) are K2 launches through level 3's ``_rank_k``;
Trsv is Trsm on one column.

Symv and Hemv choose by shape: a LOWER, real float32/float64 matrix
times one column is the K7 kernel (kernels/symv.py), which reads only
the lower triangle; every other case (UPPER, complex, several columns,
bfloat16) is MakeSymmetric and one Gemm, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.dmatrix import DistMatrix
from ..core.types import (
    ADJOINT,
    LEFT,
    LOWER,
    LeftOrRight,
    MC,
    MR,
    NORMAL,
    Orientation,
    TRANSPOSE,
    UnitOrNonUnit,
    UpperOrLower,
)
from ..kernels.symv import symv_lower
from .gemm import Gemm, _accumulate
from .level1 import MakeSymmetric
from .level3 import Trmm, _data, _rank_k
from .trsm import Trsm


def Gemv(orientation: Orientation, alpha, A: DistMatrix, x: DistMatrix,
         beta=0.0, y: Optional[DistMatrix] = None) -> DistMatrix:
    """y := alpha op(A) x + beta y (reference: Gemv/Normal.hpp,
    Gemv/Transpose.hpp)."""
    return Gemm(orientation, NORMAL, alpha, A, x, beta=beta, C=y)


def Symv(uplo: UpperOrLower, alpha, A: DistMatrix, x: DistMatrix,
         beta=0.0, y: Optional[DistMatrix] = None, conjugate: bool = False
         ) -> DistMatrix:
    """y := alpha A x + beta y, A symmetric stored in uplo (reference:
    Symv.cpp). By shape: LOWER, real float32/float64 and one column of x
    take K7 over the lower triangle of A; the rest take the symmetrized A
    and one Gemm."""
    Am = A.redistribute(MC, MR).canonical()
    xd = _data(x)
    if (uplo == LOWER and x.n == 1 and Am.m == Am.n == x.m
            and Am.dtype in (torch.float32, torch.float64)
            and xd.dtype == Am.dtype):
        yv = symv_lower(Am.data, xd[:, 0])
        prod = DistMatrix.from_padded(yv[:, None], Am.m, 1, MC, MR, Am.grid,
                                      Am.wrap)
        return _accumulate(y, prod, alpha, beta)
    Afull = MakeSymmetric(uplo, Am, conjugate=conjugate)
    return Gemm(NORMAL, NORMAL, alpha, Afull, x, beta=beta, C=y)


def Hemv(uplo: UpperOrLower, alpha, A: DistMatrix, x: DistMatrix,
         beta=0.0, y: Optional[DistMatrix] = None) -> DistMatrix:
    """Reference: Hemv.cpp (real data: Symv)."""
    return Symv(uplo, alpha, A, x, beta=beta, y=y, conjugate=True)


def Ger(alpha, x: DistMatrix, y: DistMatrix, A: DistMatrix) -> DistMatrix:
    """A += alpha x y^H (reference: Ger.cpp)."""
    return Gemm(NORMAL, ADJOINT, alpha, x, y, beta=1.0, C=A)


def Geru(alpha, x: DistMatrix, y: DistMatrix, A: DistMatrix) -> DistMatrix:
    """A += alpha x y^T (reference: Geru.cpp)."""
    return Gemm(NORMAL, TRANSPOSE, alpha, x, y, beta=1.0, C=A)


def _update(uplo: UpperOrLower, terms, A: DistMatrix) -> DistMatrix:
    """A += sum of alpha x y over ``terms`` on the uplo triangle, one K2
    launch a term."""
    Am = A.redistribute(MC, MR).canonical()
    out = Am.data
    for alpha, x, y in terms:
        out = _rank_k(uplo, alpha, x, y, 1.0, out)
    return Am.with_data(out)


def _prime(v: torch.Tensor, conjugate: bool) -> torch.Tensor:
    return v.mH if conjugate else v.mT


def Her(uplo: UpperOrLower, alpha, x: DistMatrix, A: DistMatrix
        ) -> DistMatrix:
    """A += alpha x x^H on the triangle (reference: Her.cpp)."""
    xd = _data(x)
    return _update(uplo, [(alpha, xd, xd.mH)], A)


def Syr(uplo: UpperOrLower, alpha, x: DistMatrix, A: DistMatrix,
        conjugate: bool = False) -> DistMatrix:
    """A += alpha x x^T on the triangle (reference: Syr.cpp)."""
    xd = _data(x)
    return _update(uplo, [(alpha, xd, _prime(xd, conjugate))], A)


def Her2(uplo: UpperOrLower, alpha, x: DistMatrix, y: DistMatrix,
         A: DistMatrix) -> DistMatrix:
    """A += alpha x y^H + conj(alpha) y x^H on the triangle
    (reference: Her2.cpp)."""
    xd, yd = _data(x), _data(y)
    calpha = alpha.conjugate() if isinstance(alpha, complex) else alpha
    return _update(uplo, [(alpha, xd, yd.mH), (calpha, yd, xd.mH)], A)


def Syr2(uplo: UpperOrLower, alpha, x: DistMatrix, y: DistMatrix,
         A: DistMatrix, conjugate: bool = False) -> DistMatrix:
    """A += alpha (x y' + y x') on the triangle (reference: Syr2.cpp)."""
    xd, yd = _data(x), _data(y)
    return _update(uplo, [(alpha, xd, _prime(yd, conjugate)),
                          (alpha, yd, _prime(xd, conjugate))], A)


def Trmv(uplo: UpperOrLower, orientation: Orientation, diag: UnitOrNonUnit,
         A: DistMatrix, x: DistMatrix) -> DistMatrix:
    """x := op(T) x for triangular T (reference: Trmv.cpp): Trmm on the
    column."""
    return Trmm(LEFT, uplo, orientation, diag, 1.0, A, x)


def Trsv(uplo: UpperOrLower, orientation: Orientation, diag: UnitOrNonUnit,
         A: DistMatrix, x: DistMatrix) -> DistMatrix:
    """Triangular solve with one right-hand side (reference:
    src/blas_like/level2/Trsv): Trsm on the column."""
    return Trsm(LEFT, uplo, orientation, diag, 1.0, A, x)


def Trr(uplo: UpperOrLower, alpha, x: DistMatrix, y: DistMatrix,
        A: DistMatrix, conjugate: bool = False) -> DistMatrix:
    """Triangular rank-1 update: the uplo triangle of A += alpha x y'
    (reference: Trr.cpp)."""
    return _update(uplo, [(alpha, _data(x), _prime(_data(y), conjugate))], A)


def Trr2(uplo: UpperOrLower, alpha, X: DistMatrix, Y: DistMatrix,
         A: DistMatrix, conjugate: bool = False) -> DistMatrix:
    """Triangular rank-2 update: the uplo triangle of A += alpha X Y' for
    X, Y of width 2 (reference: Trr2.cpp)."""
    return _update(uplo, [(alpha, _data(X), _prime(_data(Y), conjugate))], A)


def ApplyGivensSequence(side: LeftOrRight, seq_type: str, direction: str,
                        c, s, A: DistMatrix) -> DistMatrix:
    """Apply a sequence of Givens rotations (reference:
    ApplyGivensSequence.cpp, the {s,d,c,z}lasr analogue).

    ``seq_type``: 'variable' (rotation i couples (i, i+1)), 'top'
    (couples (0, i+1)), 'bottom' (couples (i, last)); ``direction``:
    'forward' or 'backward'. Rotation k maps the pair (p, q) to
    p' = s_k q + c_k p, q' = c_k q - conj(s_k) p. Each rotation is one
    update of a row (LEFT) or column (RIGHT) pair; the chain is
    sequential by construction."""
    Am = A.redistribute(MC, MR).canonical()
    d = Am.data.clone()
    left = side == LEFT
    m = A.m if left else A.n
    nrot = m - 1
    if nrot <= 0:
        return Am
    cs = torch.as_tensor(c, device=d.device).reshape(-1).to(d.real.dtype)
    sn = torch.as_tensor(s, device=d.device).reshape(-1).to(d.dtype)
    st = seq_type.lower()
    ks = list(range(nrot))
    if st.startswith("variable"):
        pairs = [(k, k + 1, k) for k in ks]
    elif st.startswith("top"):
        pairs = [(0, k + 1, k) for k in ks]
    elif st.startswith("bottom"):
        pairs = [(k, m - 1, k) for k in ks]
    else:
        raise ValueError(f"unknown Givens sequence type: {seq_type!r}")
    if direction.lower().startswith("back"):
        pairs.reverse()
    view = d if left else d.mT
    for p, q, i in pairs:
        rp, rq = view[p].clone(), view[q].clone()
        ck, sk = cs[i], sn[i]
        view[p] = sk * rq + ck * rp
        view[q] = ck * rq - sk.conj() * rp
    return Am.with_data(Am.mask_padding(d))
