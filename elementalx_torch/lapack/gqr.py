"""Generalized QR / RQ factorizations.

Counterpart of ``elementalx/lapack/gqr.py`` (reference:
src/lapack_like/factor/GQR.cpp and GRQ.cpp), the pencil factorizations
of LAPACK's GLM/LSE formulation, built on the QR and RQ engines:
  GQR(A, B): A = Q R,  B = Q T Z
  GRQ(A, B): A = R Q,  B = Z T Q
"""

from __future__ import annotations

from typing import Tuple

from ..blas.gemm import Gemm
from ..core.dmatrix import DistMatrix
from ..core.types import ADJOINT, NORMAL
from .lq import ExplicitRQ
from .qr import ExplicitQR


def GQR(A: DistMatrix, B: DistMatrix
        ) -> Tuple[DistMatrix, DistMatrix, DistMatrix, DistMatrix]:
    """(Q, R, T, Z) with A = Q R and B = Q T Z (reference: GQR.cpp)."""
    Q, R = ExplicitQR(A, thin=False)
    QhB = Gemm(ADJOINT, NORMAL, 1.0, Q, B)
    T, Z = ExplicitRQ(QhB, full=True)
    return Q, R, T, Z


def GRQ(A: DistMatrix, B: DistMatrix
        ) -> Tuple[DistMatrix, DistMatrix, DistMatrix, DistMatrix]:
    """(R, Q, Z, T) with A = R Q and B = Z T Q (reference: GRQ.cpp)."""
    R, Q = ExplicitRQ(A, full=True)
    BQh = Gemm(NORMAL, ADJOINT, 1.0, B, Q)
    Z, T = ExplicitQR(BQh, thin=False)
    return R, Q, Z, T
