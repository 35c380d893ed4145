"""LQ and RQ factorizations.

Counterpart of ``elementalx/lapack/lq.py`` (reference:
src/lapack_like/factor/LQ/ and factor/RQ/, Householder from the right).
As there, they ride on the QR engine through conjugate transposition:
LQ(A) = QR(A^H)^H, each Adjoint a K9 transpose on a CUDA tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..blas.level1 import Adjoint, MakeTrapezoidal
from ..core.dmatrix import DistMatrix, pad_array
from ..core.grid import Grid
from ..core.types import MC, MR, UPPER
from .qr import QR, ExplicitQR, tau_from_reference


class LQFactorization(NamedTuple):
    """L in the lower triangle of ``packed``, the reflectors above it."""

    packed: DistMatrix
    tau: torch.Tensor

    @staticmethod
    def from_reference(packed: np.ndarray, tau: np.ndarray, m: int, n: int,
                       grid: Optional[Grid] = None) -> "LQFactorization":
        """The port's factorization for a JAX package LQFactorization,
        given its packed data and tau read through numpy and the logical
        m x n; tau (one per row reflector) is cut to the port's padded
        height."""
        P = DistMatrix.from_reference(packed, m, n, grid=grid)
        return LQFactorization(P, tau_from_reference(tau, P.data.shape[0],
                                                     grid))


def LQ(A: DistMatrix, blocksize: Optional[int] = None) -> LQFactorization:
    """A = L Q (reference: LQ.cpp), computed as QR(A^H)^H."""
    fact = QR(Adjoint(A), blocksize)
    return LQFactorization(Adjoint(fact.packed), fact.tau.conj())


def ExplicitLQ(A: DistMatrix, blocksize: Optional[int] = None,
               full: bool = False) -> Tuple[DistMatrix, DistMatrix]:
    """(L, Q) with Q having orthonormal rows (reference: lq::Explicit).
    full=True returns the square n x n Q (L becomes m x n trapezoidal)."""
    Qh, Rh = ExplicitQR(Adjoint(A), blocksize, thin=not full)
    return Adjoint(Rh), Adjoint(Qh)


def _flipped(d: torch.Tensor, m: int, n: int, A: DistMatrix) -> DistMatrix:
    """The m x n corner of d with its rows and columns reversed (numpy's
    [::-1, ::-1]), as an [MC,MR] matrix on A's grid."""
    fl = torch.flip(d[:m, :n], dims=(0, 1))
    return DistMatrix.from_padded(pad_array(fl, A.grid), m, n, MC, MR,
                                  A.grid, A.wrap)


def ExplicitRQ(A: DistMatrix, blocksize: Optional[int] = None,
               full: bool = False) -> Tuple[DistMatrix, DistMatrix]:
    """A = R Q with R upper triangular/trapezoidal (reference: factor/RQ/),
    through the flip trick on LQ. full=True returns the square n x n Q and
    an m x n trapezoidal R (the LAPACK ggrqf shape)."""
    m, n = A.m, A.n
    Afl = _flipped(A.redistribute(MC, MR).data, m, n, A)
    Lf, Qf = ExplicitLQ(Afl, blocksize, full=full)
    if full:
        # A = (J_m Ltrap J_n)(J_n Qf J_n)
        return _flipped(Lf.data, m, n, A), _flipped(Qf.data, n, n, A)
    R = _flipped(Lf.data, m, m, A)
    return MakeTrapezoidal(UPPER, R), _flipped(Qf.data, m, n, A)
