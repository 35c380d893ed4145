"""Triangular solve with multiple right-hand sides.

Counterpart of ``elementalx/blas/trsm.py`` (reference:
src/blas_like/level3/Trsm.cpp:121-157): a blocked partitioned-inverse
substitution. The diagonal blocks are inverted once, batched
(blas/trinv.py); the solve then recursively halves the triangle, so each
off-diagonal update is one product over exactly the strictly triangular
part. Every product goes through ``local_gemm`` and so, on the GPU,
through the K1 kernel. All eight side/uplo/orientation cases reduce to a
LEFT, NORMAL solve on a transposed view of the operands.

The JAX package runs its f32 products at bf16x3 precision; the port runs
them in full FP32. bfloat16 operands are solved through float32 carriers.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import trace
from ..core.dmatrix import DistMatrix, check_same_grid
from ..core.environment import Blocksize
from ..core.types import (
    ADJOINT,
    LEFT,
    LOWER,
    LeftOrRight,
    MC,
    MR,
    NORMAL,
    Orientation,
    RIGHT,
    TRANSPOSE,
    UNIT,
    UnitOrNonUnit,
    UpperOrLower,
)
from .gemm import local_gemm

_LOW = (torch.bfloat16, torch.float16)


def _pick_nb(M: int, want: int) -> int:
    nb = min(want, M)
    while M % nb != 0:
        nb -= 1
    return nb


@trace.traced("blas.trsm.prep")
def _prep_triangle(T: torch.Tensor, m: int, lower: bool,
                   unit: bool) -> torch.Tensor:
    """Mask to the triangle, force unit diagonal if requested, and set the
    padding diagonal (rows/cols >= m) to 1 so diagonal blocks stay
    invertible."""
    M = T.shape[0]
    i = torch.arange(M, device=T.device)[:, None]
    j = torch.arange(M, device=T.device)[None, :]
    keep = (j <= i) if lower else (j >= i)
    zero = torch.zeros((), dtype=T.dtype, device=T.device)
    one = torch.ones((), dtype=T.dtype, device=T.device)
    T = torch.where(keep, T, zero)
    diag = i == j
    if unit:
        return torch.where(diag, one, T)
    return torch.where(diag & (i >= m), one, T)


@trace.traced("blas.trsm.diag_inv")
def _batched_diag_inv(T: torch.Tensor, nb: int, nblk: int,
                      lower: bool) -> torch.Tensor:
    """Inverses of the nb x nb diagonal blocks, as one (nblk, nb, nb)
    batch read through a strided view of T."""
    from .trinv import tri_inv_lower, tri_inv_upper

    s0, s1 = T.stride()
    blocks = T.as_strided((nblk, nb, nb), (nb * (s0 + s1), s0, s1),
                          T.storage_offset())
    return (tri_inv_lower if lower else tri_inv_upper)(blocks)


def _left_solve(T: torch.Tensor, B: torch.Tensor, lower: bool,
                nb: int) -> torch.Tensor:
    """Solve T X = B for triangular T (already prepped), blocked by
    recursive halving down to the batched diagonal-block inverses."""
    if T.dtype in _LOW:
        out = _left_solve(T.float(), B.float(), lower, nb)
        return out.to(B.dtype)
    M = T.shape[0]
    # at most 32 sequential base steps (as the JAX package caps them)
    nb = _pick_nb(M, max(nb, -(-M // 32)))
    nblk = M // nb
    tri_inv = _batched_diag_inv(T, nb, nblk, lower)

    def rec(k_lo: int, k_hi: int, Bp: torch.Tensor) -> torch.Tensor:
        if k_hi - k_lo == 1:
            return local_gemm(tri_inv[k_lo], Bp)
        k_mid = (k_lo + k_hi) // 2
        lo0, mid0, hi0 = k_lo * nb, k_mid * nb, k_hi * nb
        if lower:
            X1 = rec(k_lo, k_mid, Bp[: mid0 - lo0])
            R2 = Bp[mid0 - lo0:] - local_gemm(T[mid0:hi0, lo0:mid0], X1)
            X2 = rec(k_mid, k_hi, R2)
        else:
            X2 = rec(k_mid, k_hi, Bp[mid0 - lo0:])
            R1 = Bp[: mid0 - lo0] - local_gemm(T[lo0:mid0, mid0:hi0], X2)
            X1 = rec(k_lo, k_mid, R1)
        return torch.cat([X1, X2], dim=0)

    return rec(0, nblk, B)


def _right_solve_adjoint_lower(T: torch.Tensor, B: torch.Tensor,
                               nb: int) -> torch.Tensor:
    """Solve X T^H = B for lower-triangular T (already prepped): a RIGHT
    solve against T^H through column blocks of X, each step one
    (P, M) x (M, nb) product; T^H is only ever a view."""
    if T.dtype in _LOW:
        out = _right_solve_adjoint_lower(T.float(), B.float(), nb)
        return out.to(B.dtype)
    M = T.shape[0]
    nb = _pick_nb(M, max(nb, -(-M // 32)))
    nblk = M // nb
    tri_inv = _batched_diag_inv(T, nb, nblk, True)

    # [X1 X2] [[T11,.],[T21,T22]]^H = [B1 B2] =>
    # X1 = B1 inv(T11)^H;  X2 = (B2 - X1 T21^H) inv(T22)^H
    def rec(k_lo: int, k_hi: int, Bp: torch.Tensor) -> torch.Tensor:
        if k_hi - k_lo == 1:
            return local_gemm(Bp, tri_inv[k_lo].mH)
        k_mid = (k_lo + k_hi) // 2
        lo0, mid0, hi0 = k_lo * nb, k_mid * nb, k_hi * nb
        X1 = rec(k_lo, k_mid, Bp[:, : mid0 - lo0])
        R2 = Bp[:, mid0 - lo0:] - local_gemm(X1, T[mid0:hi0, lo0:mid0].mH)
        X2 = rec(k_mid, k_hi, R2)
        return torch.cat([X1, X2], dim=1)

    return rec(0, nblk, B)


def Trsm(side: LeftOrRight, uplo: UpperOrLower, orientation: Orientation,
         diag: UnitOrNonUnit, alpha, A: DistMatrix, B: DistMatrix,
         blocksize: Optional[int] = None) -> DistMatrix:
    """Solve op(A) X = alpha B (LEFT) or X op(A) = alpha B (RIGHT)
    (reference: Trsm.cpp driver). Returns X as [MC,MR]."""
    check_same_grid(A, B)
    with trace.span("blas.Trsm", A.device):
        return _trsm(side, uplo, orientation, diag, alpha, A, B, blocksize)


def _trsm(side: LeftOrRight, uplo: UpperOrLower, orientation: Orientation,
          diag: UnitOrNonUnit, alpha, A: DistMatrix, B: DistMatrix,
          blocksize: Optional[int]) -> DistMatrix:
    Ad = A.redistribute(MC, MR).data
    Bm = B.redistribute(MC, MR)
    nb = blocksize or Blocksize()
    unit = diag == UNIT
    lower = uplo == LOWER

    # op(A) as a view; its triangle flips under transposition
    if orientation == NORMAL:
        T, tlower = Ad, lower
    elif orientation == TRANSPOSE:
        T, tlower = Ad.mT, not lower
    elif orientation == ADJOINT:
        T, tlower = Ad.mH, not lower
    else:
        raise ValueError(orientation)

    if side == LEFT:
        T = _prep_triangle(T, A.m, tlower, unit)
        X = _left_solve(T, Bm.data * alpha, tlower, nb)
        return Bm.with_data(X)
    if side == RIGHT:
        # X op(A) = alpha B  <=>  op(A)^T X^T = alpha B^T
        Tt = _prep_triangle(T.mT, A.m, not tlower, unit)
        Xt = _left_solve(Tt, Bm.data.mT * alpha, not tlower, nb)
        return DistMatrix.from_padded(Xt.mT, Bm.m, Bm.n, MC, MR, Bm.grid,
                                      Bm.wrap)
    raise ValueError(side)
