"""GEMM: C := alpha op(A) op(B) + beta C.

Counterpart of ``elementalx/blas/gemm.py`` (reference:
src/blas_like/level3/Gemm.cpp) on its single-device path: on a 1 x 1
grid the JAX driver always takes ``GEMM_XLA``, one local product of the
padded operands. Here that product is ``local_gemm``, which on a CUDA
tensor launches the hand-written K1 kernel (kernels/matmul.py).

Orientations are normalised to NN through transposed views, which K1
reads in place through their strides.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.dmatrix import DistMatrix, check_same_grid
from ..core.types import (
    ADJOINT,
    GEMM_DEFAULT,
    GEMM_XLA,
    GemmAlgorithm,
    MC,
    MR,
    NORMAL,
    Orientation,
    TRANSPOSE,
)
from ..kernels.matmul import matmul


def local_gemm(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Local-block matmul (the blas::Gemm/cublas::Gemm analogue,
    Gemm.cpp:83-160): K1 on CUDA tensors, its plain version on the CPU.
    bf16 inputs accumulate in f32. The result has ``a.dtype`` unless
    ``out_dtype`` asks for the f32 result of a bf16 product (the
    ``preferred_element_type`` of the JAX drivers)."""
    return matmul(a, b, out_dtype=out_dtype)


def _orient(X: DistMatrix, orientation: Orientation) -> DistMatrix:
    from .level1 import Adjoint, Transpose

    if orientation == NORMAL:
        return X
    if orientation == TRANSPOSE:
        return Transpose(X)
    if orientation == ADJOINT:
        return Adjoint(X)
    raise ValueError(orientation)


def _accumulate(C: Optional[DistMatrix], prod_dm: DistMatrix, alpha,
                beta) -> DistMatrix:
    dt = prod_dm.dtype
    if C is None or (isinstance(beta, (int, float)) and beta == 0):
        out = prod_dm.with_data(prod_dm.data * alpha)
        if C is not None:
            out = DistMatrix.from_padded(out.data.to(C.dtype), C.m, C.n,
                                         C.col_dist, C.row_dist, C.grid,
                                         C.wrap)
        return out
    Cd = C.redistribute(MC, MR)
    data = (alpha * prod_dm.data + beta * Cd.data.to(dt)).to(C.dtype)
    return Cd.with_data(data)


def Gemm(orientA: Orientation, orientB: Orientation, alpha, A: DistMatrix,
         B: DistMatrix, beta=0.0, C: Optional[DistMatrix] = None,
         alg: GemmAlgorithm = GEMM_DEFAULT,
         blocksize: Optional[int] = None) -> DistMatrix:
    """C := alpha op(A) op(B) + beta C (reference: Gemm.cpp:279).

    Returns a new [MC,MR] DistMatrix. If C is None, beta must be 0. The
    explicit SUMMA and Cannon algorithms need a grid of several devices and
    raise NotImplementedError."""
    check_same_grid(A, B, *(() if C is None else (C,)))
    An = _orient(A.redistribute(MC, MR), orientA)
    Bn = _orient(B.redistribute(MC, MR), orientB)
    An = An.redistribute(MC, MR).canonical()
    Bn = Bn.redistribute(MC, MR).canonical()
    if C is not None:
        C = C.canonical()
    m, k, n = An.m, An.n, Bn.n
    if Bn.m != k:
        raise ValueError(f"Gemm: inner dims mismatch {An.shape} x {Bn.shape}")
    if alg not in (GEMM_DEFAULT, GEMM_XLA):
        raise NotImplementedError(
            f"Gemm: {GemmAlgorithm(alg).name} needs a multi-GPU grid "
            "(ROADMAP queue 1 item 11)")
    prod = local_gemm(An.data, Bn.data)
    prod_dm = DistMatrix.from_padded(prod, m, n, MC, MR, A.grid, A.wrap)
    return _accumulate(C, prod_dm, alpha, beta)
