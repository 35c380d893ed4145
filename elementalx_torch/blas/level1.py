"""BLAS-like level 1: entrywise, structural and reduction operations.

Counterpart of ``elementalx/blas/level1.py`` (reference:
include/El/blas_like/level1/*.hpp, src/blas_like/level1/), function for
function. As there, each op is one tensor expression on the padded data
and all of them keep the padding zero: an op whose function does not map
0 to 0 re-masks it.

The operations that Hydrogen runs on its ``gpu/*.cu`` kernels go through
K9 (kernels/elementwise.py), which launches a hand-written CUDA kernel on
a CUDA tensor and takes its plain version on the CPU: Scale, SafeScale,
Axpy, Axpby, Add, Subtract, Hadamard, Zero, Fill, Transpose and Adjoint.
The rest are plain torch.

On a grid of several positions (a sharded DistMatrix) only what the
distributed GEMM needs has a distributed form: Scale and Axpby act per
position, Nrm2 reduces over positions. The rest read the global tensor
and raise NotImplementedError there (ROADMAP queue 1 item 11).

``Transpose`` and ``Adjoint`` write a new matrix, as Hydrogen's
``Transpose(A, B)`` does. Code that only reads op(A) (Gemm, the level-3
updates, Trsm, the row reductions here) takes a strided view instead
(``_transposed_view``), which the kernels read in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple, Union

import numpy as np
import torch

from ..core import collectives
from ..core.dmatrix import DistMatrix, check_same_grid, pad_array
from ..core.types import (
    ADJOINT,
    LEFT,
    LOWER,
    MC,
    MD,
    MR,
    STAR,
    UPPER,
    UpperOrLower,
)
from ..kernels.elementwise import (
    device_scalar,
    axpby,
    fill,
    hadamard,
    scale,
    transpose,
)

Scalar = Union[float, complex, torch.Tensor]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _like(A: DistMatrix, data: torch.Tensor) -> DistMatrix:
    return A.with_data(data)


def _as_tensor(x, device=None) -> torch.Tensor:
    """A tensor from a tensor or a number/array (numbers through numpy, so
    a Python float is float64 and a complex is complex128, as under the
    JAX package's x64)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _binary(A: DistMatrix, B: DistMatrix, f) -> DistMatrix:
    """f(A's data, B's data) on A's distribution; operands of two types
    are promoted to the common one first."""
    check_same_grid(A, B)
    if A.shape != B.shape:
        raise ValueError(f"shape mismatch {A.shape} vs {B.shape}")
    Bd = B.data if B.dist == A.dist else B.redistribute(*A.dist).data
    Ad = A.data
    if Ad.dtype != Bd.dtype:
        dt = torch.promote_types(Ad.dtype, Bd.dtype)
        Ad, Bd = Ad.to(dt), Bd.to(dt)
    return _like(A, f(Ad, Bd))


def _iota(A: DistMatrix):
    """Row and column index grids of the padded data, (P, 1) and (1, Q)."""
    P, Q = A.data.shape
    i = torch.arange(P, device=A.device)[:, None]
    j = torch.arange(Q, device=A.device)[None, :]
    return i, j


# ---------------------------------------------------------------------------
# fills / structure
# ---------------------------------------------------------------------------


def Zero(A: DistMatrix) -> DistMatrix:
    """Reference: blas_like/level1/Zero.hpp (K9's fill with 0)."""
    return _like(A, fill(A.data.shape, 0.0, A.dtype, A.device))


def Fill(A: DistMatrix, alpha: Scalar) -> DistMatrix:
    """Fill the logical region with alpha, the padding with 0 (reference:
    Fill.hpp; K9's fill)."""
    return _like(A, fill(A.data.shape, alpha, A.dtype, A.device,
                         extent=(A.m, A.n)))


def FillDiagonal(A: DistMatrix, alpha, offset: int = 0) -> DistMatrix:
    """Set the given diagonal of the logical region to alpha (reference:
    FillDiagonal.hpp)."""
    i, j = _iota(A)
    on_diag = (j - i == offset) & A.pad_mask()
    val = device_scalar(alpha, A.dtype, A.device)
    return A.with_data(torch.where(on_diag, val, A.data))


def ShiftDiagonal(A: DistMatrix, alpha: Scalar, offset: int = 0) -> DistMatrix:
    """A += alpha*I on the given diagonal (reference: ShiftDiagonal.hpp)."""
    i, j = _iota(A)
    on_diag = (j - i == offset) & A.pad_mask()
    val = device_scalar(alpha, A.dtype, A.device)
    return _like(A, A.data + torch.where(on_diag, val, torch.zeros_like(val)))


def MakeTrapezoidal(uplo: UpperOrLower, A: DistMatrix,
                    offset: int = 0) -> DistMatrix:
    """Zero outside the upper/lower trapezoid (reference: MakeTrapezoidal.hpp)."""
    d = torch.triu(A.data, offset) if uplo == UPPER else torch.tril(A.data, offset)
    return A.with_data(d)


def ScaleTrapezoid(alpha: Scalar, uplo: UpperOrLower, A: DistMatrix,
                   offset: int = 0) -> DistMatrix:
    """Scale the trapezoid by alpha (reference: ScaleTrapezoid.hpp)."""
    i, j = _iota(A)
    inside = (j - i >= offset) if uplo == UPPER else (j - i <= offset)
    a = device_scalar(alpha, A.dtype, A.device)
    return _like(A, torch.where(inside, A.data * a, A.data))


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


def MakeReal(A: DistMatrix) -> DistMatrix:
    return _like(A, A.data.real.to(A.dtype) if A.data.is_complex()
                 else A.data)


def Conjugate(A: DistMatrix) -> DistMatrix:
    return _like(A, torch.conj_physical(A.data))


def RealPart(A: DistMatrix) -> DistMatrix:
    return _like(A, A.data.real)


def ImagPart(A: DistMatrix) -> DistMatrix:
    d = A.data
    return _like(A, d.imag if d.is_complex() else torch.zeros_like(d))


# ---------------------------------------------------------------------------
# scaling / axpy family (K9)
# ---------------------------------------------------------------------------


def Scale(alpha: Scalar, A: DistMatrix) -> DistMatrix:
    """Reference: Scale.hpp (K9's scale; on a grid of several positions
    one launch per position)."""
    if A.sharded:
        return A.with_blocks(scale(alpha, b) for b in A.blocks)
    return _like(A, scale(alpha, A.data))


def SafeScale(numerator: Scalar, denominator: Scalar,
              A: DistMatrix) -> DistMatrix:
    """A *= num/den, staged as A (1/den), then times num, so that neither
    step overflows where the ratio alone would (reference: SafeScale.hpp;
    two K9 scale launches)."""
    if isinstance(denominator, torch.Tensor):
        inv = torch.reciprocal(denominator.to(A.device, A.dtype))
    else:
        inv = 1.0 / denominator
    return _like(A, scale(numerator, scale(inv, A.data)))


def Axpy(alpha: Scalar, X: DistMatrix, Y: DistMatrix) -> DistMatrix:
    """Y + alpha*X (reference: Axpy.hpp; K9's axpby with beta = 1)."""
    return _binary(Y, X, lambda y, x: axpby(alpha, x, 1.0, y))


def Axpby(alpha: Scalar, X: DistMatrix, beta: Scalar,
          Y: DistMatrix) -> DistMatrix:
    """beta*Y + alpha*X (K9's axpby; on a grid of several positions X is
    first brought to Y's distribution, then one launch per position)."""
    if Y.sharded:
        check_same_grid(Y, X)
        if Y.shape != X.shape:
            raise ValueError(f"shape mismatch {Y.shape} vs {X.shape}")
        Xb = X.redistribute(*Y.dist).blocks
        dt = torch.promote_types(Y.dtype, X.dtype)
        return Y.with_blocks(axpby(alpha, x.to(dt), beta, y.to(dt))
                             for x, y in zip(Xb, Y.blocks))
    return _binary(Y, X, lambda y, x: axpby(alpha, x, beta, y))


def Add(A: DistMatrix, B: DistMatrix) -> DistMatrix:
    """A + B (K9's axpby: 1 A + 1 B rounds as A + B)."""
    return _binary(A, B, lambda a, b: axpby(1.0, b, 1.0, a))


def Subtract(A: DistMatrix, B: DistMatrix) -> DistMatrix:
    """A - B (K9's axpby: 1 A + (-1) B rounds as A - B)."""
    return _binary(A, B, lambda a, b: axpby(-1.0, b, 1.0, a))


def Hadamard(A: DistMatrix, B: DistMatrix) -> DistMatrix:
    """Entrywise product (reference: Hadamard.hpp; K9's hadamard)."""
    return _binary(A, B, hadamard)


def Transpose(A: DistMatrix, conjugate: bool = False) -> DistMatrix:
    """B = A^T (or A^H), a new matrix; the dist tags transpose with the
    data (reference: Transpose.hpp; K9's tiled transpose)."""
    return DistMatrix.from_padded(transpose(A.data, conjugate), A.n, A.m,
                                  A.row_dist, A.col_dist, A.grid, A.wrap)


def Adjoint(A: DistMatrix) -> DistMatrix:
    return Transpose(A, conjugate=True)


def _transposed_view(A: DistMatrix, conjugate: bool = False) -> DistMatrix:
    """A^T (or A^H) as a view of A's data (``.mT``/``.mH``) with the dist
    tags swapped, for callers that only read it; Transpose writes a copy.
    On a grid of several positions each block is viewed so: the block a
    position holds of [U,V] A is the one it holds of [V,U] A^T."""
    if A.sharded:
        return dataclasses.replace(
            A, m=A.n, n=A.m, col_dist=A.row_dist, row_dist=A.col_dist,
            blocks=tuple(b.mH if conjugate else b.mT for b in A.blocks))
    d = A.data.mH if conjugate else A.data.mT
    return DistMatrix.from_padded(d, A.n, A.m, A.row_dist, A.col_dist,
                                  A.grid, A.wrap)


def Swap(A: DistMatrix, B: DistMatrix) -> Tuple[DistMatrix, DistMatrix]:
    """Functional swap (reference: Swap.hpp)."""
    return B.redistribute(*A.dist), A.redistribute(*B.dist)


def Broadcast(A: DistMatrix) -> DistMatrix:
    """No-op: one process holds everything (reference: Broadcast.hpp)."""
    return A


# ---------------------------------------------------------------------------
# maps
# ---------------------------------------------------------------------------


def EntrywiseMap(A: DistMatrix, f: Callable[[torch.Tensor], torch.Tensor]
                 ) -> DistMatrix:
    """B[i,j] = f(A[i,j]) (reference: EntrywiseMap.hpp). Re-masks padding
    since f(0) may be nonzero."""
    return _like(A, A.mask_padding(f(A.data)))


def EntrywiseFill(A: DistMatrix, f: Callable) -> DistMatrix:
    """Fill entrywise from a sampler (reference: EntrywiseFill.hpp). The
    sampler receives the padded shape and returns a tensor of it."""
    return _like(A, A.mask_padding(_as_tensor(f(tuple(A.data.shape)),
                                              A.device).to(A.dtype)))


def IndexDependentMap(A: DistMatrix, f: Callable) -> DistMatrix:
    """B[i,j] = f(i, j, A[i,j]) (reference: IndexDependentMap.hpp); i and j
    are full (P, Q) index grids."""
    i, j = _iota(A)
    P, Q = A.data.shape
    return _like(A, A.mask_padding(f(i.expand(P, Q), j.expand(P, Q), A.data)))


def IndexDependentFill(A: DistMatrix, f: Callable) -> DistMatrix:
    """B[i,j] = f(i, j) (reference: IndexDependentFill.hpp)."""
    i, j = _iota(A)
    P, Q = A.data.shape
    vals = _as_tensor(f(i.expand(P, Q), j.expand(P, Q)), A.device)
    return _like(A, A.mask_padding(vals.to(A.dtype)))


def Round(A: DistMatrix) -> DistMatrix:
    return EntrywiseMap(A, torch.round)


# ---------------------------------------------------------------------------
# diagonal access / scaling
# ---------------------------------------------------------------------------


def _diag_length(m: int, n: int, offset: int) -> int:
    if offset >= 0:
        return max(min(m, n - offset), 0)
    return max(min(m + offset, n), 0)


def GetDiagonal(A: DistMatrix, offset: int = 0) -> DistMatrix:
    """d = diag(A, offset) as a column vector tagged [MD,*] like the
    reference (reference: GetDiagonal.hpp)."""
    dlen = _diag_length(A.m, A.n, offset)
    d = torch.diagonal(A.data, offset)[:dlen]
    col = pad_array(d[:, None], A.grid)
    return DistMatrix.from_padded(col, dlen, 1, MD, STAR, A.grid, A.wrap)


def _diag_values(A: DistMatrix, d: DistMatrix, offset: int) -> torch.Tensor:
    """d's entries placed along A's offset diagonal (row index for
    offset >= 0, column index below), clamped to d's length."""
    dvec = d.replicated()[:, 0].to(A.device)
    i, j = _iota(A)
    idx = i if offset >= 0 else j
    return dvec[idx.clamp(0, dvec.shape[0] - 1)]


def SetDiagonal(A: DistMatrix, d: DistMatrix, offset: int = 0) -> DistMatrix:
    """Reference: SetDiagonal.hpp."""
    i, j = _iota(A)
    on_diag = (j - i == offset) & A.pad_mask()
    vals = _diag_values(A, d, offset).to(A.dtype)
    return _like(A, torch.where(on_diag, vals, A.data))


def UpdateDiagonal(A: DistMatrix, alpha: Scalar, d: DistMatrix,
                   offset: int = 0) -> DistMatrix:
    i, j = _iota(A)
    on_diag = (j - i == offset) & A.pad_mask()
    vals = _diag_values(A, d, offset).to(A.dtype)
    a = device_scalar(alpha, A.dtype, A.device)
    return _like(A, torch.where(on_diag, A.data + a * vals, A.data))


def DiagonalScale(side, orientation, d: DistMatrix,
                  A: DistMatrix) -> DistMatrix:
    """A := diag(d) A (LEFT) or A diag(d) (RIGHT), conjugating d for
    ADJOINT (reference: DiagonalScale.hpp)."""
    dvec = d.replicated()[:, 0].to(A.device)
    if orientation == ADJOINT:
        dvec = dvec.conj()
    dvec = dvec.to(A.dtype)
    if side == LEFT:
        return _like(A, A.data * dvec[: A.data.shape[0], None])
    return _like(A, A.data * dvec[None, : A.data.shape[1]])


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


# ---------------------------------------------------------------------------
# submatrix access (reference: GetSubmatrix.hpp / SetSubmatrix.hpp)
# ---------------------------------------------------------------------------


def GetSubmatrix(A: DistMatrix, I: slice, J: slice) -> DistMatrix:
    """B = A(I, J) for contiguous index ranges (the IR(a,b) idiom)."""
    i0, i1 = I.indices(A.m)[:2]
    j0, j1 = J.indices(A.n)[:2]
    sub = A.data[i0:i1, j0:j1]
    return DistMatrix.from_padded(pad_array(sub, A.grid), i1 - i0, j1 - j0,
                                  A.col_dist, A.row_dist, A.grid, A.wrap)


def _clamp_corner(A: DistMatrix, i0: int, j0: int,
                  shape) -> Tuple[int, int]:
    """The corner clamped so the block fits, as dynamic_update_slice does."""
    P, Q = A.data.shape
    return (min(max(i0, 0), P - shape[0]), min(max(j0, 0), Q - shape[1]))


def SetSubmatrix(A: DistMatrix, i0: int, j0: int, B: DistMatrix) -> DistMatrix:
    """A(i0:i0+mb, j0:j0+nb) = B."""
    Bd = B.redistribute(*A.dist).data[: B.m, : B.n]
    i0, j0 = _clamp_corner(A, i0, j0, Bd.shape)
    out = A.data.clone()
    out[i0:i0 + Bd.shape[0], j0:j0 + Bd.shape[1]] = Bd.to(A.dtype)
    return _like(A, A.mask_padding(out))


def UpdateSubmatrix(A: DistMatrix, i0: int, j0: int, alpha: Scalar,
                    B: DistMatrix) -> DistMatrix:
    Bd = B.redistribute(*A.dist).data[: B.m, : B.n]
    i0, j0 = _clamp_corner(A, i0, j0, Bd.shape)
    out = A.data.clone()
    a = device_scalar(alpha, A.dtype, A.device)
    blk = out[i0:i0 + Bd.shape[0], j0:j0 + Bd.shape[1]]
    blk.copy_(blk + a * Bd.to(A.dtype))
    return _like(A, A.mask_padding(out))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def Dot(A: DistMatrix, B: DistMatrix) -> torch.Tensor:
    """<A, B> = sum conj(A) * B (reference: Dot.hpp)."""
    check_same_grid(A, B)
    Bd = B.redistribute(*A.dist).data
    return torch.sum(A.data.conj() * Bd)


def Dotu(A: DistMatrix, B: DistMatrix) -> torch.Tensor:
    """Unconjugated dot (reference: Dotu.hpp)."""
    check_same_grid(A, B)
    Bd = B.redistribute(*A.dist).data
    return torch.sum(A.data * Bd)


def _scaled_squares(d: torch.Tensor):
    """(scale, ss) with scale = max|d| and ss = sum((|d| / scale)^2)
    (scale 1 where d is 0)."""
    absa = torch.abs(d)
    scale_ = torch.max(absa)
    return scale_, torch.sum((absa / _safe(scale_)) ** 2)


def _safe(scale_: torch.Tensor) -> torch.Tensor:
    return torch.where(scale_ == 0, torch.ones_like(scale_), scale_)


def Nrm2(A: DistMatrix) -> torch.Tensor:
    """Frobenius/2-norm via scaled squares for overflow safety
    (reference: Nrm2.hpp, NormsFromScaledSquares.hpp). On a grid of
    several positions: each distinct block's own scaled squares, then one
    reduction over positions (an all-gather of the (scale, ss) pairs),
    combined at position (0, 0); the result lies on its device."""
    if not A.sharded:
        scale_, ss = _scaled_squares(A.data)
    else:
        ranges = A.block_ranges()
        pairs = []
        for q, b in enumerate(A.blocks):
            s_, ss = _scaled_squares(b)
            if ranges.index(ranges[q]) != q:   # a replica: counted once
                s_, ss = torch.zeros_like(s_), torch.zeros_like(ss)
            pairs.append(torch.stack([s_, ss]).view(1, 2))
        allp = collectives.all_gather(pairs, A.grid, "vc", 0)[0]
        scales, sss = allp[:, 0], allp[:, 1]
        scale_ = torch.max(scales)
        ss = torch.sum(sss * (scales / _safe(scale_)) ** 2)
    return torch.where(scale_ == 0, torch.zeros_like(scale_),
                       _safe(scale_) * torch.sqrt(ss))


def MaxAbs(A: DistMatrix) -> torch.Tensor:
    return torch.max(torch.abs(A.data))


def MinAbs(A: DistMatrix) -> torch.Tensor:
    absa = torch.abs(A.data)
    big = torch.full((), float("inf"), dtype=absa.dtype, device=A.device)
    return torch.min(torch.where(A.pad_mask(), absa, big))


def MaxAbsLoc(A: DistMatrix) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(value, i, j) of the max-|.| entry (reference: MaxAbsLoc.hpp, the
    MaxLocOp AllReduce): argmax and an integer decode."""
    absa = torch.abs(A.data)
    absa = torch.where(A.pad_mask(), absa,
                       torch.full((), -1, dtype=absa.dtype, device=A.device))
    flat = absa.reshape(-1)
    k = torch.argmax(flat)
    Q = A.data.shape[1]
    return flat[k], k // Q, k % Q


def VectorMaxAbsLoc(x: DistMatrix) -> Tuple[torch.Tensor, torch.Tensor]:
    v, i, j = MaxAbsLoc(x)
    return v, i if x.n == 1 else j


def Max(A: DistMatrix) -> torch.Tensor:
    small = torch.full((), float("-inf"), dtype=A.dtype, device=A.device)
    return torch.max(torch.where(A.pad_mask(), A.data, small))


def Min(A: DistMatrix) -> torch.Tensor:
    big = torch.full((), float("inf"), dtype=A.dtype, device=A.device)
    return torch.min(torch.where(A.pad_mask(), A.data, big))


def EntrywiseNorm(A: DistMatrix, p: float = 1.0) -> torch.Tensor:
    """(sum |a_ij|^p)^(1/p) (reference: props/Norm/Entrywise)."""
    return torch.sum(torch.abs(A.data) ** p) ** (1.0 / p)


def ColumnNorms(A: DistMatrix) -> torch.Tensor:
    """2-norms of each column, scaled-squares style (reference:
    ColumnNorms via NormsFromScaledSquares.hpp). Returns a padded (Q,)
    vector; entries >= n are zero."""
    absa = torch.abs(A.data)
    scales = torch.amax(absa, dim=0)
    safe = torch.where(scales == 0, torch.ones_like(scales), scales)
    ss = torch.sum((absa / safe[None, :]) ** 2, dim=0)
    return torch.where(scales == 0, scales, safe * torch.sqrt(ss))


def RowNorms(A: DistMatrix) -> torch.Tensor:
    return ColumnNorms(_transposed_view(A))


def ColumnMaxNorms(A: DistMatrix) -> torch.Tensor:
    return torch.amax(torch.abs(A.data), dim=0)


def Trace(A: DistMatrix) -> torch.Tensor:
    """Reference: props/Trace.cpp (sum of the diagonal; padding diag is 0)."""
    return torch.sum(torch.diagonal(A.data))


# -- remaining level-1 surface (completing the reference header census) -----


def AxpyTrapezoid(uplo: UpperOrLower, alpha: Scalar, X: DistMatrix,
                  Y: DistMatrix, offset: int = 0) -> DistMatrix:
    """Y += alpha * trapezoid(X) (reference: level1/AxpyTrapezoid.hpp)."""
    check_same_grid(X, Y)
    Xt = MakeTrapezoidal(uplo, X, offset)
    a = device_scalar(alpha, Y.dtype, Y.device)
    return _like(Y, Y.data + a * Xt.data.to(Y.dtype))


def TransposeAxpy(alpha: Scalar, X: DistMatrix, Y: DistMatrix,
                  conjugate: bool = False) -> DistMatrix:
    """Y += alpha X^T (or X^H) (reference: level1/TransposeAxpy.hpp)."""
    return Axpy(alpha, _transposed_view(X, conjugate), Y)


def Concatenate(A: DistMatrix, B: DistMatrix, axis: int = 1) -> DistMatrix:
    """[A, B] (axis=1) or [A; B] (axis=0) (reference:
    level1/Concatenate.hpp HCat/VCat)."""
    g = check_same_grid(A, B)
    if axis == 1:
        if A.m != B.m:
            raise ValueError("HCat requires equal heights")
        glob = torch.cat([A.data[:A.m, :A.n], B.data[:B.m, :B.n]], dim=1)
    else:
        if A.n != B.n:
            raise ValueError("VCat requires equal widths")
        glob = torch.cat([A.data[:A.m, :A.n], B.data[:B.m, :B.n]], dim=0)
    return DistMatrix.from_global(glob, A.col_dist, A.row_dist, g)


def Reshape(m: int, n: int, A: DistMatrix) -> DistMatrix:
    """Column-major reshape to m x n (reference: level1/Reshape.hpp — El
    matrices are column-major, so reshape runs down columns first)."""
    if m * n != A.m * A.n:
        raise ValueError("Reshape size mismatch")
    flat = A.data[:A.m, :A.n].mT.reshape(-1)  # column-major order
    glob = flat.reshape(n, m).mT
    return DistMatrix.from_global(glob, A.col_dist, A.row_dist, A.grid)


def ConjugateDiagonal(A: DistMatrix, offset: int = 0) -> DistMatrix:
    """Conjugate the offset diagonal (reference:
    level1/ConjugateDiagonal.hpp)."""
    i, j = _iota(A)
    return _like(A, torch.where((j - i) == offset,
                                torch.conj_physical(A.data), A.data))


def MakeDiagonalReal(A: DistMatrix, offset: int = 0) -> DistMatrix:
    """Zero the imaginary part of the offset diagonal (reference:
    level1/MakeDiagonalReal.hpp)."""
    if not A.data.is_complex():
        return A
    i, j = _iota(A)
    return _like(A, torch.where((j - i) == offset,
                                A.data.real.to(A.dtype), A.data))


def _in_block(A: DistMatrix, I: slice, J: slice) -> torch.Tensor:
    i, j = _iota(A)
    inI = (i >= (I.start or 0)) & (i < I.stop)
    inJ = (j >= (J.start or 0)) & (j < J.stop)
    return inI & inJ


def ConjugateSubmatrix(A: DistMatrix, I: slice, J: slice) -> DistMatrix:
    """Conjugate A[I, J] (reference: level1/ConjugateSubmatrix.hpp)."""
    return _like(A, torch.where(_in_block(A, I, J),
                                torch.conj_physical(A.data), A.data))


def MakeSubmatrixReal(A: DistMatrix, I: slice, J: slice) -> DistMatrix:
    """Drop the imaginary part of A[I, J] (reference:
    level1/MakeSubmatrixReal.hpp)."""
    if not A.data.is_complex():
        return A
    return _like(A, torch.where(_in_block(A, I, J),
                                A.data.real.to(A.dtype), A.data))


def DiagonalScaleTrapezoid(side, orientation, uplo: UpperOrLower,
                           d: DistMatrix, A: DistMatrix,
                           offset: int = 0) -> DistMatrix:
    """Scale the uplo trapezoid of A by diag(d) from ``side``, leaving the
    rest of A untouched (reference: level1/DiagonalScaleTrapezoid.hpp)."""
    scaled = DiagonalScale(side, orientation, d, A)
    i, j = _iota(A)
    keep = (j - i) >= offset if uplo == UPPER else (j - i) <= offset
    return _like(A, torch.where(keep, scaled.data, A.data))


def GetMappedDiagonal(A: DistMatrix, f, offset: int = 0) -> DistMatrix:
    """d_k = f(A_{k,k+offset}) (reference: level1/GetMappedDiagonal.hpp)."""
    d = GetDiagonal(A, offset)
    return _like(d, f(d.data))


def UpdateMappedDiagonal(A: DistMatrix, d: DistMatrix, f,
                         offset: int = 0) -> DistMatrix:
    """A_{k,k+offset} = f(A_{k,k+offset}, d_k) (reference:
    level1/UpdateMappedDiagonal.hpp); ``d`` is a (padded) column vector
    aligned with the diagonal."""
    i, j = _iota(A)
    on = (j - i) == offset
    dv = d.data[:, 0].to(A.device)
    row0 = max(-offset, 0)
    k = (i - row0).clamp(0, dv.shape[0] - 1)
    upd = f(A.data, dv[k])
    return _like(A, torch.where(on, upd, A.data))


def Kronecker(A: DistMatrix, B: DistMatrix) -> DistMatrix:
    """A (x) B (reference: level1/Kronecker.hpp)."""
    g = check_same_grid(A, B)
    out = torch.kron(A.data[:A.m, :A.n], B.data[:B.m, :B.n])
    return DistMatrix.from_global(out, A.col_dist, A.row_dist, g)


def Givens(phi, gamma):
    """(c, s, rho) with [c, s; -conj(s), c] [phi; gamma] = [rho; 0]
    (reference: level1/Givens.hpp, the lartg kernel)."""
    phi = _as_tensor(phi)
    gamma = _as_tensor(gamma)
    dt = torch.promote_types(phi.dtype, gamma.dtype)
    phi, gamma = phi.to(dt), gamma.to(dt)
    phi_a = torch.abs(phi)
    gam_a = torch.abs(gamma)
    norm = torch.sqrt(phi_a ** 2 + gam_a ** 2)
    safe = torch.where(norm == 0, torch.ones_like(norm), norm)
    sign = torch.where(phi_a == 0, torch.ones_like(phi),
                       phi / torch.where(phi_a == 0, torch.ones_like(phi_a),
                                         phi_a))
    c = torch.where(norm == 0, torch.ones_like(norm), phi_a / safe)
    s = torch.where(norm == 0, torch.zeros_like(phi),
                    sign * gamma.conj() / safe)
    rho = sign * norm
    return c, s, rho


def Rotate(c, s, a: DistMatrix, b: DistMatrix
           ) -> Tuple[DistMatrix, DistMatrix]:
    """Apply the Givens rotation [c, s; -conj(s), c] to the row pair
    (a, b) (reference: level1/Rotate.hpp)."""
    check_same_grid(a, b)
    c = _as_tensor(c, a.device)
    c = c.real if c.is_complex() else c
    s = _as_tensor(s, a.device)
    anew = c * a.data + s * b.data
    bnew = -s.conj() * a.data + c * b.data
    return _like(a, anew), _like(b, bnew)


def _quasi_blocks(d: torch.Tensor, dSub: torch.Tensor):
    """Masks for the 1x1/2x2 quasi-diagonal D = diag(d) +/- dSub pairs:
    start[k] marks the first row of a 2x2 block (a start cannot follow
    another start; a host scan over the n couplings)."""
    n = d.shape[0]
    sub = torch.zeros((n,), dtype=dSub.dtype, device=d.device)
    sub[:dSub.shape[0]] = dSub
    nz = (sub != 0).cpu().tolist()
    start_l, prev = [], False
    for z in nz:
        prev = bool(z) and not prev
        start_l.append(prev)
    start = torch.tensor(start_l, dtype=torch.bool, device=d.device)
    end = torch.cat([torch.zeros((1,), dtype=torch.bool, device=d.device),
                     start[:-1]])
    return sub, start, end


def _quasi_vectors(d: torch.Tensor, dSub: torch.Tensor, P: int,
                   conjugated: bool, lower: bool):
    """(dv, start, end, D[k, k+1], D[k+1, k]) over the P padded rows."""
    sub, start, end = _quasi_blocks(d, dSub)
    n = d.shape[0]
    dev = d.device
    dt = torch.promote_types(d.dtype, sub.dtype)
    dv = torch.ones((P,), dtype=dt, device=dev)
    dv[:n] = d[:n]
    subv = torch.zeros((P,), dtype=dt, device=dev)
    subv[:n] = torch.where(start, sub, torch.zeros_like(sub))[:n]
    startv = torch.zeros((P,), dtype=torch.bool, device=dev)
    startv[:n] = start[:n]
    endv = torch.zeros((P,), dtype=torch.bool, device=dev)
    endv[:n] = end[:n]
    subc = subv.conj() if conjugated else subv
    b_up = subc if lower else subv      # D[k, k+1]
    b_dn = subv if lower else subc      # D[k+1, k]
    return dv, startv, endv, b_up, b_dn


def _shift_rows(x: torch.Tensor):
    """(x moved up one row, x moved down one row), zero-filled."""
    z = torch.zeros_like(x[:1])
    return torch.cat([x[1:], z], dim=0), torch.cat([z, x[:-1]], dim=0)


def QuasiDiagonalScale(side, uplo: UpperOrLower, d, dSub, X: DistMatrix,
                       conjugated: bool = False) -> DistMatrix:
    """X := D X (LEFT) / X D (RIGHT) for the symmetric/Hermitian
    quasi-diagonal D built from d (diagonal) and dSub (couplings whose
    nonzeros mark 2x2 blocks), the Bunch-Kaufman D factor (reference:
    level1/QuasiDiagonalScale.hpp). For uplo=LOWER dSub is the subdiagonal
    (mirror conjugated when ``conjugated``); UPPER is the transposed
    convention."""
    d = _as_tensor(d, X.device)
    dSub = _as_tensor(dSub, X.device)
    if side != LEFT:
        # X D = (D^T X^T)^T; for Hermitian D, D^T = conj(D), the
        # quasi-diagonal built from conj(dSub)
        dSub_t = dSub.conj() if conjugated else dSub
        return Transpose(QuasiDiagonalScale(
            LEFT, uplo, d, dSub_t, _transposed_view(X), conjugated))
    x = X.data
    dv, startv, _, b_up, b_dn = _quasi_vectors(d, dSub, x.shape[0],
                                               conjugated, uplo == LOWER)
    coef_up = torch.where(startv, b_up, torch.zeros_like(b_up))
    dn_at_start = torch.where(startv, b_dn, torch.zeros_like(b_dn))
    coef_dn = torch.cat([torch.zeros_like(dn_at_start[:1]),
                         dn_at_start[:-1]])
    up, dn = _shift_rows(x)
    y = dv[:, None] * x + coef_up[:, None] * up + coef_dn[:, None] * dn
    return _like(X, y)


def QuasiDiagonalSolve(side, uplo: UpperOrLower, d, dSub, X: DistMatrix,
                       conjugated: bool = False) -> DistMatrix:
    """X := D^{-1} X for the quasi-diagonal D (reference:
    level1/QuasiDiagonalSolve.hpp): 1x1 blocks divide; 2x2 blocks invert
    in closed form."""
    d = _as_tensor(d, X.device)
    dSub = _as_tensor(dSub, X.device)
    if side != LEFT:
        dSub_t = dSub.conj() if conjugated else dSub
        return Transpose(QuasiDiagonalSolve(
            LEFT, uplo, d, dSub_t, _transposed_view(X), conjugated))
    x = X.data
    P = x.shape[0]
    dv, startv, endv, b_up, b_dn = _quasi_vectors(d, dSub, P, conjugated,
                                                  uplo == LOWER)
    one = torch.ones((1,), dtype=dv.dtype, device=dv.device)
    c_next = torch.cat([dv[1:], one])
    det = torch.where(startv, dv * c_next - b_up * b_dn, torch.ones_like(dv))
    up, dn = _shift_rows(x)

    def shift1(v, fill_):
        return torch.cat([torch.full((1,), fill_, dtype=v.dtype,
                                     device=v.device), v[:-1]])

    y_start = (c_next[:, None] * x - b_up[:, None] * up) / det[:, None]
    y_end = (shift1(dv, 1)[:, None] * x - shift1(b_dn, 0)[:, None] * dn) \
        / shift1(det, 1)[:, None]
    y_single = x / dv[:, None]
    y = torch.where(startv[:, None], y_start,
                    torch.where(endv[:, None], y_end, y_single))
    return _like(X, y)


# -- swaps / 2x2 transforms / min-abs reductions (level1 census tail) -------


def RowSwap(A: DistMatrix, to: int, frm: int) -> DistMatrix:
    """Swap rows ``to`` and ``frm`` (reference: Swap.cpp RowSwap)."""
    Am = A.redistribute(MC, MR)
    d = Am.data.clone()
    d[[to, frm], :] = Am.data[[frm, to], :]
    return Am.with_data(d)


def ColSwap(A: DistMatrix, to: int, frm: int) -> DistMatrix:
    """Swap columns ``to`` and ``frm`` (reference: Swap.cpp ColSwap)."""
    Am = A.redistribute(MC, MR)
    d = Am.data.clone()
    d[:, [to, frm]] = Am.data[:, [frm, to]]
    return Am.with_data(d)


def SymmetricSwap(uplo: UpperOrLower, A: DistMatrix, to: int, frm: int,
                  conjugate: bool = False) -> DistMatrix:
    """Symmetric swap of the index pair (to, frm) on a triangle-stored
    matrix (reference: Swap.cpp SymmetricSwap): symmetrize, swap the row
    and the column, re-trapezoidalize."""
    full = MakeHermitian(uplo, A) if conjugate else MakeSymmetric(uplo, A)
    out = ColSwap(RowSwap(full, to, frm), to, frm)
    return MakeTrapezoidal(uplo, out)


def HermitianSwap(uplo: UpperOrLower, A: DistMatrix, to: int, frm: int
                  ) -> DistMatrix:
    """Reference: Swap.cpp HermitianSwap."""
    return SymmetricSwap(uplo, A, to, frm, conjugate=True)


def Transform2x2(G, a1: DistMatrix, a2: DistMatrix
                 ) -> Tuple[DistMatrix, DistMatrix]:
    """[a1; a2] := G [a1; a2] (reference: Transform2x2.cpp:14-60). Returns
    the transformed pair."""
    x1 = a1.redistribute(MC, MR)
    x2 = a2.redistribute(MC, MR)
    G = _as_tensor(G, x1.device)
    dt = torch.promote_types(G.dtype, x1.dtype)  # complex G promotes real a
    n1 = G[0, 0] * x1.data + G[0, 1] * x2.data
    n2 = G[1, 0] * x1.data + G[1, 1] * x2.data
    return x1.with_data(n1.to(dt), x1.m, x1.n), \
        x2.with_data(n2.to(dt), x2.m, x2.n)


def Transform2x2Rows(G, A: DistMatrix, i1: int, i2: int) -> DistMatrix:
    """[A(i1,:); A(i2,:)] := G [A(i1,:); A(i2,:)] (reference:
    Transform2x2.cpp Transform2x2Rows)."""
    Am = A.redistribute(MC, MR)
    G = _as_tensor(G, Am.device)
    d = Am.data.to(torch.promote_types(G.dtype, A.dtype)).clone()
    r1, r2 = d[i1, :].clone(), d[i2, :].clone()
    d[i1, :] = G[0, 0] * r1 + G[0, 1] * r2
    d[i2, :] = G[1, 0] * r1 + G[1, 1] * r2
    return Am.with_data(d)


def Transform2x2Cols(G, A: DistMatrix, j1: int, j2: int) -> DistMatrix:
    """[A(:,j1), A(:,j2)] := [A(:,j1), A(:,j2)] G^T (reference:
    Transform2x2.cpp Transform2x2Cols)."""
    Am = A.redistribute(MC, MR)
    G = _as_tensor(G, Am.device)
    d = Am.data.to(torch.promote_types(G.dtype, A.dtype)).clone()
    c1, c2 = d[:, j1].clone(), d[:, j2].clone()
    d[:, j1] = G[0, 0] * c1 + G[0, 1] * c2
    d[:, j2] = G[1, 0] * c1 + G[1, 1] * c2
    return Am.with_data(d)


def RowMaxNorms(A: DistMatrix) -> torch.Tensor:
    """max_j |a_ij| per row (reference: RowNorms.cpp RowMaxNorms). Padded
    (P,) output; rows >= m are zero."""
    return torch.amax(torch.abs(A.data), dim=1)


def ColumnMinAbs(A: DistMatrix) -> torch.Tensor:
    """min_i |a_ij| per column over the live m rows (reference:
    ColumnMinAbs.cpp). Padded output; columns >= n are zero."""
    absa = torch.abs(A.data)
    i, j = _iota(A)
    big = torch.full((), float("inf"), dtype=absa.dtype, device=A.device)
    mins = torch.amin(torch.where(i < A.m, absa, big), dim=0)
    return torch.where(j[0] < A.n, mins, torch.zeros_like(mins))


def RowMinAbs(A: DistMatrix) -> torch.Tensor:
    """Reference: RowMinAbs.cpp."""
    return ColumnMinAbs(_transposed_view(A))


def ColumnMinAbsNonzero(A: DistMatrix) -> torch.Tensor:
    """Per-column min |a_ij| over the nonzero live entries, 0 if the column
    is all zero (reference: ColumnMinAbs.cpp nonzero variant)."""
    absa = torch.abs(A.data)
    i, j = _iota(A)
    big = torch.full((), float("inf"), dtype=absa.dtype, device=A.device)
    mins = torch.amin(torch.where((i < A.m) & (absa > 0), absa, big), dim=0)
    mins = torch.where(torch.isinf(mins), torch.zeros_like(mins), mins)
    return torch.where(j[0] < A.n, mins, torch.zeros_like(mins))


def RowMinAbsNonzero(A: DistMatrix) -> torch.Tensor:
    return ColumnMinAbsNonzero(_transposed_view(A))


def ColumnTwoNorms(A: DistMatrix) -> torch.Tensor:
    """Alias of ColumnNorms (reference: ColumnNorms.cpp exports both)."""
    return ColumnNorms(A)


def RowTwoNorms(A: DistMatrix) -> torch.Tensor:
    return RowNorms(A)


def RealToComplex(A: DistMatrix) -> DistMatrix:
    """Widen a real matrix to the matching complex dtype (reference:
    Copy.hpp's mixed-type copies)."""
    Am = A.redistribute(MC, MR)
    cdt = torch.complex64 if Am.dtype == torch.float32 else torch.complex128
    return Am.with_data(Am.data.to(cdt))


def GetRealPartOfDiagonal(A: DistMatrix, offset: int = 0) -> DistMatrix:
    """Reference: GetDiagonal.hpp real-part accessor."""
    d = GetDiagonal(A, offset)
    return d.with_data(d.data.real)


def GetImagPartOfDiagonal(A: DistMatrix, offset: int = 0) -> DistMatrix:
    d = GetDiagonal(A, offset)
    return d.with_data(d.data.imag if d.data.is_complex()
                       else torch.zeros_like(d.data))


def _set_part_of_diagonal(A: DistMatrix, d: DistMatrix, offset: int,
                          imag: bool, update_alpha=None) -> DistMatrix:
    i, j = _iota(A)
    on_diag = (j - i == offset) & A.pad_mask()
    vals = _diag_values(A, d, offset)
    vals = vals.real if vals.is_complex() else vals
    cplx = A.data.is_complex()
    cur_re = A.data.real
    cur_im = A.data.imag if cplx else None
    if update_alpha is not None:
        base = cur_im if imag else cur_re
        alpha = _as_tensor(update_alpha, A.device)
        alpha = alpha.real if alpha.is_complex() else alpha
        vals = base + alpha * vals
    if imag:
        if cur_im is None:
            raise ValueError("imaginary diagonal part of a real matrix")
        new = torch.complex(cur_re, torch.where(on_diag, vals.to(cur_im.dtype),
                                                cur_im))
    else:
        new = torch.where(on_diag, vals.to(cur_re.dtype), cur_re)
        if cplx:
            new = torch.complex(new, cur_im)
    return _like(A, new.to(A.dtype))


def SetRealPartOfDiagonal(A: DistMatrix, d: DistMatrix,
                          offset: int = 0) -> DistMatrix:
    """Reference: SetDiagonal.hpp SetRealPartOfDiagonal."""
    return _set_part_of_diagonal(A, d, offset, imag=False)


def SetImagPartOfDiagonal(A: DistMatrix, d: DistMatrix,
                          offset: int = 0) -> DistMatrix:
    return _set_part_of_diagonal(A, d, offset, imag=True)


def UpdateRealPartOfDiagonal(A: DistMatrix, alpha, d: DistMatrix,
                             offset: int = 0) -> DistMatrix:
    return _set_part_of_diagonal(A, d, offset, imag=False,
                                 update_alpha=alpha)


def UpdateImagPartOfDiagonal(A: DistMatrix, alpha, d: DistMatrix,
                             offset: int = 0) -> DistMatrix:
    return _set_part_of_diagonal(A, d, offset, imag=True,
                                 update_alpha=alpha)


# ---------------------------------------------------------------------------
# value-and-location reductions (the MPI MaxLocOp/MinLocOp family)
# ---------------------------------------------------------------------------


def _loc_reduce(A: DistMatrix, vals: torch.Tensor, valid: torch.Tensor,
                maximize: bool) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(value, i, j) of the extremal entry of ``vals`` over ``valid``: a
    masked argmax/argmin and an integer decode (the MaxLocOp / MinLocOp
    AllReduce, src/core/mpi_register.cpp). Ties resolve to the first entry
    in row-major order."""
    if vals.is_complex():
        raise TypeError("Loc reductions are defined for real values "
                        "(use the Abs variants for complex matrices)")
    sentinel = torch.full((), float("-inf") if maximize else float("inf"),
                          dtype=vals.dtype, device=vals.device)
    flat = torch.where(valid, vals, sentinel).reshape(-1)
    k = torch.argmax(flat) if maximize else torch.argmin(flat)
    Q = vals.shape[1]
    return flat[k], k // Q, k % Q


def MaxLoc(A: DistMatrix):
    """(value, i, j) of the maximum entry (reference: MaxLoc.cpp MaxLoc)."""
    return _loc_reduce(A, A.data, A.pad_mask(), maximize=True)


def MinLoc(A: DistMatrix):
    """Reference: MaxLoc.cpp MinLoc (decl.hpp:1183)."""
    return _loc_reduce(A, A.data, A.pad_mask(), maximize=False)


def MinAbsLoc(A: DistMatrix):
    """(|value|, i, j) of the min-|.| entry (reference: MinAbsLoc.hpp)."""
    return _loc_reduce(A, torch.abs(A.data), A.pad_mask(), maximize=False)


def _sym_mask(A: DistMatrix, uplo: UpperOrLower) -> torch.Tensor:
    i, j = _iota(A)
    tri = (i >= j) if uplo == LOWER else (i <= j)
    return A.pad_mask() & tri


def SymmetricMaxLoc(uplo: UpperOrLower, A: DistMatrix):
    """MaxLoc restricted to the stored triangle (reference: MaxLoc.cpp
    SymmetricMaxLoc)."""
    return _loc_reduce(A, A.data, _sym_mask(A, uplo), maximize=True)


def SymmetricMinLoc(uplo: UpperOrLower, A: DistMatrix):
    return _loc_reduce(A, A.data, _sym_mask(A, uplo), maximize=False)


def SymmetricMaxAbsLoc(uplo: UpperOrLower, A: DistMatrix):
    """Reference: MaxAbsLoc.hpp SymmetricMaxAbsLoc."""
    return _loc_reduce(A, torch.abs(A.data), _sym_mask(A, uplo),
                       maximize=True)


def SymmetricMinAbsLoc(uplo: UpperOrLower, A: DistMatrix):
    return _loc_reduce(A, torch.abs(A.data), _sym_mask(A, uplo),
                       maximize=False)


def VectorMaxLoc(x: DistMatrix):
    """(value, index) over a column/row vector (reference: MaxLoc.cpp
    VectorMaxLoc)."""
    v, i, j = MaxLoc(x)
    return v, i if x.n == 1 else j


def VectorMinLoc(x: DistMatrix):
    v, i, j = MinLoc(x)
    return v, i if x.n == 1 else j


def VectorMinAbsLoc(x: DistMatrix):
    v, i, j = MinAbsLoc(x)
    return v, i if x.n == 1 else j


# ---------------------------------------------------------------------------
# census tail: HilbertSchmidt, Symmetric2x2Inv, AdjointAxpy
# ---------------------------------------------------------------------------


def HilbertSchmidt(A: DistMatrix, B: DistMatrix) -> torch.Tensor:
    """The Hilbert-Schmidt inner product <A, B> = sum conj(a_ij) b_ij
    (reference: src/blas_like/level1/HilbertSchmidt.cpp)."""
    if A.shape != B.shape:
        raise ValueError("Matrices must be the same size")
    return Dot(A, B)


def Symmetric2x2Inv(uplo: UpperOrLower, D, conjugate: bool = False
                    ) -> torch.Tensor:
    """Invert a symmetric (or Hermitian, ``conjugate``) 2x2 matrix given by
    its lower triangle, returning the packed lower triangle of the inverse
    (reference: src/blas_like/level1/Symmetric2x2Inv.cpp:14-53; like the
    reference, only uplo=LOWER is supported)."""
    if uplo != LOWER:
        raise NotImplementedError("This option not yet supported")
    D = _as_tensor(D.data if isinstance(D, DistMatrix) else D)
    d11, d21, d22 = D[0, 0], D[1, 0], D[1, 1]
    if conjugate:
        d11 = d11.real if d11.is_complex() else d11
        d22 = d22.real if d22.is_complex() else d22
        d21abs = torch.abs(d21)
        phi21to11 = d22 / d21abs
        phi21to22 = d11 / d21abs
        phi21 = d21 / d21abs
        xi = (1.0 / (phi21to11 * phi21to22 - 1.0)) / d21abs
        n11 = (xi * phi21to11).to(D.dtype)
        n21 = (-xi * phi21).to(D.dtype)
        n22 = (xi * phi21to22).to(D.dtype)
    else:
        chi21to11 = -d22 / d21
        chi21to22 = -d11 / d21
        chi21 = (1.0 / (1.0 - chi21to11 * chi21to22)) / d21
        n11, n21, n22 = chi21 * chi21to11, chi21, chi21 * chi21to22
    out = torch.zeros((2, 2), dtype=D.dtype, device=D.device)
    out[0, 0], out[1, 0], out[1, 1] = n11, n21, n22
    return out


def AdjointAxpy(alpha: Scalar, X: DistMatrix, Y: DistMatrix) -> DistMatrix:
    """Y += alpha X^H (reference: TransposeAxpy.hpp AdjointAxpy)."""
    return TransposeAxpy(alpha, X, Y, conjugate=True)


#: every level-1 operation of this module (``from .level1 import *``)
__all__ = [_name for _name, _obj in list(globals().items())
           if _name[:1].isupper() and callable(_obj)
           and getattr(_obj, "__module__", None) == __name__]
