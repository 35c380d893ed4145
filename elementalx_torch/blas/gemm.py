"""Distributed GEMM: C := alpha op(A) op(B) + beta C.

Counterpart of ``elementalx/blas/gemm.py`` (reference:
src/blas_like/level3/Gemm.cpp + Gemm/{NN,NT,TN,TT}.hpp). Every local
product is ``local_gemm``, which on a CUDA tensor launches the
hand-written K1 kernel (kernels/matmul.py).

On a 1 x 1 grid the JAX driver always takes ``GEMM_XLA``, one local
product of the padded operands, and so does the port; the explicit
algorithms raise there.

On a grid of several positions the explicit variants run over the
[MC,MR] blocks, as the JAX ``shard_map`` bodies do, with the collectives
of ``core/collectives.py``:
  - stationary-C (``_summa_c``): per k-panel, A's column panel broadcast
    over the grid row, B's row panel over the grid column, one local
    product per position (NN.hpp:325-368);
  - stationary-A: B -> [MR,*]; partials psum-scattered over the row;
  - stationary-B: A -> [*,MC]; partials psum-scattered over the column;
  - dot: A -> [*,VC], B -> [VC,*]; one full psum (k >> m, n);
  - Cannon: skew, then r steps of local product and unit shifts on a
    square grid (NN.hpp:21-103);
  - ``Gemm3D``: the positions as an (r', c', depth) mesh, K split over
    depth, one psum over it (experimental/g3d).
**A deliberate difference.** The port has no SPMD partitioner, so on such
a grid ``GEMM_DEFAULT`` always takes ``_choose_algorithm``'s aspect rule
(the JAX package's behaviour after ``use_explicit_summa(True)``) and
``GEMM_XLA`` raises ValueError.

Orientations are normalised to NN through transposed views, which K1
reads in place through their strides; beta C is accumulated through
level 1 (K9 on CUDA tensors, one launch per position).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from ..core import collectives
from ..core.dmatrix import DistMatrix, block_ranges, check_same_grid
from ..core.environment import Blocksize
from ..core.redistribute import Copy, assemble
from ..core.types import (
    ADJOINT,
    GEMM_CANNON,
    GEMM_DEFAULT,
    GEMM_SUMMA_A,
    GEMM_SUMMA_B,
    GEMM_SUMMA_C,
    GEMM_SUMMA_DOT,
    GEMM_XLA,
    GemmAlgorithm,
    MC,
    MR,
    NORMAL,
    Orientation,
    STAR,
    TRANSPOSE,
    VC,
)
from ..kernels.matmul import matmul
from .level1 import Axpby, Scale, _transposed_view


def local_gemm(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Local-block matmul (the blas::Gemm/cublas::Gemm analogue,
    Gemm.cpp:83-160): K1 on CUDA tensors, its plain version on the CPU.
    bf16 inputs accumulate in f32. The result has ``a.dtype`` unless
    ``out_dtype`` asks for the f32 result of a bf16 product (the
    ``preferred_element_type`` of the JAX drivers)."""
    return matmul(a, b, out_dtype=out_dtype)


def _orient(X: DistMatrix, orientation: Orientation) -> DistMatrix:
    """op(X) as a view: X's data as ``.mT`` (or ``.mH``) with the dist tags
    swapped. K1 and K2 read it in place through its strides; level 1's
    Transpose and Adjoint would write a copy."""
    if orientation == NORMAL:
        return X
    if orientation not in (TRANSPOSE, ADJOINT):
        raise ValueError(orientation)
    return _transposed_view(X, orientation == ADJOINT)


def _accumulate(C: Optional[DistMatrix], prod_dm: DistMatrix, alpha,
                beta) -> DistMatrix:
    """alpha prod + beta C through level 1, as Gemm.cpp scales C by beta
    and accumulates: Axpby for beta != 0 and Scale for beta = 0 with
    alpha != 1 (K9 on CUDA tensors), in the product's type, then cast to
    C's type."""
    if C is None or (isinstance(beta, (int, float)) and beta == 0):
        out = prod_dm
        if not (isinstance(alpha, (int, float)) and alpha == 1):
            out = Scale(alpha, prod_dm)
        if C is not None:
            if out.sharded:
                return Copy(_cast(out, C.dtype), *C.dist)
            out = DistMatrix.from_padded(out.data.to(C.dtype), C.m, C.n,
                                         C.col_dist, C.row_dist, C.grid,
                                         C.wrap)
        return out
    Cd = C.redistribute(MC, MR)
    acc = Axpby(alpha, prod_dm, beta, _cast(Cd, prod_dm.dtype))
    return _cast(acc, C.dtype)


def _cast(X: DistMatrix, dtype: torch.dtype) -> DistMatrix:
    if X.sharded:
        return X.with_blocks(b.to(dtype) for b in X.blocks)
    return X.with_data(X.data.to(dtype))


def _products(As, Bs) -> List[torch.Tensor]:
    """One local product (K1) per position."""
    return [local_gemm(a, b) for a, b in zip(As, Bs)]


def _add_into(acc: Optional[List[torch.Tensor]],
              terms: List[torch.Tensor]) -> List[torch.Tensor]:
    """acc + terms per position (the first terms start the sums)."""
    if acc is None:
        return terms
    return [x.add_(t) for x, t in zip(acc, terms)]


# ---------------------------------------------------------------------------
# Explicit algorithms on a grid of several positions (the shard_map bodies)
# ---------------------------------------------------------------------------


def _summa_c(A: DistMatrix, B: DistMatrix,
             blocksize: int) -> List[torch.Tensor]:
    """Stationary-C SUMMA (reference: gemm::SUMMA_NNC, NN.hpp:325-368).

    Loops over k-panels; each step broadcasts an A column panel over the
    grid row (-> [MC,*]) and a B row panel over the grid column
    (-> [*,MR]) from their owners and accumulates a local product."""
    g = A.grid
    r, c = g.height, g.width
    K = A.padded_shape[1]
    # a panel must live within a single owner row/column block, so nb must
    # divide both K//c and K//r (pick a divisor near the request). K is a
    # multiple of p = r c, so their gcd is (K // p) gcd(r, c); the JAX
    # package takes their min, which on a 2x3 grid lets a panel cross B's
    # owner block (its dynamic_slice clamps silently).
    kmax = math.gcd(K // c, K // r)
    nb = min(blocksize, kmax)
    while kmax % nb != 0:
        nb -= 1
    acc = None
    for k0 in range(0, K, nb):
        a_owner, a_k = divmod(k0, K // c)
        b_owner, b_k = divmod(k0, K // r)
        a_pan = collectives.broadcast(
            [x[:, a_k:a_k + nb] for x in A.blocks], g, "mr", a_owner)
        b_pan = collectives.broadcast(
            [x[b_k:b_k + nb, :] for x in B.blocks], g, "mc", b_owner)
        acc = _add_into(acc, _products(a_pan, b_pan))
    return acc


def _summa_a(A: DistMatrix, B: DistMatrix) -> List[torch.Tensor]:
    """Stationary-A SUMMA (reference: gemm::SUMMA_NNA): B -> [MR,*], local
    partials (M/r, N) psum-scattered over the grid row."""
    B_mr = Copy(B, MR, STAR)
    parts = _products(A.blocks, B_mr.blocks)
    return collectives.psum_scatter(parts, A.grid, "mr", 1)


def _summa_b(A: DistMatrix, B: DistMatrix) -> List[torch.Tensor]:
    """Stationary-B SUMMA (reference: gemm::SUMMA_NNB): A -> [*,MC], local
    partials (M, N/c) psum-scattered over the grid column."""
    A_sc = Copy(A, STAR, MC)
    parts = _products(A_sc.blocks, B.blocks)
    return collectives.psum_scatter(parts, A.grid, "mc", 0)


def _summa_dot(A: DistMatrix, B: DistMatrix) -> List[torch.Tensor]:
    """Dot SUMMA for k >> m, n (reference: gemm::SUMMA_NNDot): operands
    vectorized over all p positions along k; one full psum to [*,*], then
    each position keeps its [MC,MR] block."""
    A_vc, B_vc = Copy(A, STAR, VC), Copy(B, VC, STAR)
    full = collectives.psum(_products(A_vc.blocks, B_vc.blocks), A.grid,
                            "vc")
    m, n = A.m, B.n
    star = DistMatrix(None, m, n, STAR, STAR, A.grid, A.wrap, tuple(full))
    return list(Copy(star, MC, MR).blocks)


def _cannon(A: DistMatrix, B: DistMatrix) -> List[torch.Tensor]:
    """Cannon's algorithm on a square grid (reference: gemm::Cannon_NN,
    NN.hpp:21-103): skew A left by the row index and B up by the column
    index, then r steps of local product and unit ring shifts."""
    g = A.grid
    r, c = g.height, g.width
    if r != c:
        raise ValueError("Cannon requires a square grid (NN.hpp:23)")

    def left_by_row(q):
        i, j = g.coords(q)
        return i * c + (j + i) % r

    def up_by_col(q):
        i, j = g.coords(q)
        return ((i + j) % r) * c + j

    a = collectives.permute(A.blocks, g, left_by_row)
    b = collectives.permute(B.blocks, g, up_by_col)
    acc = None
    for step in range(r):
        acc = _add_into(acc, _products(a, b))
        if step + 1 < r:
            a = collectives.ppermute(a, g, "mr", 1)
            b = collectives.ppermute(b, g, "mc", 1)
    return acc


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def use_explicit_summa(on: bool = True) -> None:
    """The JAX package's switch between GSPMD and the aspect-ratio SUMMA
    heuristic (reference: Gemm/NN.hpp:910-931). The port has no GSPMD
    path: on a grid of several positions GEMM_DEFAULT always takes the
    heuristic, which is what ``on=True`` asks for, so that call changes
    nothing; ``on=False`` asks for the partitioner and raises ValueError,
    as GEMM_XLA does."""
    if not on:
        raise ValueError("use_explicit_summa(False) hands GEMM_DEFAULT to "
                         "XLA's SPMD partitioner, which the port does not "
                         "have; GEMM_DEFAULT always takes the aspect rule")


def _choose_algorithm(m: int, n: int, k: int, p: int) -> GemmAlgorithm:
    """Aspect-ratio heuristic (reference: NN.hpp:910-931, weight towards
    C = 2, as the JAX package has it; the reference's is 10, ROADMAP
    queue 3): k >> m,n -> Dot; m << n -> stationary-B; n << m ->
    stationary-A; else stationary-C. A 1 x 1 grid takes the one local
    product (GEMM_XLA)."""
    if p == 1:
        return GEMM_XLA
    w = 2
    if w * m <= k and w * n <= k:
        return GEMM_SUMMA_DOT
    if m <= n and w * m <= n:
        return GEMM_SUMMA_B
    if n <= m and w * n <= m:
        return GEMM_SUMMA_A
    return GEMM_SUMMA_C


def Gemm(orientA: Orientation, orientB: Orientation, alpha, A: DistMatrix,
         B: DistMatrix, beta=0.0, C: Optional[DistMatrix] = None,
         alg: GemmAlgorithm = GEMM_DEFAULT,
         blocksize: Optional[int] = None) -> DistMatrix:
    """C := alpha op(A) op(B) + beta C (reference: Gemm.cpp:279).

    Returns a new [MC,MR] DistMatrix. If C is None, beta must be 0. On a
    1 x 1 grid the explicit SUMMA and Cannon algorithms raise
    NotImplementedError; on a larger grid GEMM_XLA raises ValueError."""
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
    if not An.sharded:
        if alg not in (GEMM_DEFAULT, GEMM_XLA):
            raise NotImplementedError(
                f"Gemm: {GemmAlgorithm(alg).name} runs on a grid of several "
                "positions (a virtual grid on one card will do); a 1 x 1 "
                "grid takes the one local product (ROADMAP queue 1 item 11)")
        prod = local_gemm(An.data, Bn.data)
        prod_dm = DistMatrix.from_padded(prod, m, n, MC, MR, A.grid, A.wrap)
        return _accumulate(C, prod_dm, alpha, beta)
    if alg == GEMM_XLA:
        raise ValueError("Gemm: GEMM_XLA hands the product to XLA's SPMD "
                         "partitioner, which the port does not have; take "
                         "GEMM_DEFAULT or an explicit algorithm")
    if alg == GEMM_DEFAULT:
        alg = _choose_algorithm(m, n, k, A.grid.size)
    if alg == GEMM_SUMMA_C:
        blocks = _summa_c(An, Bn, blocksize or Blocksize())
    elif alg == GEMM_SUMMA_A:
        blocks = _summa_a(An, Bn)
    elif alg == GEMM_SUMMA_B:
        blocks = _summa_b(An, Bn)
    elif alg == GEMM_SUMMA_DOT:
        blocks = _summa_dot(An, Bn)
    elif alg == GEMM_CANNON:
        blocks = _cannon(An, Bn)
    else:
        raise ValueError(alg)
    prod_dm = DistMatrix(None, m, n, MC, MR, A.grid, A.wrap, tuple(blocks))
    return _accumulate(C, prod_dm, alpha, beta)


def _mesh3(p: int, depth: int):
    """(r', c') of Gemm3D's (r', c', depth) mesh over p positions: r' the
    largest divisor of p / depth at most its square root."""
    if p % depth != 0:
        raise ValueError(f"depth {depth} does not divide p={p}")
    p2 = p // depth
    r = 1
    for cand in range(int(p2 ** 0.5), 0, -1):
        if p2 % cand == 0:
            r = cand
            break
    return r, p2 // r


def Gemm3D(A: DistMatrix, B: DistMatrix, depth: int = 2,
           alpha=1.0) -> DistMatrix:
    """3-D (depth-replicated) GEMM (reference: experimental/g3d/
    G3DGemm.cpp — mesh x depth comm split :16-30, DepthBroadcast :105,
    per-layer product, SumContributions reduce :304).

    The grid's positions, flattened mc-major, are reshaped into an
    (r', c', depth) mesh; A goes to rows over r' and columns over depth,
    B to rows over depth and columns over c'; each position multiplies
    its K-slab (K1) and one psum over the depth axis reduces the
    contributions; the result goes back to [MC,MR]."""
    check_same_grid(A, B)
    g = A.grid
    r3, c3 = _mesh3(g.size, depth)
    if g.size == 1:
        return Gemm(NORMAL, NORMAL, alpha, A, B)
    An = A.redistribute(MC, MR).canonical()
    Bn = B.redistribute(MC, MR).canonical()
    if An.n != Bn.m:
        raise ValueError("Gemm3D: inner dimension mismatch")
    M, K = An.padded_shape
    N = Bn.padded_shape[1]

    def coords(q):
        return q // (c3 * depth), (q // depth) % c3, q % depth

    def cut(P, Q, nr, nc, row_of, col_of):
        return [((row_of(q) * P // nr, (row_of(q) + 1) * P // nr),
                 (col_of(q) * Q // nc, (col_of(q) + 1) * Q // nc))
                for q in range(g.size)]

    a_rng = cut(M, K, r3, depth, lambda q: coords(q)[0],
                lambda q: coords(q)[2])
    b_rng = cut(K, N, depth, c3, lambda q: coords(q)[2],
                lambda q: coords(q)[1])
    c_rng = cut(M, N, r3, c3, lambda q: coords(q)[0],
                lambda q: coords(q)[1])

    def local(s, t):
        return s == t

    a3 = assemble(An.blocks, An.block_ranges(), a_rng, g.devices, local,
                  "Gemm3D A")
    b3 = assemble(Bn.blocks, Bn.block_ranges(), b_rng, g.devices, local,
                  "Gemm3D B")

    def md(q):
        i, j, _ = coords(q)
        return [(i * c3 + j) * depth + d for d in range(depth)]

    parts = collectives.psum(_products(a3, b3), g, md)
    blocks = assemble(parts, c_rng, block_ranges(g, MC, MR, M, N),
                      g.devices, local, "Gemm3D C")
    out = DistMatrix(None, An.m, Bn.n, MC, MR, g, A.wrap, tuple(blocks))
    if isinstance(alpha, (int, float)) and alpha == 1:
        return out
    return Scale(alpha, out)
