"""The ported main paths as steps: the HPD solve, the LU solve, the
Hermitian and the generalized definite eigensolvers, least squares.

Counterpart of ``__graft_entry__.entry()``: an HPD solve (Cholesky and two
triangular solves), the residual Gemm R = B - A X, and its norm, on a
one-device grid. ``entry`` returns the step and an example problem, as
the JAX version returns its jittable step and example arguments.
``linear_solve_step`` is the counterpart of its LU + SolveAfter pair
(``__graft_entry__.py:116-117``) and of ``bench.py``'s LU row: LinearSolve,
the residual Gemm and its norm, on a general matrix from
``make_lu_problem``. ``hermitian_eig_step`` is the counterpart of
``bench.py``'s HermitianEig row (BASELINE config 4): HermitianEig, the
residual product H Q through Gemm, and the scaled residual, on a matrix
from ``make_eig_problem``. ``gen_def_eig_step`` is HermitianGenDefEig on
a pencil from ``make_gendef_problem``, with its residual products through
Gemm. ``least_squares_step`` is LeastSquares (QR for m >= n, the
minimum-norm LQ solution for m < n; BASELINE config 3's QR run as a
solve), the residual B - A X through Gemm (its beta C through level 1,
K9) and its norm, on a problem from ``make_ls_problem``.
``dist_gemm_step`` is the GEMM part of the JAX multi-device dry run
(``__graft_entry__.py:100-115``, ``:205-212``) on a grid of several
positions: the residual chain through SUMMA A, B and C and the ring SUMMA
(K8), on a problem from ``make_dist_problem``.

Every entry point runs on the card unless the caller asks for the CPU
(a CPU tensor, ``device="cpu"`` or a CPU grid): without one the default
grid raises.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch

from .blas import Gemm, Nrm2
from .core.dmatrix import DistMatrix
from .core.grid import Grid
from .core.types import (
    GEMM_DEFAULT,
    GEMM_SUMMA_A,
    GEMM_SUMMA_B,
    GEMM_SUMMA_C,
    LOWER,
    NORMAL,
)
from .kernels.ring_summa import ring_summa
from .lapack import (
    HermitianEig,
    HermitianGenDefEig,
    HPDSolve,
    LeastSquares,
    LinearSolve,
)
from .lapack.hermitian_eig import HermitianEigCtrl


def make_hpd_problem(n: int, nrhs: int, dtype: torch.dtype = torch.float32,
                     device: Union[torch.device, str, None] = None,
                     seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) with a = g g^T / n + 2 I for a standard normal g, as bench.py
    builds its Cholesky input, and b standard normal, drawn on ``device``
    from a generator seeded with ``seed``. Built in float32 with plain
    torch products (set-up, not the path under test), then cast."""
    dev = torch.device(device) if device is not None else Grid.default().device
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((n, n), generator=gen, device=dev) / math.sqrt(n)
    a = g @ g.mT
    a.diagonal().add_(2.0)
    b = torch.randn((n, nrhs), generator=gen, device=dev)
    return a.to(dtype), b.to(dtype)


def hpd_solve_step(a: torch.Tensor, b: torch.Tensor,
                   grid: Optional[Grid] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X = A \\ B through HPDSolve, then ||B - A X|| through Gemm and Nrm2.
    Returns (X's padded data, the residual norm)."""
    grid = grid or Grid(a.device)
    A = DistMatrix.from_global(a, grid=grid)
    B = DistMatrix.from_global(b, grid=grid)
    X = HPDSolve(LOWER, NORMAL, A, B)
    R = Gemm(NORMAL, NORMAL, -1.0, A, X, beta=1.0, C=B)
    return X.data, Nrm2(R)


def make_lu_problem(n: int, nrhs: int, dtype: torch.dtype = torch.float32,
                    device: Union[torch.device, str, None] = None,
                    seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b), both standard normal, drawn on ``device`` from a generator
    seeded with ``seed``. A general matrix, so that partial pivoting
    really happens (bench.py times LU on the SPD Cholesky input, where
    almost every pivot is the diagonal)."""
    dev = torch.device(device) if device is not None else Grid.default().device
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((n, n), generator=gen, device=dev)
    b = torch.randn((n, nrhs), generator=gen, device=dev)
    return a.to(dtype), b.to(dtype)


def linear_solve_step(a: torch.Tensor, b: torch.Tensor,
                      grid: Optional[Grid] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X = A \\ B through LinearSolve (LU with partial pivoting and two
    triangular solves), then ||B - A X|| through Gemm and Nrm2. Returns
    (X's padded data, the residual norm)."""
    grid = grid or Grid(a.device)
    A = DistMatrix.from_global(a, grid=grid)
    B = DistMatrix.from_global(b, grid=grid)
    X = LinearSolve(A, B)
    R = Gemm(NORMAL, NORMAL, -1.0, A, X, beta=1.0, C=B)
    return X.data, Nrm2(R)


def make_eig_problem(n: int, dtype: torch.dtype = torch.float32,
                     device: Union[torch.device, str, None] = None,
                     seed: int = 0) -> torch.Tensor:
    """h = (g + g^T) / sqrt(8 n) for a standard normal g drawn on
    ``device`` from a generator seeded with ``seed``, as bench.py builds
    its HermitianEig input (its spectrum fills about [-1, 1])."""
    dev = torch.device(device) if device is not None else Grid.default().device
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((n, n), generator=gen, device=dev)
    return ((g + g.mT) / math.sqrt(8 * n)).to(dtype)


def hermitian_eig_step(h: torch.Tensor,
                       ctrl: Optional[HermitianEigCtrl] = None,
                       grid: Optional[Grid] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """w, Q = HermitianEig(h), then H Q through Gemm. Returns (w, Q's
    n x n data, the scaled residual max|HQ - QW| / (eps n max|w|)) with
    eps of h's dtype, as bench.py scores its HermitianEig row; the
    residual is a 0-d tensor on h's device."""
    grid = grid or Grid(h.device)
    n = h.shape[0]
    H = DistMatrix.from_global(h, grid=grid)
    w, Q = HermitianEig(LOWER, H, vectors=True, ctrl=ctrl)
    R = Gemm(NORMAL, NORMAL, 1.0, H, Q)
    q = Q.data[:n, :n]
    D = R.data[:n, :n] - q * w[None, :]
    eps = torch.finfo(h.dtype).eps
    return w, q, torch.max(torch.abs(D)) / (eps * n * torch.max(torch.abs(w)))


def make_gendef_problem(n: int, dtype: torch.dtype = torch.float32,
                        device: Union[torch.device, str, None] = None,
                        seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) for a definite pencil: a as ``make_eig_problem`` builds it
    from ``seed``, b as ``make_hpd_problem`` builds its matrix from
    ``seed + 1`` (g g^T / n + 2 I, condition number below about 6)."""
    a = make_eig_problem(n, dtype, device, seed)
    b, _ = make_hpd_problem(n, 0, dtype, device, seed + 1)
    return a, b


def gen_def_eig_step(a: torch.Tensor, b: torch.Tensor,
                     pencil: str = "AXBX",
                     ctrl: Optional[HermitianEigCtrl] = None,
                     grid: Optional[Grid] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """w, X = HermitianGenDefEig(a, b, pencil), then the pencil's residual
    through Gemm. Returns (w, X's n x n data, the scaled residual) with
    eps of a's dtype, as a 0-d tensor on a's device:
      AXBX: max|AX - BXW| / (eps n (max|A| + max|w| max|B|) max|X|)
      ABX:  max|ABX - XW| / (eps n (max|A| max|B| + max|w|) max|X|)
      BAX:  max|BAX - XW| / (eps n (max|A| max|B| + max|w|) max|X|)"""
    grid = grid or Grid(a.device)
    n = a.shape[0]
    A = DistMatrix.from_global(a, grid=grid)
    B = DistMatrix.from_global(b, grid=grid)
    w, X = HermitianGenDefEig(LOWER, A, B, vectors=True, ctrl=ctrl,
                              pencil=pencil)
    x = X.data[:n, :n]
    xw = x * w[None, :]
    amax, bmax = torch.max(torch.abs(a)), torch.max(torch.abs(b))
    wmax = torch.max(torch.abs(w))
    if pencil == "AXBX":
        AX = Gemm(NORMAL, NORMAL, 1.0, A, X).data[:n, :n]
        BXW = Gemm(NORMAL, NORMAL, 1.0, B, X.with_data(xw)).data[:n, :n]
        D, scale = AX - BXW, amax + wmax * bmax
    else:
        first, second = (B, A) if pencil == "ABX" else (A, B)
        Y = Gemm(NORMAL, NORMAL, 1.0, first, X)
        D = Gemm(NORMAL, NORMAL, 1.0, second, Y).data[:n, :n] - xw
        scale = amax * bmax + wmax
    eps = torch.finfo(a.dtype).eps
    xmax = torch.max(torch.abs(x))
    return w, x, torch.max(torch.abs(D)) / (eps * n * scale * xmax)


def make_ls_problem(m: int, n: int, nrhs: int,
                    dtype: torch.dtype = torch.float32,
                    device: Union[torch.device, str, None] = None,
                    seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) for least squares: a standard normal m x n matrix over
    sqrt(n) and a standard normal m x nrhs b, drawn on ``device`` from a
    generator seeded with ``seed``."""
    dev = torch.device(device) if device is not None else Grid.default().device
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((m, n), generator=gen, device=dev) / math.sqrt(n)
    b = torch.randn((m, nrhs), generator=gen, device=dev)
    return a.to(dtype), b.to(dtype)


def least_squares_step(a: torch.Tensor, b: torch.Tensor,
                       grid: Optional[Grid] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X = argmin ||A X - B|| through LeastSquares(NORMAL, A, B) (the
    minimum-norm X when A is wide), then ||B - A X|| through Gemm (beta = 1,
    so K9's axpby) and Nrm2. Returns (X's padded data, the residual
    norm)."""
    grid = grid or Grid(a.device)
    A = DistMatrix.from_global(a, grid=grid)
    B = DistMatrix.from_global(b, grid=grid)
    X = LeastSquares(NORMAL, A, B)
    R = Gemm(NORMAL, NORMAL, -1.0, A, X, beta=1.0, C=B)
    return X.data, Nrm2(R)


def make_dist_problem(n: int, grid: Grid, dtype: torch.dtype = torch.float32,
                      seed: int = 0, nrhs: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """(a, b, x, g) for ``dist_gemm_step`` on the device of the grid's
    position (0, 0), as the JAX dry run builds them: a and b from
    ``make_hpd_problem`` (nrhs = the grid's size unless given), x = a \\ b
    through the port's HPD solve on that device (the distributed Cholesky
    is not ported yet), g standard normal n x n from ``seed + 1``."""
    dev = grid.device
    a, b = make_hpd_problem(n, grid.size if nrhs is None else nrhs, dtype,
                            dev, seed)
    x, _ = hpd_solve_step(a, b, Grid(dev))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    g = torch.randn((n, n), generator=gen, device=dev).to(dtype)
    return a, b, x, g


def dist_gemm_step(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                   g: torch.Tensor, grid: Grid
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Tuple[torch.Tensor, ...]]:
    """The GEMM part of the JAX dry run on ``grid``: R = B - A X through
    GEMM_SUMMA_A, R2 = A R through GEMM_SUMMA_B, R3 = A R2 through
    GEMM_SUMMA_C, and Cr = A G through the ring SUMMA (K8). Returns
    (Nrm2(R3), Nrm2(Cr), R3's [MC,MR] blocks). On a 1 x 1 grid each
    product is the one local product (the explicit algorithms need
    several positions), so the same step there is the reference."""
    def alg(a_):
        return a_ if grid.size > 1 else GEMM_DEFAULT

    A, B, X, G = (DistMatrix.from_global(t, grid=grid) for t in (a, b, x, g))
    R = Gemm(NORMAL, NORMAL, -1.0, A, X, beta=1.0, C=B, alg=alg(GEMM_SUMMA_A))
    R2 = Gemm(NORMAL, NORMAL, 1.0, A, R, alg=alg(GEMM_SUMMA_B))
    R3 = Gemm(NORMAL, NORMAL, 1.0, A, R2, alg=alg(GEMM_SUMMA_C))
    Cr = ring_summa(A, G)
    blocks = R3.blocks if R3.sharded else (R3.data,)
    return Nrm2(R3), Nrm2(Cr), blocks


def entry(n: int = 256, nrhs: int = 16, dtype: torch.dtype = torch.float32,
          device: Union[torch.device, str, None] = None, seed: int = 0
          ) -> Tuple[Callable, Tuple[torch.Tensor, torch.Tensor]]:
    """(step, (a, b)): the main-path step and an n x n HPD problem with
    nrhs right-hand sides on ``device`` (the default grid's device when
    None)."""
    return hpd_solve_step, make_hpd_problem(n, nrhs, dtype, device, seed)
