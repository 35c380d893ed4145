"""The ported main paths as steps: the HPD solve and the LU solve.

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
from ``make_eig_problem``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch

from .blas import Gemm, Nrm2
from .core.dmatrix import DistMatrix
from .core.grid import Grid
from .core.types import LOWER, NORMAL
from .lapack import HermitianEig, HPDSolve, LinearSolve
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


def entry(n: int = 256, nrhs: int = 16, dtype: torch.dtype = torch.float32,
          device: Union[torch.device, str, None] = None, seed: int = 0
          ) -> Tuple[Callable, Tuple[torch.Tensor, torch.Tensor]]:
    """(step, (a, b)): the main-path step and an n x n HPD problem with
    nrhs right-hand sides on ``device`` (the default grid's device when
    None)."""
    return hpd_solve_step, make_hpd_problem(n, nrhs, dtype, device, seed)
