"""The HPD-solve main path as one step.

Counterpart of ``__graft_entry__.entry()``: an HPD solve (Cholesky and two
triangular solves), the residual Gemm R = B - A X, and its norm, on a
one-device grid. ``entry`` returns the step and an example problem, as
the JAX version returns its jittable step and example arguments.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch

from .blas import Gemm, Nrm2
from .core.dmatrix import DistMatrix
from .core.grid import Grid
from .core.types import LOWER, NORMAL
from .lapack import HPDSolve


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


def entry(n: int = 256, nrhs: int = 16, dtype: torch.dtype = torch.float32,
          device: Union[torch.device, str, None] = None, seed: int = 0
          ) -> Tuple[Callable, Tuple[torch.Tensor, torch.Tensor]]:
    """(step, (a, b)): the main-path step and an n x n HPD problem with
    nrhs right-hand sides on ``device`` (the default grid's device when
    None)."""
    return hpd_solve_step, make_hpd_problem(n, nrhs, dtype, device, seed)
