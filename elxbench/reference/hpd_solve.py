"""Plain reference of the ``hpd_solve`` configuration: X = A \\ B for a
symmetric positive definite A, of which the solver reads the lower
triangle (LAPACK xPOSV with UPLO = 'L').

``make_problem`` is a frozen copy of the formulas of
``elementalx_torch.entry.make_hpd_problem`` (A = G G^T / n + 2 I for a
standard normal G, B standard normal), drawn in the cell's dtype and made
exactly symmetric from its lower triangle. ``solve`` is a blocked
right-looking Cholesky and two triangular solves in plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from elxbench.reference.common import compute_dtype, full_fp32, sub_product


def make_problem(n: int, nrhs: int, dtype: torch.dtype,
                 gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, B) drawn on gen's device from ``gen``."""
    dev = gen.device
    with full_fp32():
        g = torch.randn((n, n), generator=gen, device=dev, dtype=dtype)
        g /= math.sqrt(n)
        a = g @ g.mT
        del g
        a.diagonal().add_(2.0)
        low = a.tril_()
        a = low + low.tril(-1).mT
    b = torch.randn((n, nrhs), generator=gen, device=dev, dtype=dtype)
    return a, b


def solve(a: torch.Tensor, b: torch.Tensor, precision: str,
          nb: Optional[int] = None) -> torch.Tensor:
    """X for the lower triangle of ``a`` and ``b``, computed at
    ``precision`` (see common.py), returned in its compute dtype."""
    dt = compute_dtype(precision)
    n = a.shape[0]
    nb = nb or max(32, min(1024, n // 16))
    w = a.to(dt).tril()  # a copy, factored in place
    with full_fp32():
        for k0 in range(0, n, nb):
            k1 = min(k0 + nb, n)
            d = w[k0:k1, k0:k1]
            l11 = torch.linalg.cholesky(d + d.tril(-1).mT)
            w[k0:k1, k0:k1] = l11
            if k1 < n:
                # L21 = A21 L11^-T, then the trailing update A22 -= L21 L21^T
                l21 = torch.linalg.solve_triangular(
                    l11.mT, w[k1:, k0:k1], upper=True, left=False)
                w[k1:, k0:k1] = l21
                sub_product(w[k1:, k1:], l21, l21.mT, precision)
        w.tril_()
        y = torch.linalg.solve_triangular(w, b.to(dt), upper=False)
        return torch.linalg.solve_triangular(w.mT, y, upper=True)
