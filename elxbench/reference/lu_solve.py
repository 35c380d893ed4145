"""Plain reference of the ``lu_solve`` configuration: X = A \\ B for a
general A by LU with partial pivoting (LAPACK xGESV, HPL's problem class).

``make_problem`` is a frozen copy of the formulas of
``elementalx_torch.entry.make_lu_problem`` (A and B standard normal),
drawn in the cell's dtype. ``solve`` is a blocked right-looking LU in
plain PyTorch: each panel factored by ``torch.linalg.lu_factor_ex``, its
row swaps applied to the whole rows, U12 by a unit triangular solve, and
the trailing update as one product; then the two triangular solves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from elxbench.reference.common import compute_dtype, full_fp32, sub_product


def make_problem(n: int, nrhs: int, dtype: torch.dtype,
                 gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, B) drawn on gen's device from ``gen``."""
    a = torch.randn((n, n), generator=gen, device=gen.device, dtype=dtype)
    b = torch.randn((n, nrhs), generator=gen, device=gen.device, dtype=dtype)
    return a, b


def rows_from_pivots(pivots: np.ndarray, m: int) -> np.ndarray:
    """The row order that LAPACK's 1-based sequential swaps (row i with
    row pivots[i] - 1, for i = 0, 1, ...) give to m rows."""
    rows = np.arange(m)
    for i, p in enumerate(pivots - 1):
        rows[i], rows[p] = rows[p], rows[i]
    return rows


def solve(a: torch.Tensor, b: torch.Tensor, precision: str,
          nb: Optional[int] = None) -> torch.Tensor:
    """X for ``a`` and ``b``, computed at ``precision`` (see common.py),
    returned in its compute dtype."""
    dt = compute_dtype(precision)
    n = a.shape[0]
    nb = nb or max(32, min(512, n // 32))
    w = a.to(dt, copy=True)  # factored in place: L below, U on and above
    perm = torch.arange(n, device=a.device)
    with full_fp32():
        for k0 in range(0, n, nb):
            k1 = min(k0 + nb, n)
            lu, piv, _ = torch.linalg.lu_factor_ex(w[k0:, k0:k1])
            rows = k0 + torch.from_numpy(
                rows_from_pivots(piv.cpu().numpy(), n - k0)).to(a.device)
            if k0:
                w[k0:, :k0] = w[rows, :k0]
            if k1 < n:
                w[k0:, k1:] = w[rows, k1:]
            w[k0:, k0:k1] = lu
            perm[k0:] = perm[rows]
            if k1 < n:
                w[k0:k1, k1:] = torch.linalg.solve_triangular(
                    w[k0:k1, k0:k1], w[k0:k1, k1:], upper=False,
                    unitriangular=True)
                sub_product(w[k1:, k1:], w[k1:, k0:k1], w[k0:k1, k1:],
                            precision)
        y = torch.linalg.solve_triangular(w, b.to(dt)[perm], upper=False,
                                          unitriangular=True)
        return torch.linalg.solve_triangular(w, y, upper=True)
