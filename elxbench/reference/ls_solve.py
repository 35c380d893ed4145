"""Plain reference of the ``ls_solve`` configuration: X = argmin ||A X - B||
by Householder QR (LAPACK xGELS with TRANS = 'N', m = n here).

``make_problem`` is a frozen copy of the formulas of
``elementalx_torch.entry.make_ls_problem`` at m = n (A standard normal over
sqrt(n), B standard normal), drawn in the cell's dtype. ``solve`` is a
blocked Householder QR in plain PyTorch, as LAPACK's xGEQRF blocks it:
each panel factored by ``torch.geqrf``, its compact-WY T formed by
LAPACK's larft recurrence, and the block reflector applied to the trailing
columns and to B as C -= V T^T (V^T C); then R X = Q^T B by a triangular
solve.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from elxbench.reference.common import (
    compute_dtype,
    full_fp32,
    sub_product,
    tf32_round,
)


def make_problem(n: int, nrhs: int, dtype: torch.dtype,
                 gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, B) drawn on gen's device from ``gen``."""
    a = torch.randn((n, n), generator=gen, device=gen.device, dtype=dtype)
    a /= math.sqrt(n)
    b = torch.randn((n, nrhs), generator=gen, device=gen.device, dtype=dtype)
    return a, b


def product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b at ``precision`` (see common.py)."""
    if precision == "tf32":
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def larft(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """The upper triangular T with H_1 ... H_k = I - V T V^T for the
    unit-lower V (m, k) and its tau (LAPACK xLARFT, DIRECT = 'F', STOREV =
    'C'): T[i, i] = tau_i, T[:i, i] = -tau_i T[:i, :i] V[:, :i]^T v_i."""
    k = v.shape[1]
    g = v.mT @ v
    t = torch.zeros((k, k), dtype=v.dtype, device=v.device)
    for i in range(k):
        if i:
            t[:i, i] = -tau[i] * (t[:i, :i] @ g[:i, i])
        t[i, i] = tau[i]
    return t


def apply_qt(c: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
             precision: str) -> None:
    """c := (I - V T V^T)^T c = c - V T^T (V^T c) in place, both products
    with c at ``precision``."""
    w = t.mT @ product(v.mT, c, precision)
    sub_product(c, v, w, precision)


def solve(a: torch.Tensor, b: torch.Tensor, precision: str,
          nb: Optional[int] = None) -> torch.Tensor:
    """X for ``a`` (n x n) and ``b``, computed at ``precision`` (see
    common.py), returned in its compute dtype."""
    dt = compute_dtype(precision)
    n = a.shape[0]
    nb = nb or max(32, min(512, n // 32))
    w = a.to(dt, copy=True)  # factored in place: R on and above the diagonal
    c = b.to(dt, copy=True)  # becomes Q^T B
    with full_fp32():
        for k0 in range(0, n, nb):
            k1 = min(k0 + nb, n)
            pk, tau = torch.geqrf(w[k0:, k0:k1])
            w[k0:, k0:k1] = pk
            v = pk.tril(-1)
            v.diagonal().fill_(1)
            t = larft(v, tau)
            if k1 < n:
                apply_qt(w[k0:, k1:], v, t, precision)
            apply_qt(c[k0:], v, t, precision)
        return torch.linalg.solve_triangular(w.triu(), c, upper=True)
