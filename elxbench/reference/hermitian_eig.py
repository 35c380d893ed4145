"""Plain reference of the ``hermitian_eig`` configuration: every eigenpair
(w ascending, Q's columns the eigenvectors) of a dense symmetric A, of
which the solver reads the lower triangle (LAPACK xSYEVR with JOBZ = 'V',
RANGE = 'A', UPLO = 'L').

``make_problem`` is a frozen copy of the formula of
``elementalx_torch.entry.make_eig_problem``: A = (G + G^T) / sqrt(8 n) for
a standard normal G, here drawn in the cell's dtype (its spectrum fills
about [-1, 1], without tight clusters; exactly symmetric, since
G_ij + G_ji is G_ji + G_ij); the problem has no right-hand side, so B is
n x 0. ``solve`` is ``torch.linalg.eigh`` at a stated precision.

``numbers`` are the judge's for an eigendecomposition (eigenvectors are
fixed only up to sign, so Q is never compared entry by entry), each
evaluated in float64 and scaled by the traffic dtype's eps, with w_ref
the float64 reference's eigenvalues:

- ``resid`` = max|A Q - Q diag(w)| / (eps n max|w_ref|), the residual of
  the program's own pairs;
- ``orth`` = max|Q^T Q - I| / (eps n), the orthogonality of its vectors;
- ``fwd`` = max|w - w_ref| / (eps max|w_ref|), its eigenvalues' error; by
  Weyl's bound an eigenvalue moves by at most the norm of a perturbation
  of A, so this reads alike for any spectrum.

``resid`` and ``orth`` are the definitions of ``chip_smoke.py``'s phase 8
(there with the program's max|w|), so that their readings compare.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from elxbench.reference.common import compute_dtype, full_fp32, tf32_round


def make_problem(n: int, nrhs: int, dtype: torch.dtype,
                 gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, B) drawn on gen's device from ``gen``; B is n x 0."""
    g = torch.randn((n, n), generator=gen, device=gen.device, dtype=dtype)
    a = (g + g.mT) / math.sqrt(8 * n)
    return a, a.new_empty((n, 0))


def solve(a: torch.Tensor, b: torch.Tensor, precision: str
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w, Q) of the lower triangle of ``a`` (``b`` is not read), computed
    at ``precision``: ``"float64"`` or ``"float32"``, the eigensolver in
    that dtype; ``"tf32"``, the control below float32: A's entries rounded
    to TF32's 10-bit mantissa, then the eigensolver in float32. Returned
    in the compute dtype."""
    dt = compute_dtype(precision)
    a = a.to(dt)
    if precision == "tf32":
        a = tf32_round(a)
    with full_fp32():
        return tuple(torch.linalg.eigh(a, UPLO="L"))


def numbers(a: torch.Tensor, b: torch.Tensor,
            answer: Tuple[torch.Tensor, torch.Tensor],
            ref: Tuple[torch.Tensor, torch.Tensor],
            eps: float) -> Dict[str, float]:
    """resid, orth and fwd of one answer (w, Q) (any dtype) for float64
    ``a`` and the float64 reference's ``ref`` = (w_ref, Q_ref)."""
    n = a.shape[0]
    w, q = (t.to(torch.float64) for t in answer)
    w_ref = ref[0]
    wmax = float(w_ref.abs().max())
    eye = torch.eye(n, dtype=torch.float64, device=a.device)
    return {"resid": float((a @ q - q * w).abs().max()) / (eps * n * wmax),
            "orth": float((q.mT @ q - eye).abs().max()) / (eps * n),
            "fwd": float((w - w_ref).abs().max()) / (eps * wmax)}
