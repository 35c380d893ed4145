"""Householder QR: the panel factorization the SBR band reduction needs.

Counterpart of ``_geqrf_slab`` in ``elementalx/lapack/qr.py``
(reference: src/lapack_like/factor/QR/PanelHouseholder.hpp). The JAX
package calls LAPACK geqrf there, outside any Pallas kernel; the port
calls ``torch.geqrf``. The rest of QR is ROADMAP queue 1 item 6.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .reflect import build_wy_T


def _geqrf_slab(s: torch.Tensor, nb: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """geqrf of an (Mt, nb) slice -> (packed slab, tau, T): R on and above
    the diagonal, the unit-lower reflectors below it, and the forward
    compact-WY T of those reflectors."""
    pk, tau = torch.geqrf(s)
    r2 = torch.arange(pk.shape[0], device=s.device)[:, None]
    c2 = torch.arange(pk.shape[1], device=s.device)[None, :]
    V = torch.where(r2 > c2, pk, torch.zeros((), dtype=pk.dtype,
                                             device=s.device))
    V = torch.where(r2 == c2, torch.ones((), dtype=pk.dtype,
                                         device=s.device), V)
    return pk, tau, build_wy_T(V, tau)
