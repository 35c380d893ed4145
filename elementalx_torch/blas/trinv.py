"""Batched recursive triangular inversion.

Counterpart of ``elementalx/blas/trinv.py``: the inverse is built as a
log-depth tree of batched products instead of a column-by-column
substitution,

    inv([[A, B], [0, C]]) = [[inv(A), -inv(A) B inv(C)], [0, inv(C)]]

with every diagonal block of one granularity inverted at once (one batched
substitution at 16 x 16, then two batched products per doubling level).
Leading dimensions are batch dimensions (the JAX package vmaps instead). The batched 3-D products are ``torch.matmul``, as they are
plain XLA products outside any kernel in the JAX package.
"""

from __future__ import annotations

import torch

from .. import trace

_BASE = 16


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _blocks(U: torch.Tensor, s: int) -> torch.Tensor:
    """View of a (..., P, P) tensor as (..., P/s, P/s, s, s) blocks."""
    q = U.shape[-1] // s
    return U.reshape(*U.shape[:-2], q, s, q, s).transpose(-3, -2)


def _inv_upper_unblocked(U: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of small upper-triangular blocks by back
    substitution, one row of the inverse per step (writes its own output
    buffer in place)."""
    n = U.shape[-1]
    X = torch.zeros_like(U)
    eye = torch.eye(n, dtype=U.dtype, device=U.device)
    for i in range(n - 1, -1, -1):
        rhs = eye[i] - (U[..., i:i + 1, i + 1:] @ X[..., i + 1:, :])[..., 0, :]
        X[..., i, :] = rhs / U[..., i, i:i + 1]
    return X


@trace.traced("blas.trinv")
def tri_inv_upper(U: torch.Tensor) -> torch.Tensor:
    """Inverse of (a batch of) upper-triangular matrices via batched
    recursive 2x2 block partitioning. Entries below the diagonal are
    ignored. The diagonal must be nonzero (callers guard padding with 1s).

    The triangle is embedded in a (..., P, P) buffer, P the next power of
    two, whose padding diagonal is set to 1 through a view of the
    diagonal (``fill_``: the 1 travels as a kernel argument, so the host
    does not wait for the stream, and nothing is written when n == P)."""
    n = U.shape[-1]
    batch = U.shape[:-2]
    P = max(_next_pow2(n), _BASE)
    # mask to the triangle and embed an identity in the padding
    Up = U.new_zeros((*batch, P, P))
    Up[..., :n, :n] = torch.triu(U)
    Up.diagonal(dim1=-2, dim2=-1)[..., n:].fill_(1)

    L = _inv_upper_unblocked(
        _blocks(Up, _BASE).diagonal(dim1=-4, dim2=-3).movedim(-1, -3))
    s = _BASE
    while s < P:
        A = L[..., 0::2, :, :]
        C = L[..., 1::2, :, :]
        B = _blocks(Up, s)[..., 0::2, 1::2, :, :].diagonal(
            dim1=-4, dim2=-3).movedim(-1, -3)
        TR = -torch.matmul(A, torch.matmul(B, C))
        top = torch.cat([A, TR], dim=-1)
        bot = torch.cat([torch.zeros_like(TR), C], dim=-1)
        L = torch.cat([top, bot], dim=-2)
        s *= 2
    return L[..., 0, :n, :n]


def tri_inv_lower(Lm: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular matrix (entries above the diagonal
    ignored)."""
    return tri_inv_upper(Lm.mT).mT


def tri_inv_lower_unit(Lm: torch.Tensor) -> torch.Tensor:
    """Inverse of a UNIT lower-triangular matrix (stored diagonal and
    upper entries ignored)."""
    n = Lm.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=Lm.device)
    Lu = torch.where(eye, torch.ones((), dtype=Lm.dtype, device=Lm.device), Lm)
    return tri_inv_lower(Lu)
