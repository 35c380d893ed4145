"""Triangular inversion of (a batch of) matrices.

Counterpart of ``elementalx/blas/trinv.py``. Leading dimensions are batch
dimensions (the JAX package vmaps instead). A CUDA tensor is inverted by
one launch of K10 (``kernels/trinv.py``), which reads only the triangle
(and, for a unit triangle, not its diagonal) through the tensor's strides;
a CPU tensor takes K10's plain version, the JAX package's log-depth tree
of batched products,

    inv([[A, B], [0, C]]) = [[inv(A), -inv(A) B inv(C)], [0, inv(C)]]
"""

from __future__ import annotations

import torch

from .. import trace
from ..kernels.trinv import trinv


@trace.traced("blas.trinv")
def tri_inv_upper(U: torch.Tensor) -> torch.Tensor:
    """Inverse of (a batch of) upper-triangular matrices. Entries below the
    diagonal are ignored. The diagonal must be nonzero (callers guard
    padding with 1s)."""
    return trinv(U)


def tri_inv_lower(Lm: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular matrix (entries above the diagonal
    ignored)."""
    return tri_inv_upper(Lm.mT).mT


@trace.traced("blas.trinv")
def tri_inv_lower_unit(Lm: torch.Tensor) -> torch.Tensor:
    """Inverse of a UNIT lower-triangular matrix (stored diagonal and
    upper entries ignored)."""
    return trinv(Lm.mT, unit=True).mT
