"""Permutations.

Counterpart of ``elementalx/lapack/perm.py`` (reference:
include/El/core/Permutation.hpp:14, src/lapack_like/perm/*). A
permutation is an int64 index tensor; applying it is one gather along the
row or column dimension of the padded data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import trace
from ..core.dmatrix import DistMatrix, padded_extent
from ..core.grid import Grid


@dataclasses.dataclass(frozen=True)
class Permutation:
    """Image-form permutation: (P A)[i, :] = A[perm[i], :].

    ``perm`` has the padded length; entries >= m are the identity so a
    permutation applies cleanly to padded arrays."""

    perm: torch.Tensor
    m: int = 0

    @staticmethod
    def identity(m: int, padded: int,
                 device: torch.device | str | None = None) -> "Permutation":
        return Permutation(torch.arange(padded, device=device), m)

    @staticmethod
    def from_reference(perm: np.ndarray, m: int,
                       grid: Grid | None = None) -> "Permutation":
        """The port's Permutation for a JAX package Permutation, given its
        ``perm`` read through numpy. The reference pads to its own grid's
        quantum; the vector is cut or extended (with the identity) to the
        port's padded length. Raises unless its first m entries permute
        [0, m)."""
        g = grid or Grid.default()
        n = padded_extent(m, g)
        p = np.asarray(perm, np.int64)[:n]
        p = np.concatenate([p, np.arange(p.shape[0], n)])
        if sorted(p[:m].tolist()) != list(range(m)):
            raise ValueError("Permutation.from_reference: the first m entries "
                             "are not a permutation of [0, m)")
        return Permutation(torch.as_tensor(p, device=g.device), m)

    def inverse(self) -> "Permutation":
        inv = torch.empty_like(self.perm)
        inv[self.perm] = torch.arange(self.perm.shape[0],
                                      device=self.perm.device)
        return Permutation(inv, self.m)

    def compose_swap(self, i, j) -> "Permutation":
        """Append a swap of positions i, j (reference: Permutation::Swap)."""
        p = self.perm.clone()
        p[[i, j]] = self.perm[[j, i]]
        return Permutation(p, self.m)

    # -- application (reference: perm/PermuteRows.hpp etc.) --
    @trace.traced("lapack.perm.apply_rows")
    def apply_rows(self, A: DistMatrix, inverse: bool = False) -> DistMatrix:
        p = self.inverse().perm if inverse else self.perm
        return A.with_data(A.data[p.to(A.device), :])

    def apply_cols(self, A: DistMatrix, inverse: bool = False) -> DistMatrix:
        p = self.inverse().perm if inverse else self.perm
        return A.with_data(A.data[:, p.to(A.device)])

    def to_explicit(self, grid=None) -> torch.Tensor:
        """Dense permutation matrix (reference: ExplicitPermutation)."""
        n = self.perm.shape[0]
        eye = torch.arange(n, device=self.perm.device)[None, :]
        return (eye == self.perm[:, None]).to(torch.float32)


PermuteRows = Permutation.apply_rows
PermuteCols = Permutation.apply_cols


def InversePermuteRows(P: Permutation, A: DistMatrix) -> DistMatrix:
    """Reference: perm/InversePermuteRows.hpp."""
    return P.apply_rows(A, inverse=True)


def InversePermuteCols(P: Permutation, A: DistMatrix) -> DistMatrix:
    """Reference: perm/InversePermuteCols.hpp."""
    return P.apply_cols(A, inverse=True)


def PermuteSymmetrically(P: Permutation, A: DistMatrix,
                         inverse: bool = False) -> DistMatrix:
    """P A P^T (reference: perm/PermuteSymmetrically — both-sided
    application preserving symmetry)."""
    return P.apply_cols(P.apply_rows(A, inverse=inverse), inverse=inverse)


def InversePermuteSymmetrically(P: Permutation, A: DistMatrix
                                ) -> DistMatrix:
    return PermuteSymmetrically(P, A, inverse=True)


def PivotsToPartialPermutation(pivots, n: int) -> Permutation:
    """Convert a LAPACK-style swap sequence (row j <-> pivots[j]) to the
    image-form permutation it composes to (reference:
    perm/PivotsToPartialPermutation.hpp). Host loop: pivot vectors are
    O(n)."""
    piv = np.asarray(pivots.cpu() if isinstance(pivots, torch.Tensor)
                     else pivots)
    perm = np.arange(max(n, piv.shape[0]), dtype=np.int64)
    for j in range(min(n, piv.shape[0])):
        p = int(piv[j])
        perm[j], perm[p] = perm[p], perm[j]
    return Permutation(torch.as_tensor(perm), n)
