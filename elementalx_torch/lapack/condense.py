"""Condensed-form reductions: the Hermitian tridiagonalization.

Counterpart of the tridiagonal half of ``elementalx/lapack/condense.py``
(reference: src/lapack_like/condense/HermitianTridiag.cpp and
HermitianTridiag/ApplyQ.hpp). The latrd-style blocked reduction: each
panel column costs one Hermitian matvec of the trailing block, and the
trailing two-sided update is a pair of products A -= V W^H + W V^H
through ``local_gemm`` (K1 on CUDA tensors).

On a CUDA tensor every panel runs in the K5 kernel (kernels/latrd.py),
at most 128 columns wide, and K5 raises for a dtype it does not take; a
CPU tensor's panels run in ``_tridiag_panel``, the JAX package's own
route off the TPU and for complex input. Bidiag and Hessenberg are not
ported yet (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..blas.gemm import local_gemm
from ..blas.level1 import MakeHermitian
from ..core.dmatrix import DistMatrix
from ..core.environment import Blocksize
from ..core.grid import Grid
from ..core.types import MC, MR, UpperOrLower
from ..kernels.common import on_cuda
from ..kernels.latrd import MAX_NB, latrd_panel
from .reflect import ApplyPackedReflectors, householder


class TridiagFactorization(NamedTuple):
    """packed: reflectors below the first subdiagonal; d, e: the REAL
    tridiagonal; tau: reflector scalars; phase: the diagonal unitary D
    absorbing complex subdiagonal phases (A = (QD) T (QD)^H)."""

    packed: DistMatrix
    d: torch.Tensor
    e: torch.Tensor
    tau: torch.Tensor
    phase: torch.Tensor

    @staticmethod
    def from_reference(packed: np.ndarray, m: int, d, e, tau, phase,
                       grid: Optional[Grid] = None
                       ) -> "TridiagFactorization":
        """The port's factorization for the JAX package's, given its
        arrays read through numpy (``packed`` is its DistMatrix's padded
        data, ``m`` the order). Vectors are cut to the port's padded
        order."""
        P = DistMatrix.from_reference(np.asarray(packed), m, m, grid=grid)
        M = P.data.shape[0]
        dev = P.device

        def vec(x, k):
            return torch.tensor(np.asarray(x)[:k], device=dev)

        return TridiagFactorization(P, vec(d, M), vec(e, max(M - 1, 0)),
                                    vec(tau, M), vec(phase, M))


def _tridiag_panel(a0: torch.Tensor, at: torch.Tensor, V: torch.Tensor,
                   W: torch.Tensor, tau: torch.Tensor, k0: int, nb: int,
                   m_loc: int):
    """latrd-style panel on the trailing block ``at`` (the (M-k0, M-k0)
    slice, local indices, panel columns 0..nb), whose current value is
    a0[k0:, k0:] - V W^H - W V^H with the panel's finished columns.
    ``a0`` is the full frozen array; ``tau`` is indexed globally. ``at``,
    ``V``, ``W`` and ``tau`` are written in place and returned."""
    Mt = at.shape[0]
    rows = torch.arange(Mt, device=at.device)
    a0t = a0[k0:, k0:]
    for j in range(nb):
        Vp, Wp = V[:, :j], W[:, :j]
        # current column of the updated trailing matrix
        acur = at[:, j] - Vp @ W[j, :j].conj() - Wp @ V[j, :j].conj()
        v, tj, beta = householder(acur, j + 1, m_loc)
        tau[k0 + j] = tj
        newcol = torch.where(rows > j + 1, v, acur)
        newcol = torch.where(rows == j + 1, beta, newcol)
        at[:, j] = newcol
        # w = tau A_cur v - (|tau|^2/2)(v^H A_cur v) v: the exact rank-2
        # form of the unitary similarity H^H A H with complex tau
        Av = a0t @ v
        p = tj * (Av - Vp @ (Wp.mH @ v) - Wp @ (Vp.mH @ v))
        w = p - (tj.conj() * 0.5 * torch.vdot(v, p)) * v
        V[:, j] = v
        W[:, j] = w
    return at, V, W, tau


def HermitianTridiag(uplo: UpperOrLower, A: DistMatrix,
                     blocksize: Optional[int] = None) -> TridiagFactorization:
    """Reduce a Hermitian matrix to real symmetric tridiagonal form,
    A = Q T Q^H (reference: condense/HermitianTridiag.cpp:60-130, lower
    variant; UPPER goes through the lower path). The working array is
    one copy of A, updated in place panel by panel."""
    nb = blocksize or Blocksize()
    Af = MakeHermitian(uplo, A.redistribute(MC, MR))
    a = Af.data.clone(memory_format=torch.contiguous_format)
    use_kernel = on_cuda(a)
    if use_kernel:
        # K5's panels are at most MAX_NB wide; the blocksize only groups
        # the trailing update, so a wider one is cut to that
        nb = min(nb, MAX_NB)
    M = a.shape[0]
    m = A.m
    ncols = max(m - 2, 0)
    nblk = (ncols + nb - 1) // nb if ncols else 0
    tau = a.new_zeros((M,))

    for b in range(nblk):
        k0 = b * nb
        w = min(nb, ncols - k0)
        if use_kernel:
            P, Wg, taup = latrd_panel(a, k0, w, nb=nb)
            # V from P: the pivot row holds an implicit 1, the rows below
            # the reflector
            rows = torch.arange(M - k0, device=a.device)[:, None]
            pivs = torch.arange(w, device=a.device)[None, :] + 1
            Pk = P[k0:, :w]
            V = torch.where(rows > pivs, Pk, torch.zeros((), dtype=a.dtype,
                                                         device=a.device))
            V = torch.where(rows == pivs, torch.ones((), dtype=a.dtype,
                                                     device=a.device), V)
            tau[k0:k0 + w] = taup[:w]
            a[k0:, k0:k0 + w] = Pk
            W = Wg[k0:, :w]
        else:
            at = a[k0:, k0:].clone()
            Mt = at.shape[0]
            V = a.new_zeros((Mt, w))
            W = a.new_zeros((Mt, w))
            at, V, W, tau = _tridiag_panel(a, at, V, W, tau, k0, w, m - k0)
            a[k0:, k0:k0 + w] = at[:, :w]
        # two-sided trailing update of the columns right of the panel
        a[k0:, k0 + w:] -= (local_gemm(V, W[w:].mH)
                            + local_gemm(W, V[w:].mH))

    d = torch.diagonal(a).real.clone()
    e_c = torch.diagonal(a, -1).clone()
    if a.is_complex():
        mag = torch.abs(e_c)
        one = torch.ones((), dtype=a.dtype, device=a.device)
        sign = torch.where(mag == 0, one, e_c / torch.where(mag == 0, 1, mag))
        phase = torch.cat([one.reshape(1), torch.cumprod(sign, 0)])
        e = mag
    else:
        phase = a.new_ones((e_c.shape[0] + 1,))
        e = e_c
    out = Af.with_data(Af.mask_padding(a))
    return TridiagFactorization(out, d, e, tau, phase)


def tridiag_apply_q(fact: TridiagFactorization, B: torch.Tensor,
                    adjoint: bool, blocksize: Optional[int] = None
                    ) -> torch.Tensor:
    """Backtransform: B := Q B or Q^H B with Q from the tridiagonal
    reduction (reference: condense/HermitianTridiag/ApplyQ.hpp); the
    effective Q includes the phase diagonal, Q_eff = Q_householder D."""
    nb = blocksize or Blocksize()
    m = fact.packed.m
    ncols = max(m - 2, 0)
    pdt = fact.packed.dtype
    phase = torch.ones((B.shape[0],), dtype=pdt, device=B.device)
    phase[: fact.phase.shape[0]] = fact.phase.to(pdt)
    if adjoint:
        if ncols:
            B = ApplyPackedReflectors(fact.packed.data, fact.tau, B, nb,
                                      ncols, adjoint=True, offset=1)
        return phase.conj()[:, None] * B
    B = phase[:, None] * B
    if ncols == 0:
        return B
    return ApplyPackedReflectors(fact.packed.data, fact.tau, B, nb, ncols,
                                 adjoint=False, offset=1)
