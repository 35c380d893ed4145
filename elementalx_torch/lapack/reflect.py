"""Householder reflector machinery.

Counterpart of ``elementalx/lapack/reflect.py`` (reference:
src/lapack_like/reflect/: ApplyPackedReflectors, ExpandPackedReflectors,
the Householder and hyperbolic reflector kernels, and the compact-WY T
matrix of factor/QR/). Reflectors are packed below the diagonal as in
LAPACK; a block of them is applied as A := A - V T (V^H A), three
products, two of them through ``local_gemm`` (K1 on CUDA tensors).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..blas.gemm import local_gemm
from ..blas.trinv import tri_inv_upper


def _sign(x: torch.Tensor) -> torch.Tensor:
    """Complex-safe sign with sign(0) = 1."""
    ax = torch.abs(x)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(ax == 0, one, x / torch.where(ax == 0, 1, ax))


def householder(x: torch.Tensor, j: int, m: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reflector for column vector x, pivot row j, active rows [j, m):
    H x = beta e_j with H = I - tau v v^H, v[j] = 1 (reference:
    reflect/Householder.cpp). Returns (v, tau, beta); v is zero outside
    [j, m). beta = -sign(alpha) ||x||, so tau is real."""
    M = x.shape[0]
    rows = torch.arange(M, device=x.device)
    active_below = (rows > j) & (rows < m)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    # a pivot past the end reads the last entry, as dynamic indexing clamps
    alpha = x[min(j, M - 1)]
    xb = torch.where(active_below, x, zero)
    sigma2 = torch.sum(torch.abs(xb) ** 2)
    norm = torch.sqrt(torch.abs(alpha) ** 2 + sigma2)
    beta = -_sign(alpha) * norm.to(x.dtype)
    trivial = sigma2 == 0
    safe_denom = torch.where(trivial, one, alpha - beta)
    v = torch.where(active_below, xb / safe_denom, zero)
    if j < M:
        v[j] = 1
    tau = torch.where(trivial, zero, (beta - alpha) / torch.where(
        beta == 0, one, beta))
    beta = torch.where(trivial, alpha, beta)
    return v, tau, beta


def build_wy_T(V: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Upper-triangular T with H_1 ... H_nb = I - V T V^H, for one block
    (V (m, nb), tau (nb,)) or a batch of them (leading dimensions).

    Closed form: T^{-1} = diag(1/tau) + triu(V^H V, 1), one batched
    triangular inversion (blas/trinv.py). Columns with tau = 0 are
    decoupled and masked to zero in T, as the larft recurrence leaves
    them. In float32 one Newton step T := T (2I - T^{-1} T) against the
    accurate T^{-1} polishes the inversion."""
    nb = V.shape[-1]
    dev = V.device
    f32ish = V.dtype in (torch.float32, torch.complex64)
    G = torch.matmul(V.mH, V)
    rows = torch.arange(nb, device=dev)[:, None]
    cols = torch.arange(nb, device=dev)[None, :]
    live = tau != 0
    one = torch.ones((), dtype=tau.dtype, device=dev)
    safe_tau = torch.where(live, tau, one)
    both = live[..., :, None] & live[..., None, :]
    zero = torch.zeros((), dtype=G.dtype, device=dev)
    Tinv = torch.where(both & (cols > rows), G, zero)
    diag = (1.0 / safe_tau).to(G.dtype)[..., None, :].expand(G.shape)
    Tinv = torch.where(rows == cols, diag, Tinv)
    T = tri_inv_upper(Tinv)
    if f32ish:
        eye2 = 2.0 * torch.eye(nb, dtype=T.dtype, device=dev)
        T = torch.matmul(T, eye2 - torch.matmul(Tinv, T))
        T = torch.where(cols >= rows, T, zero)
    return torch.where(both, T, zero)


def apply_block_reflector(V: torch.Tensor, T: torch.Tensor, A: torch.Tensor,
                          adjoint: bool) -> torch.Tensor:
    """A := (I - V T V^H) A (adjoint=False, applies Q_b), or
    A := (I - V T^H V^H) A (adjoint=True, applies Q_b^H)."""
    W = local_gemm(V.mH, A)  # (nb, N)
    Tm = T.mH if adjoint else T
    return A - local_gemm(V, local_gemm(Tm, W))


def extract_panel_V(a: torch.Tensor, k0: int, nb: int, offset: int = 0
                    ) -> torch.Tensor:
    """The unit-lower-trapezoidal V of panel columns [k0, k0+nb) of a
    packed factorization; ``offset`` moves the unit row below the
    diagonal (offset=1 for tridiagonal/Hessenberg reflectors)."""
    M = a.shape[0]
    panel = a[:, k0:k0 + nb]
    rows = torch.arange(M, device=a.device)[:, None]
    cols = torch.arange(nb, device=a.device)[None, :] + k0 + offset
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    V = torch.where(rows > cols, panel, zero)
    return torch.where(rows == cols, torch.ones_like(zero), V)


def ApplyPackedReflectors(packed: torch.Tensor, tau: torch.Tensor,
                          A: torch.Tensor, nb: int, ncols: int,
                          adjoint: bool, offset: int = 0) -> torch.Tensor:
    """Apply Q (or Q^H) held as packed reflectors to A from the left
    (reference: reflect/ApplyPackedReflectors.hpp, vertical-forward-lower;
    offset=1 is the condense/ApplyQ storage). ``ncols`` reflector
    columns. Each block runs on the row slice its V reaches. Returns a
    new tensor; A is not written."""
    A = A.clone()
    nblk = (ncols + nb - 1) // nb
    order = range(nblk) if adjoint else range(nblk - 1, -1, -1)
    for b in order:
        k0 = b * nb
        w = min(nb, ncols - k0)
        r0 = min(k0 + offset, A.shape[0])
        V = extract_panel_V(packed, k0, w, offset)[r0:]
        T = build_wy_T(V, tau[k0:k0 + w])
        A[r0:] = apply_block_reflector(V, T, A[r0:], adjoint)
    return A


def ExpandPackedReflectors(packed: torch.Tensor, tau: torch.Tensor, nb: int,
                           ncols: int, out_cols: int) -> torch.Tensor:
    """Q's first out_cols columns (reference:
    reflect/ExpandPackedReflectors.hpp)."""
    M = packed.shape[0]
    eye = torch.eye(M, out_cols, dtype=packed.dtype, device=packed.device)
    return ApplyPackedReflectors(packed, tau, eye, nb, ncols, adjoint=False)


def LeftHyperbolicReflector(chi, x: torch.Tensor):
    """Hyperbolic Householder: (tau, new_chi, v) with
    (I - (1/tau) w w^H Sigma) [chi; x] = -lambda e_0, w = [1; v],
    Sigma = diag(1, -1, ..., -1) (reference: reflect/Hyperbolic.cpp:20-80).
    chi must be real with chi^2 > ||x||^2, else the result is NaN."""
    x = torch.as_tensor(x)
    alpha = torch.as_tensor(chi, device=x.device)
    alpha = alpha.real if alpha.is_complex() else alpha
    alpha = alpha.to(x.real.dtype if x.is_complex() else x.dtype)
    xnrm2 = torch.sum(torch.abs(x) ** 2)
    delta = alpha * alpha - xnrm2
    lam = torch.where(alpha >= 0, torch.sqrt(delta), -torch.sqrt(delta))
    kappa = alpha + lam
    zero_kappa = kappa == 0
    safe = torch.where(zero_kappa, torch.ones_like(kappa), kappa)
    v = torch.where(zero_kappa, torch.zeros_like(x), x / safe.to(x.dtype))
    tau = torch.where(zero_kappa, torch.ones_like(delta),
                      (delta + alpha * lam) / (safe * safe))
    return tau, -lam, v


def RightHyperbolicReflector(chi, x: torch.Tensor):
    """Row form (reference: Hyperbolic.cpp:132): the left kernel with the
    vector conjugated on exit."""
    tau, new_chi, v = LeftHyperbolicReflector(chi, x)
    return tau, new_chi, v.conj()


def LeftReflector(chi, x: torch.Tensor):
    """(tau, beta, v) with (I - tau [1; v] [1; v]^H) [chi; x] = [beta; 0]
    (reference: Householder.cpp:40). x = 0 gives the valid reflector
    tau = 2, v = 0, beta = -chi, as the reference does (never H = I)."""
    x = torch.as_tensor(x)
    c = torch.as_tensor(chi, dtype=x.dtype, device=x.device).reshape(1)
    full = torch.cat([c, x])
    v, tau, beta = householder(full, 0, full.shape[0])
    trivial = torch.sum(torch.abs(x) ** 2) == 0
    tau = torch.where(trivial, torch.full_like(tau, 2.0), tau)
    beta = torch.where(trivial, -c[0].to(beta.dtype), beta)
    v = torch.where(trivial, torch.zeros_like(v), v)
    return tau, beta, v[1:]


def RightReflector(chi, x: torch.Tensor):
    """Row form (reference: Householder.cpp RightReflector): the left
    kernel with the vector conjugated on exit."""
    tau, beta, v = LeftReflector(chi, x)
    return tau, beta, v.conj()
