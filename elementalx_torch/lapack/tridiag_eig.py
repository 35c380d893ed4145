"""Symmetric tridiagonal eigensolver: Sturm multisection and batched
inverse iteration.

Counterpart of ``elementalx/lapack/tridiag_eig.py`` (reference:
src/lapack_like/spectral/HermitianTridiagEig.cpp, which delegates to
pmrrr). All n eigenvalues are bracketed at once by a Sturm-count
recurrence over a batch of shifts; all eigenvectors come at once from
batched inverse iteration (twisted-free LU solves of T - lam I), with
cluster-masked CholeskyQR between the rounds and windowed Gram-Schmidt
sweeps after them.

The JAX package's ``scan``s become Python loops over the n positions of
the recurrence, each step a few tensor operations over the whole batch;
on a card that is several launches per step (PERF.md section 5 gives
their share). The start vectors come from a ``torch.Generator`` seeded
with 7, drawn on the CPU and then moved, so the card and the CPU start
from the same vectors; ``_tridiag_eig`` takes them as an argument.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..blas.trinv import tri_inv_lower

_SECT = 8  # interval subdivisions per multisection step (3 bits)
_SEED = 7  # seed of the inverse-iteration start vectors


def _tmax(x: torch.Tensor) -> torch.Tensor:
    """max|x|, zero for an empty x."""
    if x.numel() == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.max(torch.abs(x))


def _sturm_count(d: torch.Tensor, e: torch.Tensor,
                 lam: torch.Tensor) -> torch.Tensor:
    """Number of eigenvalues of T strictly below each shift of lam (k,),
    by the shifted LDL^T recurrence (pmrrr's plarre core loop). A pivot
    below the floor becomes a tiny NEGATIVE value and is counted (the
    dlaneg convention: an exact eigenvalue hit must not flip the count)."""
    n = d.shape[0]
    eps = torch.finfo(d.dtype).eps
    scale = torch.maximum(_tmax(d), _tmax(e))
    floor = eps * eps * torch.clamp(scale, min=1.0)
    negfloor = -floor
    e2 = torch.cat([d.new_zeros((1,)), e * e])
    q = torch.ones_like(lam)
    cnt = torch.zeros(lam.shape, dtype=torch.int32, device=lam.device)
    for i in range(n):
        q = torch.addcdiv(d[i] - lam, e2[i], q, value=-1)
        q = torch.where(torch.abs(q) < floor, negfloor, q)
        cnt += q < 0
    return cnt


def _gershgorin(d: torch.Tensor, e: torch.Tensor):
    ae = torch.abs(e)
    z = d.new_zeros((1,))
    r = torch.cat([z, ae]) + torch.cat([ae, z])
    return torch.min(d - r), torch.max(d + r)


def tridiag_eigvalsh(d: torch.Tensor, e: torch.Tensor,
                     iters: int = 0) -> torch.Tensor:
    """All eigenvalues of the symmetric tridiagonal (d, e), ascending, by
    batched octsection on the Sturm count: each step probes the 7 interior
    points of every eigenvalue's bracket with one Sturm recurrence over
    7n shifts and gains 3 bits."""
    n = d.shape[0]
    S = _SECT
    lo, hi = _gershgorin(d, e)
    span = torch.clamp(hi - lo, min=torch.finfo(d.dtype).tiny)
    lo = lo - 1e-3 * span - 1e-30
    hi = hi + 1e-3 * span + 1e-30
    bits = 70 if d.dtype == torch.float64 else 40
    its = iters or (-(-bits // 3) + 1)
    ks = torch.arange(n, dtype=torch.int32, device=d.device)
    los = lo.expand(n).clone()
    his = hi.expand(n).clone()
    fr = (torch.arange(1, S, dtype=d.dtype, device=d.device) / S)[:, None]
    for _ in range(its):
        pts = los[None, :] + fr * (his - los)[None, :]          # (S-1, n)
        cnt = _sturm_count(d, e, pts.reshape(-1)).reshape(S - 1, n)
        above = cnt <= ks[None, :]  # eigenvalue k lies above this point
        los = torch.max(torch.where(above, pts, los[None, :]), dim=0).values
        his = torch.min(torch.where(above, his[None, :], pts), dim=0).values
    return 0.5 * (los + his)


def _solve_shifted(d: torch.Tensor, e: torch.Tensor, lam: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Solve (T - lam_k I) x_k = b_k for a batch of shifts lam (K,) and
    right-hand sides b (K, n), by LU without pivoting on the tridiagonal
    (a tiny pivot is replaced by eps). Used for inverse iteration, where
    pivot growth only amplifies the wanted eigenvector."""
    n = d.shape[0]
    eps = torch.finfo(d.dtype).eps
    dd = d[None, :] - lam[:, None]                                # (K, n)
    e_in = torch.cat([d.new_zeros((1,)), e])
    # forward elimination: l_i = e_{i-1} / u_{i-1}; u_i = dd_i - l_i e_{i-1}
    u = torch.empty_like(dd)
    l = torch.empty_like(dd)
    u_prev = torch.ones_like(lam)
    for i in range(n):
        safe = torch.where(torch.abs(u_prev) < eps, eps, u_prev)
        li = e_in[i] / safe
        u_prev = dd[:, i] - li * e_in[i]
        u[:, i] = u_prev
        l[:, i] = li
    u[:, 0] = dd[:, 0]
    # forward substitution L y = b
    y = torch.empty_like(b)
    y_prev = torch.zeros_like(lam)
    for i in range(n):
        y_prev = b[:, i] - l[:, i] * y_prev
        y[:, i] = y_prev
    # back substitution: u_i x_i + e_i x_{i+1} = y_i
    e_out = torch.cat([e, d.new_zeros((1,))])
    safe_u = torch.where(torch.abs(u) < eps, eps, u)
    x = torch.empty_like(b)
    x_next = torch.zeros_like(lam)
    for i in range(n - 1, -1, -1):
        x_next = (y[:, i] - e_out[i] * x_next) / safe_u[:, i]
        x[:, i] = x_next
    return x


def _one_vec(d, e, lam, b, steps: int) -> torch.Tensor:
    """``steps`` normalised inverse-iteration solves of the batch (rows)."""
    x = b
    for _ in range(steps):
        x = _solve_shifted(d, e, lam, x)
        nx = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
        x = x / torch.where(nx == 0, torch.ones_like(nx), nx)
    return x


def _rayleigh_rows(d, e, Z):
    """Rayleigh quotients of the rows of Z."""
    Td = d[None, :] * Z
    Td[:, 1:] += e[None, :] * Z[:, :-1]
    Td[:, :-1] += e[None, :] * Z[:, 1:]
    return torch.sum(Z * Td, dim=1)


def _tridiag_eig(d: torch.Tensor, e: torch.Tensor, b0: torch.Tensor,
                 invit_steps: int = 1, ortho_window: int = 8,
                 ortho_passes: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """``tridiag_eig`` from the given start block b0 (n, n), row i the
    start vector of eigenvalue i."""
    n = d.shape[0]
    dev, dt = d.device, d.dtype
    w = tridiag_eigvalsh(d, e)
    eps = torch.finfo(dt).eps
    tnorm = torch.maximum(_tmax(d), _tmax(e))
    tn1 = torch.clamp(tnorm, min=1.0)
    # splitting (LAPACK dstebz/pmrrr dlarra): zero negligible couplings
    # before the eigenvector phase, relative to the neighbouring diagonal
    # entries; the eigenvalues still come from the unsplit matrix
    if e.shape[0]:
        dg = torch.sqrt(torch.abs(d[:-1]) * torch.abs(d[1:]))
        stol = 64 * eps * torch.maximum(dg, eps * tn1)
        e = torch.where(torch.abs(e) <= stol, torch.zeros_like(e), e)
    # split exact-duplicate targets with a bounded local jitter
    gap_tol = eps * tn1
    idx = torch.arange(n, device=dev)
    jitter = ((idx % 8).to(dt) - 3.5) * gap_tol
    Z = _one_vec(d, e, w + jitter, b0.to(device=dev, dtype=dt),
                 invit_steps)                           # rows: eigvecs

    # clusters are contiguous in the ascending order, so the masked Gram
    # is block diagonal and one masked CholeskyQR orthonormalises them all.
    # It runs in float64 for a float32 input (the JAX package's runs in
    # float32): a dense cluster's inverse-iteration vectors are so nearly
    # dependent that the float32 Gram loses their orthogonality or fails
    # to factor, and a failed factorization skips the pass (GenDefEig's
    # tridiagonal at n = 8192, seed 6, from the JAX start vectors:
    # max|Z^T Z - I| = 884 eps n with a float32 QR, the JAX package's
    # 0.02 by the luck of its rounding, 0.0075 in float64).
    ctol = max(16 * n * eps, 4.0 / n) * tn1
    newc = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                      torch.diff(w) > ctol])
    cid = torch.cumsum(newc.to(torch.int32), 0)
    Mcl = cid[:, None] == cid[None, :]
    qdt = torch.float64 if dt == torch.float32 else dt
    eye = torch.eye(n, dtype=qdt, device=dev)

    def cluster_qr(Z, reg):
        Zq = Z.to(qdt)
        G = Zq.mT @ Zq
        Gm = torch.where(Mcl, G, torch.zeros((), dtype=qdt, device=dev)) \
            + reg * eye
        Lc, info = torch.linalg.cholesky_ex(Gm)
        # a failed factorization skips the orthonormalization rather than
        # poisoning Z; decided on the device
        ok = (info == 0) & torch.all(torch.isfinite(Lc))
        Lc = torch.where(ok, Lc, eye)
        return (Zq @ tri_inv_lower(Lc).mT).to(dt)

    Z = cluster_qr(Z.mT, 16 * n * eps).mT
    # second round from Rayleigh-refined shifts
    Z = _one_vec(d, e, _rayleigh_rows(d, e, Z) + jitter, Z, invit_steps)
    Z = cluster_qr(Z.mT, 16 * n * eps)
    Z = cluster_qr(Z, 0.0)

    # windowed modified Gram-Schmidt: subtract the projections on the
    # previous ortho_window vectors whose eigenvalues are close; worked
    # on the rows of Z^T, so each vector is contiguous
    wwin = min(ortho_window, max(n - 1, 1))
    starts = torch.clamp(idx - wwin, 0, max(n - wwin, 0))
    cols = starts[:, None] + torch.arange(wwin, device=dev)[None, :]
    close = torch.abs(w[cols] - w[:, None]) < 1e3 * eps ** 0.5 * tn1
    use = ((cols < idx[:, None]) & close).to(dt)               # (n, wwin)
    Zt = Z.mT.contiguous()
    for _ in range(ortho_passes):
        for j in range(n):
            s = min(max(j - wwin, 0), max(n - wwin, 0))
            Wr = Zt[s:s + wwin]
            zj = torch.addmv(Zt[j], Wr.mT, (Wr @ Zt[j]) * use[j], alpha=-1)
            nz = torch.linalg.vector_norm(zj)
            Zt[j] = zj / torch.where(nz == 0, torch.ones_like(nz), nz)
    Z = Zt.mT

    # final Rayleigh refinement, clamped to the bisection bracket
    w_ref = _rayleigh_rows(d, e, Zt)
    clamp = 256 * eps * tn1
    w_ref = torch.minimum(torch.maximum(w_ref, w - clamp), w + clamp)
    order = torch.argsort(w_ref)
    return w_ref[order], Z[:, order]


def tridiag_eig(d: torch.Tensor, e: torch.Tensor, invit_steps: int = 1,
                ortho_window: int = 8, ortho_passes: int = 2
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w, Z): the full eigendecomposition of the symmetric tridiagonal
    (d, e), w ascending, Z's columns the eigenvectors. The start vectors
    are standard normal from a generator seeded with 7, drawn on the CPU
    in d's dtype and moved to d's device."""
    n = d.shape[0]
    gen = torch.Generator().manual_seed(_SEED)
    b0 = torch.randn((n, n), generator=gen, dtype=d.dtype)
    return _tridiag_eig(d, e, b0.to(d.device), invit_steps, ortho_window,
                        ortho_passes)


def HermitianTridiagEig(d: torch.Tensor, e: torch.Tensor,
                        vectors: bool = True, backend: str = "jax"):
    """El-style driver (reference: HermitianTridiagEig.cpp). Only the
    batched solver above (the JAX package's backend "jax") is ported; the
    host C++ solver ("native") and the divide-and-conquer backends ("dc",
    "dc_device") wait for ROADMAP queue 1 item 8."""
    if backend != "jax":
        raise NotImplementedError(
            f"HermitianTridiagEig backend {backend!r} is not ported "
            "(ROADMAP queue 1 item 8)")
    if vectors:
        return tridiag_eig(d, e)
    return tridiag_eigvalsh(d, e)
