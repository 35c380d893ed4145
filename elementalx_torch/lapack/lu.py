"""LU factorization with partial (and full) pivoting, its solve, LUMod.

Counterpart of the single-device path of ``elementalx/lapack/lu.py``
(reference: src/lapack_like/factor/LU.cpp:47-98, factor/LU/Panel.hpp,
LU/Full.hpp, LU/SolveAfter.hpp, LU/Mod.hpp).

``LU`` keeps the structure of the JAX LU: rows stay in their physical
positions, each nb-wide panel is gathered into logical order and factored
as 512-wide sub-panels (``_lu_slab``), U12 goes to a separate buffer, the
trailing update runs over the full height, and one gather at the end
gives the packed layout. Every sub-panel goes through ``_getrf``: on a
CUDA tensor the K4 kernel (kernels/getrf.py) factors it whole with true
partial pivoting, at any height; on a CPU tensor the route is the JAX
package's CPU route (LAPACK getrf, the CALU tournament above
``_GETRF_CHUNK`` rows), so CPU parity is exact. Every product goes
through ``local_gemm`` and so, on the GPU, through K1.

Where the JAX code rebuilds a whole array functionally, the port writes in
place into buffers it owns; each such place says so.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..core.dmatrix import DistMatrix
from ..core.environment import Blocksize
from ..core.types import (
    LEFT,
    LOWER,
    MC,
    MR,
    NON_UNIT,
    NORMAL,
    Orientation,
    UNIT,
    UPPER,
)
from ..blas.gemm import local_gemm
from ..blas.trinv import tri_inv_lower_unit, tri_inv_upper
from ..blas.trsm import Trsm
from ..kernels.common import on_cuda
from ..kernels.getrf import lu_plain, packed_getrf
from .cholesky import _set_pad_diag
from .perm import Permutation

_LOW = (torch.bfloat16, torch.float16)

_LU_PANEL_BASE = 16

_SLAB_INNER = 512

# The JAX package routes panels taller than this through the CALU
# tournament, because XLA:TPU's getrf stages the whole panel in 16 MB of
# scoped VMEM (elementalx/lapack/lu.py:57-69). The port keeps the route on
# CPU tensors, where it mirrors the JAX CPU route; K4 has no height limit
# and takes CUDA panels whole.
_GETRF_CHUNK = 4096


def _swap_rows(a: torch.Tensor, i, j) -> torch.Tensor:
    """Swap rows i and j of ``a`` in place; returns ``a``."""
    a[[i, j]] = a[[j, i]]
    return a


def _nonzero_fill(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)[0]``."""
    idx = torch.nonzero(mask).flatten()[:size]
    pad = idx.new_full((size - idx.shape[0],), fill)
    return torch.cat([idx, pad])


def _getrf_flat(sub: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One getrf of a panel, ``(packed, lperm)``: K4 on a CUDA tensor,
    LAPACK on a CPU tensor (the JAX package's ``jax.lax.linalg.lu``)."""
    if on_cuda(sub):
        return packed_getrf(sub)
    return lu_plain(sub)


def _getrf_tall(sl: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tournament-pivoted LU of a very tall panel (Mt, w) — the CALU
    scheme (Grigori/Demmel/Xiang): factor each chunk of _GETRF_CHUNK
    rows, stack every chunk's w winning pivot rows, and factor the stack
    to elect the final pivot set; L for all rows is one product against
    inv(U). Threshold (not strict partial) pivoting. Returns (packed,
    lperm) with the _lu_slab contract."""
    Mt, w = sl.shape
    H = _GETRF_CHUNK
    if Mt <= H:
        return _getrf_flat(sl)
    nc = -(-Mt // H)
    Mp = nc * H
    slp = torch.cat([sl, sl.new_zeros((Mp - Mt, w))]) if Mp > Mt else sl
    cands = []
    for c in range(nc):
        _, cp = _getrf_flat(slp[c * H:(c + 1) * H])
        cands.append(cp[:w] + c * H)
    cand = torch.cat(cands)                               # (nc*w,)
    slu, sperm = _getrf_flat(slp[cand])
    win = cand[sperm]
    P = win[:w]
    # A padded zero row can only win over an exactly singular panel;
    # remap any winner >= Mt onto an unused real row so lperm stays a
    # permutation of [0, Mt).
    pad_win = P >= Mt
    inP0 = torch.zeros((Mp,), dtype=torch.bool, device=sl.device)
    inP0[P] = True
    free = _nonzero_fill(~inP0[:Mt], Mt, Mt - 1)
    repl = torch.clamp(torch.cumsum(pad_win.long(), 0) - 1, 0, Mt - 1)
    P = torch.where(pad_win, free[repl], P)
    U = torch.triu(slu[:w, :])
    # L for every row: A U^{-1} (unit on the pivot rows by construction)
    L_all = local_gemm(sl, tri_inv_upper(U))
    # winners first (tournament order), then the other real rows in
    # ascending order
    inP = torch.zeros((Mp,), dtype=torch.bool, device=sl.device)
    inP[P] = True
    rest = _nonzero_fill(~inP[:Mt], Mt - w, Mt - 1)
    lperm = torch.cat([P, rest])
    packed = torch.cat([slu[:w, :], L_all[rest]], dim=0)
    return packed, lperm


def _getrf(sub: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pivoted LU of one sub-panel, ``(packed, lperm)``. A CUDA tensor
    goes whole through K4 (true partial pivoting at any height); a CPU
    tensor takes the JAX package's CPU route: LAPACK up to _GETRF_CHUNK
    rows, the tournament above."""
    if on_cuda(sub):
        return packed_getrf(sub)
    if sub.shape[0] > _GETRF_CHUNK:
        return _getrf_tall(sub)
    return _getrf_flat(sub)


def _lu_slab(sl: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pivoted LU of a tall slab (Mt x w), built from _SLAB_INNER-wide
    sub-panels with slab-confined updates. Returns the packed slab factor
    (rows in pivoted order) and the composed row permutation ``lperm``
    (logical -> original slab row). ``sl`` is overwritten with the factor
    (the JAX code rebuilds the slab each step; LU passes it a fresh
    gather)."""
    Mt, w = sl.shape
    ib = _SLAB_INNER
    if w <= ib or w % ib != 0:
        return _getrf(sl)
    rm = torch.arange(Mt, device=sl.device)
    for t in range(w // ib):
        j0 = t * ib
        lu, lp = _getrf(sl[j0:, j0:j0 + ib])
        # physically reorder the slab tail and record the order
        sl[j0:] = sl[j0:][lp]
        rm[j0:] = rm[j0:][lp]
        sl[j0:, j0:j0 + ib] = lu
        if w - j0 - ib <= 0:
            continue
        inv11 = tri_inv_lower_unit(lu[:ib, :])
        U12 = local_gemm(inv11, sl[j0:j0 + ib, j0 + ib:])
        sl[j0:j0 + ib, j0 + ib:] = U12
        sl[j0 + ib:, j0 + ib:] -= local_gemm(lu[ib:, :], U12)
    return sl, rm


def _apply_pivots(blk: torch.Tensor, pivots: torch.Tensor, k0j: int,
                  w: int) -> torch.Tensor:
    """Apply the recorded swap sequence (row jc <-> pivots[jc] for jc in
    [k0j, k0j+w), in order) to a row block, in place."""
    for jc in range(k0j, k0j + w):
        _swap_rows(blk, jc, int(pivots[jc]))
    return blk


def _lu_panel(a: torch.Tensor, perm: torch.Tensor, k0: int, nb: int, m: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pivoted factorization of columns [k0, k0+nb) over rows >= k0 with
    one getrf of the row slice (reference: LU/Panel.hpp:68-158); the
    composed local permutation is applied to the full width in one
    gather. Returns new (a, perm). (Used by the conformance test; LU keeps
    rows in physical positions.)"""
    sl = a[k0:, k0:k0 + nb]
    low = a.dtype in _LOW
    lu, lperm = _getrf_flat(sl.float() if low else sl)
    a = a.clone()
    perm = perm.clone()
    a[k0:] = a[k0:][lperm]
    perm[k0:] = perm[k0:][lperm]
    a[k0:, k0:k0 + nb] = lu.to(a.dtype)
    return a, perm


def _lu_panel_loop(a: torch.Tensor, perm: torch.Tensor, k0: int, nb: int,
                   m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-level blocked column-by-column panel (the JAX package's
    fori_loop fallback). Returns new (a, perm)."""
    M = a.shape[0]
    dev, dt = a.device, a.dtype
    panel = a[:, k0:k0 + nb].clone()
    pivots = torch.arange(M, device=dev)
    perm = perm.clone()
    ib = _LU_PANEL_BASE if nb % _LU_PANEL_BASE == 0 else nb
    rows = torch.arange(M, device=dev)
    pcols = torch.arange(nb, device=dev)
    pc_ib = torch.arange(ib, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)

    for t in range(nb // ib):
        j0 = t * ib
        sub = panel[:, j0:j0 + ib].clone()
        for j in range(ib):
            jc = k0 + j0 + j
            col = sub[:, j]
            allowed = (rows >= jc) & ((rows < m) | (rows == jc))
            mag = torch.where(allowed, col.abs(), -1.0)
            p = int(torch.argmax(mag))
            _swap_rows(sub, jc, p)
            pivots[jc] = p
            _swap_rows(perm, jc, p)
            col = sub[:, j]
            diag = col[jc]
            safe = torch.where(diag == 0, one, diag)
            below = rows > jc
            l = torch.where(below, col / safe, zero)
            sub[:, j] = torch.where(below, l, col)
            urow = sub[jc]
            sub -= torch.outer(l, torch.where(pc_ib > j, urow, zero))
        # replay this block's swaps on the whole panel, then restore the
        # factored sub (overwriting the doubly-swapped block)
        _apply_pivots(panel, pivots, k0 + j0, ib)
        panel[:, j0:j0 + ib] = sub
        # U12 := inv(L11) A12 on the panel's remaining columns
        L11 = panel[k0 + j0:k0 + j0 + ib, j0:j0 + ib]
        Arow = panel[k0 + j0:k0 + j0 + ib, :]
        U12f = torch.linalg.solve_triangular(L11, Arow, upper=False,
                                             unitriangular=True)
        right = (pcols >= j0 + ib)[None, :]
        U12 = torch.where(right, U12f, Arow)
        panel[k0 + j0:k0 + j0 + ib, :] = U12
        below = (rows >= k0 + j0 + ib)[:, None]
        L21 = torch.where(below, panel[:, j0:j0 + ib], zero)
        panel = panel - local_gemm(L21, torch.where(right, U12, zero))
    # replay the swap sequence across the full width, then overwrite the
    # panel columns with the factored (already-swapped) panel
    a = _apply_pivots(a.clone(), pivots, k0, nb)
    a[:, k0:k0 + nb] = panel
    return a, perm


def LU(A: DistMatrix, blocksize: Optional[int] = None
       ) -> Tuple[DistMatrix, Permutation]:
    """Partially-pivoted LU: returns (packed LU, P) with P A = L U, unit L
    below the diagonal (reference: LU.cpp:47-98)."""
    with trace.span("lapack.LU", A.device):
        return _lu(A, blocksize)


def _lu(A: DistMatrix, blocksize: Optional[int]
        ) -> Tuple[DistMatrix, Permutation]:
    Am = A.redistribute(MC, MR)
    a = Am.data.clone()  # the factor is built in this buffer, in place
    M, N = a.shape
    m = min(A.m, A.n)
    nb = blocksize or Blocksize()
    if blocksize is None and A.grid.size == 1 and M >= 2048:
        # the JAX LU's wide panels for one device (measured on a TPU
        # v5e, elementalx/lapack/lu.py:340-345), kept until the H100 is
        # measured
        nb = max(nb, 1024)
    nb = max(1, min(nb, M))
    while M % nb != 0:
        nb -= 1
    _set_pad_diag(a, m, 1)  # pad diagonal to 1 so padding panels are trivial
    nblk = (m + nb - 1) // nb
    low = a.dtype in _LOW
    rowmap = torch.arange(M, device=a.device)
    # Rows stay in their PHYSICAL positions; `rowmap` tracks logical ->
    # physical order. U12 block-rows go in logical order into `uout`; the
    # panel columns' factor stays scattered at physical rows in `a`, and
    # one gather at the end stitches the two together
    # (elementalx/lapack/lu.py:358-398).
    uout = torch.zeros_like(a)
    for k in range(nblk):
        k0 = k * nb
        with trace.span("lapack.lu.slab"):
            tail = rowmap[k0:]
            cols = a[:, k0:k0 + nb]
            sl = cols[tail]
            lu, lperm = _lu_slab(sl.float() if low else sl)
            lu = lu.to(a.dtype)
            tail = tail[lperm]
            rowmap[k0:] = tail
            cols[tail] = lu  # in place, where the JAX code rebuilds `a`
        if N - k0 - nb <= 0:
            continue
        with trace.span("lapack.lu.update"):
            # batched log-depth inversion (blas/trinv.py)
            inv11 = tri_inv_lower_unit(lu[:nb, :])
            right = a[:, k0 + nb:]
            U12 = local_gemm(inv11, right[tail[:nb]])
            uout[k0:k0 + nb, k0 + nb:] = U12
            Lphys = a.new_zeros((M, nb))
            Lphys[tail[nb:]] = lu[nb:, :]
            # the full-height trailing update (about 1.5x the flops of a
            # right-looking one, elementalx/lapack/lu.py:369-370), in place
            right -= local_gemm(Lphys, U12)
    with trace.span("lapack.lu.gather"):
        a = a[rowmap]
        # overlay the logical-order U12 block-rows, in place of the JAX
        # code's (M, N) where
        for k in range(nblk):
            k0 = k * nb
            a[k0:k0 + nb, k0 + nb:] = uout[k0:k0 + nb, k0 + nb:]
        _set_pad_diag(a, m, 0)  # restore the zero padding diagonal
        a[A.m:, :] = 0
        a[:, A.n:] = 0
    return Am.with_data(a), Permutation(rowmap, A.m)


def LUFullPiv(A: DistMatrix, blocksize: Optional[int] = None
              ) -> Tuple[DistMatrix, Permutation, Permutation]:
    """Fully-pivoted LU, P A Q^T = L U (reference: LU/Full.hpp): unblocked
    with a global MaxAbsLoc per step."""
    Am = A.redistribute(MC, MR)
    a = Am.data.clone()  # factored in place
    M, N = a.shape
    m = min(A.m, A.n)
    dev, dt = a.device, a.dtype
    _set_pad_diag(a, m, 1)
    i2 = torch.arange(M, device=dev)[:, None]
    j2 = torch.arange(N, device=dev)[None, :]
    rowsv = torch.arange(M, device=dev)
    colsv = torch.arange(N, device=dev)
    rp = torch.arange(M, device=dev)
    cp = torch.arange(N, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    for k in range(m):
        act = (i2 >= k) & (j2 >= k) & (i2 < m) & (j2 < m)
        flat = int(torch.argmax(torch.where(act, a.abs(), -1.0)))
        pi, pj = flat // N, flat % N
        _swap_rows(a, k, pi)
        _swap_rows(a.mT, k, pj)
        _swap_rows(rp, k, pi)
        _swap_rows(cp, k, pj)
        col = a[:, k].clone()
        diag = col[k]
        safe = torch.where(diag == 0, one, diag)
        below = rowsv > k
        l = torch.where(below, col / safe, zero)
        a[:, k] = torch.where(below, l, col)
        u = torch.where(colsv > k, a[k], zero)
        a -= torch.outer(l, u)
    _set_pad_diag(a, m, 0)
    a[A.m:, :] = 0
    a[:, A.n:] = 0
    return Am.with_data(a), Permutation(rp, A.m), Permutation(cp, A.n)


@trace.traced("lapack.SolveAfter")
def SolveAfter(orientation: Orientation, LUpacked: DistMatrix,
               P: Permutation, B: DistMatrix) -> DistMatrix:
    """Solve A X = B given P A = L U (reference: LU/SolveAfter.hpp)."""
    if orientation == NORMAL:
        Pb = P.apply_rows(B.redistribute(MC, MR))
        Y = Trsm(LEFT, LOWER, NORMAL, UNIT, 1.0, LUpacked, Pb)
        return Trsm(LEFT, UPPER, NORMAL, NON_UNIT, 1.0, LUpacked, Y)
    # A^T X = B  =>  U^T L^T P X = B
    Y = Trsm(LEFT, UPPER, orientation, NON_UNIT, 1.0, LUpacked, B)
    Z = Trsm(LEFT, LOWER, orientation, UNIT, 1.0, LUpacked, Y)
    return P.apply_rows(Z.redistribute(MC, MR), inverse=True)


@trace.traced("lapack.LinearSolve")
def LinearSolve(A: DistMatrix, B: DistMatrix,
                blocksize: Optional[int] = None) -> DistMatrix:
    """General solve via pivoted LU (reference: solve/Linear.cpp)."""
    F, P = LU(A, blocksize)
    return SolveAfter(NORMAL, F, P, B)


def LUMod(F: DistMatrix, P: Permutation, u, v, conjugate: bool = True,
          tau: float = 0.1) -> Tuple[DistMatrix, Permutation]:
    """Rank-one update of a partially-pivoted LU factorization:
    given P A = L U, produce P' (A + u v^H) = L' U'
    (reference: factor/LU/Mod.hpp — the Schwetlick-Kielbasinski update
    with threshold-tau pairwise pivoting).

    Two O(m) sweeps of pairwise row eliminations on explicit L and U,
    each step computing both the pivoting and the non-pivoting branch and
    selecting one, as the JAX package does. L and U are updated in place.
    Requires square-or-wide A (height <= width), as in the reference."""
    m, n = F.m, F.n
    if m > n:
        raise ValueError("LUMod assumes height(A) <= width(A) (Mod.hpp)")
    minDim = m
    Fm = F.redistribute(MC, MR)
    d = Fm.data
    Mp, Np = d.shape
    dev, dt = d.device, d.dtype
    rows = torch.arange(Mp, device=dev)
    cols = torch.arange(Np, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    i2 = rows[:, None]
    j2 = rows[None, :]
    L = torch.where(i2 > j2, d[:, :Mp], zero)
    L = torch.where(i2 == j2, one, L)
    U = torch.triu(d)
    uvec = torch.zeros((Mp,), dtype=dt, device=dev)
    uvec[:m] = torch.as_tensor(np.asarray(u)).to(dev, dt).ravel()[:m]
    vvec = torch.zeros((Np,), dtype=dt, device=dev)
    vvec[:n] = torch.as_tensor(np.asarray(v)).to(dev, dt).ravel()[:n]
    if conjugate:
        vvec = vvec.conj().resolve_conj()
    perm = P.perm.clone()

    # w := inv(L) P u
    w = torch.linalg.solve_triangular(L, uvec[perm][:, None], upper=False,
                                      unitriangular=True)[:, 0]
    usub = torch.zeros((Mp,), dtype=dt, device=dev)

    def _safe(a, b):
        return a / torch.where(b == 0, one, b)

    def _pair_step(w_i, w_ip1, lam_sub, ups_ii, ups_sub, i, pivot, sweep1):
        """Shared pivot/no-pivot elimination on (L, U) for rows (i, i+1),
        in place. Returns (new_w_i, new_usub_i)."""
        below = rows > i + 1
        right = cols > i
        li, lip1 = L[:, i].clone(), L[:, i + 1].clone()
        ui, uip1 = U[i].clone(), U[i + 1].clone()

        # ---------------- no-pivot branch ----------------
        gamma_np = _safe(w_ip1, w_i) if sweep1 else _safe(ups_sub, ups_ii)
        li_np = (li + gamma_np * torch.where(below, lip1, zero)
                 + gamma_np * torch.where(rows == i + 1, one, zero))
        uip1_np = uip1 - gamma_np * torch.where(right, ui, zero)
        usub_np = -gamma_np * ups_ii if sweep1 else zero
        wi_np = w_i

        # ---------------- pivot branch ----------------
        gamma_p = _safe(w_i, w_ip1) if sweep1 else _safe(ups_ii, ups_sub)
        lam_ii = 1.0 + gamma_p * lam_sub
        li_sw = torch.where(below, lip1 + gamma_p * li, zero)
        lip1_sw = torch.where(below, li, zero)
        ui_new = torch.where(right, uip1, zero)
        uip1_new = torch.where(right, ui - gamma_p * uip1, zero)
        eta = _safe(lam_sub, lam_ii)
        delta_i = lam_ii
        delta_ip1 = 1.0 - eta * gamma_p
        lip1_f = _safe(lip1_sw - eta * li_sw, delta_ip1)
        li_f = _safe(li_sw, delta_i)
        li_f = torch.where(rows == i, one, li_f)
        li_f = torch.where(rows == i + 1, _safe(gamma_p, delta_i), li_f)
        lip1_f = torch.where(rows == i + 1, one, lip1_f)
        ui_f = (ui_new + eta * uip1_new) * delta_i
        uip1_f = uip1_new * delta_ip1
        diag_val = eta * ups_ii * delta_i if sweep1 else ups_sub * delta_i
        ui_f = torch.where(cols == i, diag_val, ui_f)
        usub_p = ups_ii * delta_ip1 if sweep1 else zero
        wi_p = w_ip1 * delta_i

        # ---------------- select ----------------
        L[:, i] = torch.where(pivot, li_f, li_np)
        L[:, i + 1] = torch.where(pivot, lip1_f, lip1)
        # swap the strictly-left L rows when pivoting
        lrow_i, lrow_ip1 = L[i].clone(), L[i + 1].clone()
        left = pivot & (rows < i)
        L[i] = torch.where(left, lrow_ip1, lrow_i)
        L[i + 1] = torch.where(left, lrow_i, lrow_ip1)
        U[i] = torch.where(pivot, ui_f, ui)
        U[i + 1] = torch.where(pivot, uip1_f, uip1_np)
        return (torch.where(pivot, wi_p, wi_np),
                torch.where(pivot, usub_p, usub_np))

    def _swap_if(pivot, i):
        swapped = perm.clone()
        _swap_rows(swapped, i, i + 1)
        perm.copy_(torch.where(pivot, swapped, perm))

    # ---- sweep 1: reduce w to a multiple of e0 (i = minDim-2 .. 0) ----
    for t in range(max(minDim - 1, 0)):
        i = minDim - 2 - t
        lam_sub, ups_ii = L[i + 1, i].clone(), U[i, i].clone()
        w_i, w_ip1 = w[i].clone(), w[i + 1].clone()
        pivot = w_i.abs() < tau * (lam_sub * w_i + w_ip1).abs()
        wi_new, usub_i = _pair_step(w_i, w_ip1, lam_sub, ups_ii, zero, i,
                                    pivot, True)
        w[i] = wi_new
        w[i + 1] = 0
        usub[i] = usub_i
        _swap_if(pivot, i)

    # ---- add w[0] v^H into row 0 of U ----
    U[0, :] += w[0] * vvec

    # ---- sweep 2: Hessenberg -> triangular (i = 0 .. minDim-2) ----
    for i in range(max(minDim - 1, 0)):
        lam_sub, ups_ii = L[i + 1, i].clone(), U[i, i].clone()
        ups_sub = usub[i].clone()
        pivot = ups_ii.abs() < tau * (lam_sub * ups_ii + ups_sub).abs()
        _pair_step(zero, zero, lam_sub, ups_ii, ups_sub, i, pivot, False)
        _swap_if(pivot, i)

    # repack: unit-L strictly below the diagonal + U
    packed = U.clone()
    packed[:, :Mp] += torch.where(i2 > j2, L, zero)
    out = Fm.with_data(Fm.mask_padding(packed))
    return out, Permutation(perm, F.m)
