"""Householder QR.

Counterpart of ``elementalx/lapack/qr.py`` (reference:
src/lapack_like/factor/QR/): blocked Householder panels
(PanelHouseholder.hpp) with compact-WY T matrices, applied through
ApplyPackedReflectors; Cholesky-QR; TSQR (QR/TS.hpp); column-pivoted
Businger-Golub; explicit Q formation.

As in the JAX driver, a float32 (or bfloat16) panel at least 192 wide
is factored by CholeskyQR2 with a Householder reconstruction
(``_panel_cholqr``): its tall work is products through ``local_gemm``
(K1 on CUDA tensors). A runtime predicate sends an ill-conditioned panel
to LAPACK-style geqrf (``_geqrf_slab``): the JAX package decides inside
``lax.cond``; here it is a Python branch, one host synchronisation per
panel. ``cholqr_panels`` counts the panels each way. The b x b Cholesky
and LU factors and geqrf are ``torch.linalg`` calls, as they are XLA ops
outside any Pallas kernel in the JAX package.

QR keeps the compact-WY T that each panel's trailing update applied, and
ApplyQ applies Q or Q^H panel by panel with those T's at the factor's
width; it builds a T (``build_wy_T``, a batched triangular inversion)
only for a panel that had no trailing update. ``applyq_blocks`` counts
the blocks each way. A factorization without stored T's (``from_reference``,
``ColPivQR``) or an explicit ``blocksize`` takes ApplyPackedReflectors,
which builds a T for every block.

Spans (``trace.py``): ``lapack.QR`` and ``lapack.ApplyQ`` (device-timed);
inside QR, ``lapack.qr.panel`` a panel, ``lapack.qr.geqrf`` a panel sent
to geqrf, ``lapack.qr.predicate`` the host's read of the CholeskyQR2
predicate (a wait on the device) and ``lapack.qr.update`` a trailing
update.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..blas.gemm import local_gemm
from ..blas.level1 import GetSubmatrix, MakeTrapezoidal
from ..core.dmatrix import DistMatrix, pad_array
from ..core.environment import Blocksize
from ..core.grid import Grid
from ..core.types import MC, MR, STAR, UPPER
from .perm import Permutation
from .reflect import (
    ApplyPackedReflectors,
    apply_block_reflector,
    build_wy_T,
    extract_panel_V,
    householder,
)

_LOW = (torch.bfloat16, torch.float16)


def tau_from_reference(tau: np.ndarray, length: int,
                       grid: Optional[Grid] = None) -> torch.Tensor:
    """A JAX package tau vector (padded to its grid's quantum) cut or
    zero-extended to ``length`` on the port's grid."""
    g = grid or Grid.default()
    t = np.asarray(tau)[:length]
    t = np.concatenate([t, np.zeros(length - t.shape[0], t.dtype)])
    return torch.as_tensor(t, device=g.device)


class QRFactorization(NamedTuple):
    """Packed result: R in the upper triangle of ``packed``; Householder
    vectors below the diagonal; tau per reflector (reference: El::qr
    returns householder-packed A plus t and d)."""

    packed: DistMatrix
    tau: torch.Tensor
    #: the compact-WY T of each ``panel_width``-wide panel, as its trailing
    #: update applied it (None for a panel without one); None where the
    #: factorization was not made by ``QR``
    panel_T: Optional[Tuple[Optional[torch.Tensor], ...]] = None
    panel_width: Optional[int] = None

    @staticmethod
    def from_reference(packed: np.ndarray, tau: np.ndarray, m: int, n: int,
                       grid: Optional[Grid] = None) -> "QRFactorization":
        """The port's factorization for a JAX package QRFactorization,
        given its packed data and tau read through numpy and the logical
        m x n; tau is cut to the port's padded width."""
        P = DistMatrix.from_reference(packed, m, n, grid=grid)
        return QRFactorization(P, tau_from_reference(tau, P.data.shape[1],
                                                     grid))


_QR_INNER = 16

# The JAX package's panel policy, carried unchanged: CholeskyQR2 panels take
# over from geqrf at this width for f32/bf16 (measured on a TPU v5e, where
# the geqrf custom call was the slow part; not re-measured on the H100).
_CHOLQR_MIN_NB = 192
# square-ish trailing corners are where cond(panel) breaks the CholeskyQR
# predicate, and their geqrf area is small: they skip the attempt
_CHOLQR_MIN_ASPECT = 4

#: panels of the CholeskyQR2 route since the last reset: "fast" (the
#: reconstruction accepted), "slow" (the predicate failed: geqrf) and
#: "short" (fewer than 4 nb rows: geqrf without the attempt)
cholqr_panels = {"fast": 0, "slow": 0, "short": 0}

#: blocks ApplyQ applied since the last reset: "stored" (with the T that
#: QR kept for the panel) and "rebuilt" (with a T built for the block)
applyq_blocks = {"stored": 0, "rebuilt": 0}


def _use_cholqr_panels(dtype: torch.dtype, nb: int) -> bool:
    """CholeskyQR2 panels for float32/bfloat16 at nb >= 192, unless
    ELEMENTALX_QR_PANEL=geqrf (the JAX package's switch, read at call
    time)."""
    if os.environ.get("ELEMENTALX_QR_PANEL", "") == "geqrf":
        return False
    return dtype in (torch.float32, torch.bfloat16) and nb >= _CHOLQR_MIN_NB


def _geqrf_slab(s: torch.Tensor, nb: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """geqrf of an (Mt, nb) slice -> (packed slab, tau, T): R on and above
    the diagonal, the unit-lower reflectors below it, and the forward
    compact-WY T of those reflectors."""
    pk, tau = torch.geqrf(s)
    return pk, tau, build_wy_T(extract_panel_V(pk, 0, pk.shape[1]), tau)


def _panel_cholqr(a: torch.Tensor, tau: torch.Tensor, k0: int, nb: int,
                  m: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Panel [k0, k0+nb) by CholeskyQR2 and a Householder reconstruction
    (TSQR-HR, Ballard et al.; CholeskyQR2, Yamamoto et al.), the panel
    contract of ``_panel_qr``:

      1. G1 = A1^T A1; R1 = chol(G1 + shift); Q1 = A1 R1^{-1}
      2. G2 = Q1^T Q1; R2 = chol(G2); R = R2 R1
      3. with the sign scaling S (s_i = -sign(q_ii)), the unpivoted LU
         Q S - E1 = V W gives the unit-lower V whose reflectors reproduce
         Q: T = -W V1^{-H}, tau_i = -W_ii, V2 = Q1[b:] R2^{-1} S W^{-1}.

    The predicate (pass-1 orthogonality below 0.25, both Cholesky factors
    complete, identity LU pivots, finite results, tau in the Householder
    range) is read on the host; a panel that fails it is factored by
    geqrf. ``torch.linalg.lu_factor_ex`` reports LAPACK's 1-based pivots,
    so the identity is 1..nb (the JAX package's ``lax.linalg.lu`` gives a
    0-based permutation). Writes the slab and tau into ``a`` and ``tau``,
    the caller's working copies, and returns (a, tau, T) with T the
    panel's compact-WY factor."""
    from ..blas.trinv import tri_inv_lower_unit, tri_inv_upper

    M = a.shape[0]
    Mt = M - k0
    sl = a[k0:, k0:k0 + nb]
    low = a.dtype in _LOW
    s32 = sl.float() if low else sl
    if Mt < _CHOLQR_MIN_ASPECT * nb:
        with trace.span("lapack.qr.geqrf"):
            pk, tnew, T = _geqrf_slab(s32, nb)
        cholqr_panels["short"] += 1
    else:
        dev = a.device
        eps = torch.finfo(torch.float32).eps
        eye = torch.eye(nb, dtype=s32.dtype, device=dev)
        G1 = local_gemm(s32.mT, s32)
        shift = (100.0 * nb * eps) * torch.max(torch.abs(torch.diagonal(G1)))
        L1, info1 = torch.linalg.cholesky_ex(G1 + shift * eye)
        R1 = L1.mT
        Q1 = local_gemm(s32, tri_inv_upper(R1))
        G2 = local_gemm(Q1.mT, Q1)
        ortho_err = torch.max(torch.abs(G2 - eye))
        L2, info2 = torch.linalg.cholesky_ex(G2)
        R2inv = tri_inv_upper(L2.mT)
        R = torch.triu(local_gemm(L2.mT, R1))
        Q_top = local_gemm(Q1[:nb], R2inv)
        qd = torch.diagonal(Q_top)
        s = torch.where(qd >= 0, -torch.ones_like(qd), torch.ones_like(qd))
        lu1, piv, _ = torch.linalg.lu_factor_ex(Q_top * s[None, :] - eye)
        ident = torch.all(piv == torch.arange(1, nb + 1, dtype=piv.dtype,
                                              device=dev))
        W = torch.triu(lu1)
        V1 = torch.tril(lu1, -1)
        tau_new = -torch.diagonal(W)
        V2 = local_gemm(Q1[nb:], local_gemm(R2inv * s[None, :],
                                            tri_inv_upper(W)))
        Rt = s[:, None] * R
        ok = ((ortho_err < 0.25) & ident & (info1 == 0) & (info2 == 0)
              & torch.all(torch.isfinite(Rt)) & torch.all(torch.isfinite(V2))
              & torch.all(torch.abs(tau_new) > 0.5))
        with trace.span("lapack.qr.predicate"):
            accepted = bool(ok)
        if accepted:
            r2 = torch.arange(nb, device=dev)[:, None]
            c2 = torch.arange(nb, device=dev)[None, :]
            pk = torch.cat([torch.where(r2 > c2, V1, Rt), V2], dim=0)
            tnew = tau_new
            T = -local_gemm(W, tri_inv_lower_unit(V1).mH)
            cholqr_panels["fast"] += 1
        else:
            with trace.span("lapack.qr.geqrf"):
                pk, tnew, T = _geqrf_slab(s32, nb)
            cholqr_panels["slow"] += 1
    if low:
        pk, T = pk.to(a.dtype), T.to(a.dtype)
    a[k0:, k0:k0 + nb] = pk
    tau[k0:k0 + nb] = tnew.to(tau.dtype)
    return a, tau, T


def _panel_qr(a: torch.Tensor, tau: torch.Tensor, k0: int, nb: int, m: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Householder factorization of columns [k0, k0+nb) (reference:
    QR/PanelHouseholder.hpp): geqrf of the row slice [k0, M), as the JAX
    package calls XLA's geqrf (LAPACK's v below the diagonal, unit
    implicit, H = I - tau v v^H). Padding rows hold zeros, so they add
    nothing to the reflector norms. Writes into ``a`` and ``tau``."""
    low = a.dtype in _LOW
    sl = a[k0:, k0:k0 + nb]
    pk, tnew = torch.geqrf(sl.float() if low else sl)
    a[k0:, k0:k0 + nb] = pk.to(a.dtype)
    tau[k0:k0 + nb] = tnew.to(tau.dtype)
    return a, tau


def _panel_qr_loop(a: torch.Tensor, tau: torch.Tensor, k0: int, nb: int,
                   m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-level blocked panel without geqrf: inner blocks of width ib,
    each an unblocked Householder pass on an (M, ib) sub-slice followed by
    one compact-WY application to the rest of the panel. Writes into
    ``a`` and ``tau``."""
    M = a.shape[0]
    dev = a.device
    panel = a[:, k0:k0 + nb].clone()
    ib = _QR_INNER if nb % _QR_INNER == 0 else nb
    rows = torch.arange(M, device=dev)
    scols = torch.arange(ib, device=dev)
    pcols = torch.arange(nb, device=dev)
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    for t in range(nb // ib):
        j0 = t * ib
        sub = panel[:, j0:j0 + ib].clone()
        for j in range(ib):
            jc = k0 + j0 + j
            x = sub[:, j].clone()
            v, tj, beta = householder(x, jc, m)
            tau[jc] = tj
            Pm = torch.where((scols > j)[None, :], sub, zero)
            wv = local_gemm(v.conj()[None, :], Pm)  # (1, ib)
            sub = sub - tj * torch.outer(v, wv[0])
            newcol = torch.where(rows > jc, v, x)
            if jc < M:
                newcol[jc] = beta
            sub[:, j] = newcol
        panel[:, j0:j0 + ib] = sub
        # compact-WY application of this block to the rest of the panel
        V = extract_panel_V(sub, 0, ib, offset=k0 + j0)
        T = build_wy_T(V, tau[k0 + j0:k0 + j0 + ib])
        right = (pcols >= j0 + ib)[None, :]
        upd = apply_block_reflector(V, T, torch.where(right, panel, zero),
                                    adjoint=True)
        panel = torch.where(right, upd, panel)
    a[:, k0:k0 + nb] = panel
    return a, tau


def _qr_packed(a: torch.Tensor, m: int, n: int, nb: int
               ) -> Tuple[torch.Tensor, torch.Tensor,
                          Tuple[Optional[torch.Tensor], ...]]:
    """Blocked Householder QR of the padded data (a new tensor; ``a`` is
    not written). Panels are uniformly nb wide; each trailing update is
    one compact-WY application to the exact (M-k0, N-k0-w) slice.
    Returns (a, tau, the T each panel's trailing update applied, None for
    a panel without one)."""
    M, N = a.shape
    ncols = min(m, n)
    a = a.clone(memory_format=torch.contiguous_format)
    tau = torch.zeros((N,), dtype=a.dtype, device=a.device)
    cholqr = _use_cholqr_panels(a.dtype, nb)
    panel_T = []
    k0 = 0
    while k0 < ncols:
        w = min(nb, ncols - k0)
        T = None
        with trace.span("lapack.qr.panel"):
            if cholqr and w >= _CHOLQR_MIN_NB:
                a, tau, T = _panel_cholqr(a, tau, k0, w, m)
            else:
                with trace.span("lapack.qr.geqrf"):
                    a, tau = _panel_qr(a, tau, k0, w, m)
        if k0 + w < N:
            with trace.span("lapack.qr.update"):
                V = extract_panel_V(a, k0, w)[k0:]
                if T is None:
                    T = build_wy_T(V, tau[k0:k0 + w])
                a[k0:, k0 + w:] = apply_block_reflector(
                    V, T, a[k0:, k0 + w:], adjoint=True)
        else:
            T = None
        panel_T.append(T)
        k0 += w
    return a, tau, tuple(panel_T)


def QR(A: DistMatrix, blocksize: Optional[int] = None) -> QRFactorization:
    """Householder QR of an m x n matrix (reference: QR.cpp driver)."""
    with trace.span("lapack.QR", A.device):
        return _qr(A, blocksize)


def _qr(A: DistMatrix, blocksize: Optional[int]) -> QRFactorization:
    Am = A.redistribute(MC, MR)
    nb = blocksize or Blocksize()
    if blocksize is None and A.grid.size == 1 and min(A.m, A.n) >= 2048:
        # the JAX driver's panel-width knees, measured on a TPU v5e
        # (nb=256 from 2048, 512 from 8192 with cholqr panels); carried
        # unchanged until the H100 is measured
        nb = max(nb, 512 if (min(A.m, A.n) >= 8192
                             and _use_cholqr_panels(Am.dtype, 512))
                 else 256)
    a, tau, panel_T = _qr_packed(Am.data, A.m, A.n, nb)
    return QRFactorization(Am.with_data(Am.mask_padding(a)), tau, panel_T,
                           nb)


def ApplyQ(orientation_adjoint: bool, fact: QRFactorization, B: DistMatrix,
           blocksize: Optional[int] = None) -> DistMatrix:
    """B := Q B or Q^H B (reference: qr::ApplyQ via
    ApplyPackedReflectors): with the T's QR kept, panel by panel at the
    factor's width, unless ``blocksize`` asks for blocks of its own."""
    with trace.span("lapack.ApplyQ", B.device):
        packed = fact.packed
        Bm = B.redistribute(MC, MR)
        ncols = min(packed.m, packed.n)
        if blocksize is None and fact.panel_T is not None:
            out = _apply_stored(packed.data, fact.tau, fact.panel_T,
                                fact.panel_width, Bm.data, ncols,
                                orientation_adjoint)
        else:
            nb = blocksize or Blocksize()
            out = ApplyPackedReflectors(packed.data, fact.tau, Bm.data, nb,
                                        ncols, adjoint=orientation_adjoint)
            applyq_blocks["rebuilt"] += -(-ncols // nb)
        return Bm.with_data(Bm.mask_padding(out))


def _apply_stored(packed: torch.Tensor, tau: torch.Tensor,
                  panel_T: Tuple[Optional[torch.Tensor], ...], nb: int,
                  A: torch.Tensor, ncols: int, adjoint: bool
                  ) -> torch.Tensor:
    """ApplyPackedReflectors at the factor's panel width nb, each panel
    applied with its stored T (built only where the panel has none).
    Returns a new tensor; A is not written."""
    A = A.clone()
    order = range(len(panel_T))
    for b in (order if adjoint else reversed(order)):
        k0 = b * nb
        w = min(nb, ncols - k0)
        V = extract_panel_V(packed[k0:, k0:], 0, w)
        T = panel_T[b]
        if T is None:
            T = build_wy_T(V, tau[k0:k0 + w])
            applyq_blocks["rebuilt"] += 1
        else:
            applyq_blocks["stored"] += 1
        A[k0:] = apply_block_reflector(V, T, A[k0:], adjoint)
    return A


def ExplicitQR(A: DistMatrix, blocksize: Optional[int] = None,
               thin: bool = True) -> Tuple[DistMatrix, DistMatrix]:
    """(Q, R) with Q m x min(m,n) (thin) or m x m (reference:
    qr::Explicit)."""
    fact = QR(A, blocksize)
    packed = fact.packed
    m, n = packed.m, packed.n
    k = min(m, n)
    M = packed.data.shape[0]
    qcols = k if thin else m
    eye = torch.eye(M, M, dtype=packed.dtype, device=packed.device)
    nb = blocksize or Blocksize()
    Qfull = ApplyPackedReflectors(packed.data, fact.tau, eye, nb, k,
                                  adjoint=False)
    Qdm = DistMatrix.from_padded(Qfull[:, :max(qcols, 1)], m, qcols, MC, MR,
                                 packed.grid, packed.wrap).canonical()
    R = MakeTrapezoidal(UPPER, packed)
    if thin:
        R = GetSubmatrix(R, slice(0, k), slice(0, n))
    return Qdm, R


def CholeskyQR(A: DistMatrix) -> Tuple[DistMatrix, DistMatrix]:
    """Tall-skinny QR via A^H A = R^H R (reference: QR/Cholesky.hpp)."""
    from ..blas.gemm import Gemm
    from ..blas.trsm import Trsm
    from ..core.types import ADJOINT, NON_UNIT, NORMAL, RIGHT
    from .cholesky import Cholesky

    G = Gemm(ADJOINT, NORMAL, 1.0, A, A)
    R = Cholesky(UPPER, G)
    Q = Trsm(RIGHT, UPPER, NORMAL, NON_UNIT, 1.0, R, A)
    return Q, R


def TSQR(A: DistMatrix) -> Tuple[DistMatrix, DistMatrix]:
    """Tall-skinny QR with a tree reduction over the grid's rows
    (reference: QR/TS.hpp:14-316): a local QR per row block, a QR of the
    stacked R factors, and Q as one local product per block. The port's
    grid has one row, so the tree has one leaf: ``torch.linalg.qr`` (the
    JAX package's ``jnp.linalg.qr``) and a QR of its N x N R."""
    g = A.grid
    a = A.redistribute(MC, STAR).data
    N = a.shape[1]
    q1, r1 = torch.linalg.qr(a, mode="reduced")
    q2, r2 = torch.linalg.qr(r1.reshape(g.height * N, N), mode="reduced")
    Qdm = DistMatrix.from_padded(local_gemm(q1, q2), A.m, A.n, MC, MR, g,
                                 A.wrap)
    Rdm = DistMatrix.from_padded(pad_array(r2, g), A.n, A.n, MC, MR, g,
                                 A.wrap)
    return Qdm, Rdm


def ColPivQR(A: DistMatrix, blocksize: Optional[int] = None
             ) -> Tuple[QRFactorization, Permutation]:
    """Column-pivoted (Businger-Golub) QR with greedy norm pivoting
    (reference: QR/BusingerGolub.hpp). Unblocked; each step is a masked
    argmax over the active column norms (read on the host) and a rank-1
    reflector update."""
    Am = A.redistribute(MC, MR)
    a = Am.data.clone()
    M, N = a.shape
    m, n = A.m, A.n
    dev = a.device
    tau = torch.zeros((N,), dtype=a.dtype, device=dev)
    perm = torch.arange(N, device=dev)
    colsv = torch.arange(N, device=dev)
    rowsv = torch.arange(M, device=dev)
    absa_zero = torch.zeros((), dtype=a.real.dtype, device=dev)
    for j in range(min(m, n)):
        act_r = (rowsv >= j) & (rowsv < m)
        sq = torch.sum(torch.where(act_r[:, None], torch.abs(a) ** 2,
                                   absa_zero), dim=0)
        act_c = (colsv >= j) & (colsv < n)
        p = int(torch.argmax(torch.where(act_c, sq, -torch.ones_like(sq))))
        a[:, [j, p]] = a[:, [p, j]]
        perm[[j, p]] = perm[[p, j]]
        x = a[:, j].clone()
        v, tj, beta = householder(x, j, m)
        tau[j] = tj
        Amask = torch.where((colsv > j)[None, :], a,
                            torch.zeros((), dtype=a.dtype, device=dev))
        w = local_gemm(v.conj()[None, :], Amask)
        a = a - tj * torch.outer(v, w[0])
        newcol = torch.where(rowsv > j, v, x)
        newcol[j] = beta
        a[:, j] = newcol
    fact = QRFactorization(Am.with_data(Am.mask_padding(a)), tau)
    return fact, Permutation(perm, A.n)
