"""Two-stage successive band reduction (SBR) tridiagonalization.

Counterpart of ``elementalx/lapack/sbr.py`` (reference role:
src/lapack_like/condense/HermitianTridiag.cpp:82-116 and
HermitianTridiag/ApplyQ.hpp). Bischof-Lang-Sun SBR, as in ELPA/PLASMA:

  stage 1: full symmetric -> band(b) by blocked Householder panels: a
    tall-skinny QR (``_geqrf_slab``) and a two-sided rank-2b product
    update of the trailing block per panel.
  stage 2: band(b) -> tridiagonal by rank-1 bulge chasing, sweep j fully
    chased before sweep j+1 in op order; on a CUDA tensor the K6 kernel
    (kernels/sb2tr.py) pipelines the sweeps, on the CPU ``_sb2tr_dense``
    runs them one op at a time.
  backtransform: Q = Q1 Q2, Q1 from the stage-1 panels, Q2 from the
    chase reflectors grouped into "diamond" compact-WY blocks (the
    chase-index-s reflectors of g consecutive sweeps, windows staggered
    by one row).

float32 only, as the JAX package. The products are ``torch.matmul``, as
the JAX package writes them with ``jnp.dot`` (no TF32: the package's
precision policy).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.grid import Grid
from ..kernels.sb2tr import sb2tr
from .qr import _geqrf_slab
from .reflect import build_wy_T


class SBRFactorization(NamedTuple):
    """Two-stage reduction output. ``panels_v``/``panels_t``: the stage-1
    (V, T) pairs, V_k ((n - k b - b), b); ``vout``: the stage-2 chase
    reflectors (n, smax, b), sweep j's chase-s reflector at vout[j, s]
    ([tau | v[1:]], v[0] = 1 implicit); ``d``/``e``: the tridiagonal."""

    panels_v: Tuple[torch.Tensor, ...]
    panels_t: Tuple[torch.Tensor, ...]
    vout: torch.Tensor
    d: torch.Tensor
    e: torch.Tensor

    @staticmethod
    def from_reference(panels_v: Sequence, panels_t: Sequence, vout, d, e,
                       grid: Optional[Grid] = None) -> "SBRFactorization":
        """The port's factorization for the JAX package's, given its
        arrays read through numpy."""
        dev = (grid or Grid.default()).device

        def t(x):
            return torch.tensor(np.asarray(x), device=dev)

        return SBRFactorization(tuple(t(v) for v in panels_v),
                                tuple(t(x) for x in panels_t), t(vout),
                                t(d), t(e))


def _panel_vt(slab: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(m, b) slab -> (V unit-lower, T forward-WY, R upper-triangular)."""
    pk, _, T = _geqrf_slab(slab, slab.shape[1])
    b = pk.shape[1]
    V = torch.tril(pk, -1)
    V.diagonal().fill_(1)
    R = torch.triu(pk[:b])
    return V, T, R


def _check_f32(a: torch.Tensor, what: str) -> None:
    if a.dtype != torch.float32:
        raise TypeError(f"{what}: the SBR path is float32 only, got "
                        f"{a.dtype}")


def band_reduce(a: torch.Tensor, b: int
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...],
                           Tuple[torch.Tensor, ...]]:
    """Stage 1: full symmetric (M, M) float32 ``a`` (both triangles) ->
    banded (bandwidth b) + the panel (V, T) factors. Requires M % b == 0.
    A_band = Q1^T A Q1 with Q1 = prod_k (I - V_k T_k V_k^T) acting on rows
    k b + b .. M. Works on one copy of a, in place."""
    M = a.shape[0]
    _check_f32(a, "band_reduce")
    if M % b:
        raise ValueError(f"band_reduce: M={M} is not a multiple of b={b}")
    a = a.clone(memory_format=torch.contiguous_format)
    Vs, Ts = [], []
    for k in range(0, M - 2 * b + 1, b):
        V, T, R = _panel_vt(a[k + b:, k:k + b])
        a[k + b:, k:k + b] = 0
        a[k + b:k + 2 * b, k:k + b] = R
        a[k:k + b, k + b:] = a[k + b:, k:k + b].mT
        # two-sided trailing update: A2 <- (I - V T V^T)^T A2 (.)
        A2 = a[k + b:, k + b:]
        Y = A2 @ (V @ T)
        S = V.mT @ Y
        W = Y - 0.5 * (V @ (T.mT @ S))
        A2 -= V @ W.mT + W @ V.mT
        Vs.append(V)
        Ts.append(T)
    return a, tuple(Vs), tuple(Ts)


def _apply_q1(panels_v, panels_t, Z: torch.Tensor, b: int,
              adjoint: bool = False) -> torch.Tensor:
    """Z := Q1 Z (or Q1^T Z): stage-1 panels in reverse (forward) order.
    Returns a new tensor."""
    Z = Z.clone()
    order = range(len(panels_v)) if adjoint else \
        reversed(range(len(panels_v)))
    for i in order:
        k = i * b
        V, T = panels_v[i], panels_t[i]
        Tm = T.mT if adjoint else T
        Zs = Z[k + b:]
        Zs -= V @ (Tm @ (V.mT @ Zs))
    return Z


def _house_padded(x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Householder of a length-b window (a zero tail gives tau = 0, the
    identity). Returns (v with v[0] = 1, tau, beta)."""
    alpha = x[0]
    sigma2 = torch.dot(x[1:], x[1:])
    norm = torch.sqrt(alpha * alpha + sigma2)
    beta0 = torch.where(alpha < 0, norm, -norm)
    trivial = sigma2 == 0
    one = torch.ones_like(alpha)
    zero = torch.zeros_like(alpha)
    denom = torch.where(trivial, one, alpha - beta0)
    v = torch.where(trivial, zero, x / denom)
    v[0] = 1
    tau = torch.where(trivial, zero,
                      (beta0 - alpha) / torch.where(beta0 == 0, one, beta0))
    beta = torch.where(trivial, alpha, beta0)
    return v, tau, beta


def chase_smax(n: int, b: int) -> int:
    """Chase-op count bound, rounded up to a multiple of 8 (the JAX
    kernel's unroll; kept so that vout has the JAX package's shape)."""
    s = 1 + max(0, -(-(n - 3) // b))
    return -(-s // 8) * 8


def _chase_house(ap: torch.Tensor, j: int, s: int, b: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 1 of chase op (j, s) on the padded dense matrix ``ap``: the
    Householder (v, tau, beta) of the window's eliminated column. Reads
    only that column; writes nothing."""
    ce = j if s == 0 else j + 1 + (s - 1) * b
    r0 = j + 1 + s * b
    return _house_padded(ap[r0:r0 + b, ce])


def _chase_apply(ap: torch.Tensor, j: int, s: int, b: int, v: torch.Tensor,
                 tau: torch.Tensor, beta: torch.Tensor,
                 vout: torch.Tensor) -> None:
    """Stage 2 of chase op (j, s): the two-sided update of the window's rows
    and columns over [r0-b, r0+2b), the eliminated column set to [beta, 0,
    ...] with its mirror, and the record vout[j, s] = [tau | v[1:]]."""
    ce = j if s == 0 else j + 1 + (s - 1) * b
    r0 = j + 1 + s * b
    c0, c1 = max(r0 - b, 0), r0 + 2 * b
    tv = tau * v
    blk = ap[r0:r0 + b, c0:c1]
    blk.addr_(tv, v @ blk, alpha=-1)
    blc = ap[c0:c1, r0:r0 + b]
    blc.addr_(blc @ v, tv, alpha=-1)
    # elimination hygiene: exact [beta, 0, ...] column + mirror
    ap[r0:r0 + b, ce] = 0
    ap[r0, ce] = beta
    ap[ce, r0:r0 + b] = ap[r0:r0 + b, ce]
    vout[j, s, 0] = tau
    vout[j, s, 1:] = v[1:]


def chase_ops(n: int, b: int, j: int) -> int:
    """Ops of sweep j of the chase of an order-n band of width b."""
    return min(max(1, (n - 2 - j + b - 1) // b + 1), chase_smax(n, b))


def _chase_pad(a_band: torch.Tensor, b: int) -> torch.Tensor:
    """The band in a zero-padded dense (n + 3b)^2 buffer: the padding is
    the farthest a window reaches past n."""
    n = a_band.shape[0]
    ap = a_band.new_zeros((n + 3 * b, n + 3 * b))
    ap[:n, :n] = a_band
    return ap


def _sb2tr_dense(a_band: torch.Tensor, b: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense reference of the band -> tridiagonal chase: column-major
    sweeps, op (j, s) on the window rows [r0, r0+b), r0 = j+1+s b,
    eliminating column ce (j at s = 0, r0 - b after), full-length zero
    padded windows with trivial guards. Returns (a_tri_dense, vout).

    Each op (``_chase_house`` then ``_chase_apply``) updates only the
    window's rows over columns [r0-b, r0+2b) and its columns over the same
    rows: everything else in them is zero at op time (the JAX package
    updates the whole padded row and column block; the zeros stay zero)."""
    n = a_band.shape[0]
    ap = _chase_pad(a_band, b)
    vout = a_band.new_zeros((n, chase_smax(n, b), b))
    for j in range(max(n - 2, 0)):
        for s in range(chase_ops(n, b, j)):
            v, tau, beta = _chase_house(ap, j, s, b)
            _chase_apply(ap, j, s, b, v, tau, beta, vout)
    return ap[:n, :n], vout


def _apply_q2(vout: torch.Tensor, Z: torch.Tensor, n: int, b: int,
              g: int = 128, adjoint: bool = False) -> torch.Tensor:
    """Z := Q2 Z (or Q2^T Z) with diamond compact-WY blocks: the
    chase-index-s reflectors of sweeps [c0, c0+g) (windows staggered by
    one row) form one (b+g) x g block. Blocks are applied sweep groups
    descending, s ascending (adjoint: all reversed). Zero vout rows give
    tau = 0, identity columns. Every block's D and T are built at once
    (one batched ``build_wy_T``); the blocks are then applied in turn."""
    smax = vout.shape[1]
    m = b + g
    n2 = max(n - 2, 0)
    schedule = []
    for c0 in reversed(range(0, n2, g)):
        s_hi = min(smax, 1 + max(0, -(-(n - 3 - c0) // b)))
        for s in range(s_hi):
            schedule.append((c0, s))
    if not schedule:
        return Z.clone()
    if adjoint:
        schedule = schedule[::-1]
    dev, dt = Z.device, vout.dtype
    c0s = torch.tensor([c for c, _ in schedule], device=dev)
    ss = torch.tensor([s for _, s in schedule], device=dev)
    vpad = torch.cat([vout, vout.new_zeros((g, smax, b))], dim=0)
    Zp = torch.cat([Z, Z.new_zeros((2 * b + g + 8, Z.shape[1]))], dim=0)
    rows = torch.arange(m, device=dev)[:, None]
    cols = torch.arange(g, device=dev)[None, :]
    # member i = sweep c0+i, its window starts at row c0+i+1+s b: offset i
    gather_rows = c0s[:, None] + torch.arange(g, device=dev)[None, :]
    Vg = vpad[gather_rows, ss[:, None]]                        # (K, g, b)
    taus = Vg[:, :, 0]
    Vrows = torch.cat([torch.ones_like(Vg[:, :, :1]), Vg[:, :, 1:]], dim=2)
    idx = torch.clamp(rows - cols, 0, b - 1)                   # (m, g)
    # D[k, r, i] = Vrows[k, i, r - i] (zero outside [i, i+b))
    D = torch.gather(Vrows.transpose(1, 2), 1,
                     idx[None].expand(Vg.shape[0], m, g))
    D = torch.where((rows >= cols) & (rows < cols + b), D,
                    torch.zeros((), dtype=dt, device=dev))
    T = build_wy_T(D, taus)
    for k, (c0, s) in enumerate(schedule):
        base = c0 + 1 + s * b
        Dk = D[k]
        Tm = T[k].mT if adjoint else T[k]
        Zs = Zp[base:base + m]
        Zs -= Dk @ (Tm @ (Dk.mT @ Zs))
    return Zp[:Z.shape[0]]


def sbr_apply_q(fact: SBRFactorization, Z: torch.Tensor, b: int,
                adjoint: bool = False) -> torch.Tensor:
    """Backtransform Z := Q Z (Q = Q1 Q2) or Q^T Z."""
    n = fact.vout.shape[0]
    if adjoint:
        Z = _apply_q1(fact.panels_v, fact.panels_t, Z, b, adjoint=True)
        return _apply_q2(fact.vout, Z, n, b, adjoint=True)
    Z = _apply_q2(fact.vout, Z, n, b, adjoint=False)
    return _apply_q1(fact.panels_v, fact.panels_t, Z, b, adjoint=False)


def sbr_tridiag(a: torch.Tensor, b: int = 256) -> SBRFactorization:
    """Full symmetric (M, M) float32 (both triangles) -> SBRFactorization.
    The chase is K6 on a CUDA tensor and ``_sb2tr_dense`` on the CPU
    (the JAX package's ``use_kernel`` choice, made by the device)."""
    _check_f32(a, "sbr_tridiag")
    a_band, Vs, Ts = band_reduce(a, b)
    vout, d, e = sb2tr(a_band, b)
    return SBRFactorization(Vs, Ts, vout, d, e)
