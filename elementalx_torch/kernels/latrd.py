"""K5: one latrd panel of the Householder tridiagonalization.

Counterpart of ``elementalx/kernels/latrd.py`` (``latrd_panel``, body
``_latrd_kernel``). The CUDA kernel is ``csrc/latrd.cu``; its header says
why the TPU design (V and W transposed in VMEM, a two-slot tile stream)
does not carry over, what bounds the kernel on the H100 (the symv's
lower-triangle traffic, once per column) and how a column keeps its
latency short: three grid barriers, a warp a row over row-major copies
of V and W, the symv in units handed out by a counter with each unit's
sums in slots of its own; every sum in float64, for float32 input too.
Its symv runs on ``SymvTiles``'s TMA ring (``csrc/symv_unit.cuh``, K7's
"tma" core): the TMA reads ``a`` in place when its rows are a multiple of
16 bytes apart, and from a copy with padded rows otherwise.
``probes/k5.py`` times a column phase by phase.

``latrd_panel(a, k0, w, nb)`` returns ``(P, W, tau)`` with the contract of
the JAX kernel: columns [k0, k0+w) of the global (M, M) symmetric ``a``
(lower triangle read on the trailing block), ``P`` (M, nb) the finished
panel columns (the corrected column on rows <= k0+j, beta on row k0+j+1,
the reflector below), ``W`` (M, nb) the rank-2 update vectors, ``tau``
(nb,). Rows < k0 of P and W, which the JAX contract leaves as junk, are
zero here, as are columns >= w.

Unlike the TPU kernel (float32, M a multiple of the tile) the CUDA kernel
takes float32 and float64 of any M, with k0 + w <= M - 2 (every panel of
``HermitianTridiag``). Complex input has no kernel; its CPU path works.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import trace
from .common import DTYPE_CODE, Entry, cdiv, cooperative_grid, launch, on_cuda

#: the widest panel (kMaxNB in csrc/latrd.cu)
MAX_NB = 128

#: the symv's tile order and the tiles of one of its units (csrc/latrd.cu)
TILE, UNIT_TILES = 64, 4

PANEL = Entry("elx_latrd_panel",
              (ctypes.c_int,) * 5 + (ctypes.c_void_p, ctypes.c_longlong)
              + (ctypes.c_void_p,) * 14 + (ctypes.c_int, ctypes.c_void_p))


def latrd_panel_plain(a: torch.Tensor, k0: int, w: int, nb: int = MAX_NB
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K5: the port's ``_tridiag_panel`` on
    the trailing block, returned in K5's contract."""
    from ..lapack.condense import _tridiag_panel

    M = a.shape[0]
    at = a[k0:, k0:].clone()
    Mt = at.shape[0]
    V = a.new_zeros((Mt, w))
    W = a.new_zeros((Mt, w))
    tau = a.new_zeros((M,))
    at, V, W, tau = _tridiag_panel(a, at, V, W, tau, k0, w, M - k0)
    P = a.new_zeros((M, nb))
    Wout = a.new_zeros((M, nb))
    P[k0:, :w] = at[:, :w]
    Wout[k0:, :w] = W
    taup = a.new_zeros((nb,))
    taup[:w] = tau[k0:k0 + w]
    return P, Wout, taup


def _check(a: torch.Tensor, k0: int, w: int, nb: int) -> None:
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"latrd_panel: a square matrix expected, got "
                         f"{tuple(a.shape)}")
    if a.is_complex():
        raise NotImplementedError(
            "latrd_panel: complex dtypes have no CUDA kernel (ROADMAP)")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"latrd_panel: unsupported dtype {a.dtype}")
    M = a.shape[0]
    if not (0 < nb <= MAX_NB and 0 <= w <= nb and k0 >= 0
            and k0 + w <= M - 2):
        raise ValueError(f"latrd_panel: needs w <= nb <= {MAX_NB} and "
                         f"k0 + w <= M - 2; got M={M} k0={k0} w={w} nb={nb}")


def _launch(a: torch.Tensor, k0: int, w: int, nb: int,
            panel: Entry = PANEL, grid: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K5 on a checked CUDA ``a`` and return (P, W, tau); counts
    nothing. ``panel`` and ``grid`` (the C entry and its cooperative grid)
    default to the kernel library's; the phase probe (probes/k5.py) passes
    an Entry of its instrumented build and that build's grid."""
    M = a.shape[0]
    elem = a.element_size()
    if (a.stride(1) != 1 or a.stride(0) < M or (a.stride(0) * elem) % 16
            or a.data_ptr() % 16):
        # rows 16-byte multiples apart from a 16-byte aligned base, as the
        # TMA needs
        lda = -(-M * elem // 16) * 16 // elem
        a = torch.empty((M, lda), dtype=a.dtype,
                        device=a.device)[:, :M].copy_(a)
    dev, dt = a.device, a.dtype
    G = grid or cooperative_grid("elx_latrd_grid", a)
    # the symv's strips of the trailing block (SymvTiles: the tiles start
    # d = k0 mod (16 / element size) columns early, on 16-byte boundaries)
    S = cdiv(M - k0 + k0 % (16 // elem), TILE)
    Pt = torch.zeros((nb, M), dtype=dt, device=dev)
    Wt = torch.zeros((nb, M), dtype=dt, device=dev)
    VWr = torch.empty((2, M, MAX_NB), dtype=dt, device=dev)
    tau = torch.zeros((nb,), dtype=dt, device=dev)
    vecs = torch.empty((2, M), dtype=dt, device=dev)      # acur, p
    # the kernel's sums, in float64 for either type: the symv's slots, the
    # partials of sigma^2, of the panel dots and of v^T p, the panel dots
    f64 = dict(dtype=torch.float64, device=dev)
    colpart = torch.empty((S * (S + 1) // 2 * TILE,), **f64)
    rowpart = torch.empty((S * cdiv(S, UNIT_TILES) * TILE,), **f64)
    small = torch.empty((G * (2 * MAX_NB + 2) + 2 * MAX_NB,), **f64)
    pnorm, pvp = small[:G], small[G:2 * G]
    pdots = small[2 * G:2 * G + 2 * MAX_NB * G]
    dots = small[2 * G + 2 * MAX_NB * G:]
    counters = torch.zeros((w,), dtype=torch.int32, device=dev)
    launch(panel, a, DTYPE_CODE[dt], M, k0, w, nb, a.data_ptr(), a.stride(0),
           Pt.data_ptr(), Wt.data_ptr(), VWr[0].data_ptr(), VWr[1].data_ptr(),
           tau.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
           colpart.data_ptr(), rowpart.data_ptr(), pnorm.data_ptr(),
           pdots.data_ptr(), dots.data_ptr(), pvp.data_ptr(),
           counters.data_ptr(), G)
    return Pt.mT, Wt.mT, tau


def latrd_panel(a: torch.Tensor, k0: int, w: int, nb: int = MAX_NB
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(P, W, tau) of one panel. CPU tensors take ``latrd_panel_plain``;
    CUDA tensors launch the K5 kernel or raise. ``latrd_panel.launches``
    counts kernel launches. ``a`` is not written. On CUDA, P and W are
    transposed views of (nb, M) buffers."""
    if not on_cuda(a):
        return latrd_panel_plain(a, k0, w, nb)
    _check(a, k0, w, nb)
    out = _launch(a, k0, w, nb)
    trace.count(latrd_panel)
    return out


trace.reset_counts(latrd_panel)
