"""K5: one latrd panel of the Householder tridiagonalization.

Counterpart of ``elementalx/kernels/latrd.py`` (``latrd_panel``, body
``_latrd_kernel``). The CUDA kernel is ``csrc/latrd.cu``; its header says
why the TPU design (V and W transposed in VMEM, a two-slot tile stream)
does not carry over, what bounds the kernel on the H100 (the symv's
lower-triangle traffic, once per column, and four grid-wide barriers per
column) and what it gives up. Its symv runs on ``SymvTiles``
(``csrc/symv_unit.cuh``), K7's "tma" core: the TMA reads ``a`` in place
when its rows are a multiple of 16 bytes apart, and from a copy with
padded rows otherwise.

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

from .common import (
    DTYPE_CODE,
    check_launch,
    cooperative_grid,
    current_stream,
    kernel_function,
    on_cuda,
)

#: the widest panel (kMaxNB in csrc/latrd.cu)
MAX_NB = 128

_ARGTYPES = ((ctypes.c_int,) * 5 + (ctypes.c_void_p, ctypes.c_longlong)
             + (ctypes.c_void_p,) * 12 + (ctypes.c_int, ctypes.c_void_p))


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


def latrd_panel(a: torch.Tensor, k0: int, w: int, nb: int = MAX_NB
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(P, W, tau) of one panel. CPU tensors take ``latrd_panel_plain``;
    CUDA tensors launch the K5 kernel or raise. ``latrd_panel.launches``
    counts kernel launches. ``a`` is not written. On CUDA, P and W are
    transposed views of (nb, M) buffers."""
    if not on_cuda(a):
        return latrd_panel_plain(a, k0, w, nb)
    _check(a, k0, w, nb)
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
    G = cooperative_grid("elx_latrd_grid", a)
    Pt = torch.zeros((nb, M), dtype=dt, device=dev)
    Wt = torch.zeros((nb, M), dtype=dt, device=dev)
    Vt = torch.zeros((nb, M), dtype=dt, device=dev)
    tau = torch.zeros((nb,), dtype=dt, device=dev)
    vecs = torch.empty((3, M), dtype=dt, device=dev)      # acur, y, p
    ypart = torch.zeros((G, M), dtype=dt, device=dev)
    small = torch.empty((G * (2 * nb + 2) + 2 * nb,), dtype=dt, device=dev)
    pnorm, pvp = small[:G], small[G:2 * G]
    pdots = small[2 * G:2 * G + 2 * nb * G]
    dots = small[2 * G + 2 * nb * G:]
    fn = kernel_function("elx_latrd_panel", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(DTYPE_CODE[dt], M, k0, w, nb, a.data_ptr(), a.stride(0),
                Pt.data_ptr(),
                Wt.data_ptr(), Vt.data_ptr(), tau.data_ptr(),
                vecs[0].data_ptr(), ypart.data_ptr(), vecs[1].data_ptr(),
                vecs[2].data_ptr(), pnorm.data_ptr(), pdots.data_ptr(),
                dots.data_ptr(), pvp.data_ptr(), G, current_stream(a))
    check_launch(rc, "elx_latrd_panel")
    latrd_panel.launches += 1
    return Pt.mT, Wt.mT, tau


latrd_panel.launches = 0
