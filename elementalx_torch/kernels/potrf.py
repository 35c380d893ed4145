"""K3a, K3b and K3c: the Cholesky diagonal block and the fused panel tail.

K3a is the counterpart of ``elementalx/kernels/potrf.py:potrf_block_inv``
(body ``_potrf_diag_kernel``). The CUDA kernel is ``csrc/potrf.cu``; its
header says why the TPU design (whole block in VMEM, transposed layout)
does not carry over, what bounds the kernel on the H100 (its chain of
dependent steps) and what this first design gives up.

``potrf_block_inv(sym)`` returns ``(l11, invLH)``: ``l11`` the lower
Cholesky factor of the symmetric block (only its lower triangle is read)
with exact zeros above the diagonal, and ``invLH = inv(l11)^H``. A block
that is not numerically positive definite poisons both outputs with NaN.
Any order w >= 1, float32 and float64; the CUDA kernel reads a contiguous
copy of the block (the driver hands it a freshly symmetrized one).

K3b and K3c are the counterparts of ``potrf_panel_tail`` (body
``_potrf_kernel``) and ``potrf_panel_tail_full`` (body
``_potrf_kernel_full``): the whole panel tail [L11; L21 = A21 inv(L11)^H]
in one cooperative launch of ``csrc/potrf_tail.cu``, whose header gives
its phases and bounds. K3c is K3b on the full-height column with zeros
above the diagonal tile. Unlike the TPU kernels (float32, Mt and w
multiples of 128) they take any (Mt, w), float32 and float64;
``low_apply`` (float32 only) rounds both operands of the L21 product to
bfloat16. A block that is not positive definite poisons every row from
the diagonal tile down with NaN (the JAX kernel poisons some columns).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .common import (
    DTYPE_CODE,
    cdiv,
    check_launch,
    cooperative_grid,
    current_stream,
    kernel_function,
    on_cuda,
)

#: width of one factorization step in csrc/potrf.cu
STEP = 32

_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p)


def padded_order(w: int) -> int:
    """The kernel's working order: w rounded up to STEP * 2^p, so each
    level of its doubling inverse pairs equal blocks."""
    nblk = 1
    while nblk * STEP < w:
        nblk *= 2
    return nblk * STEP


def potrf_block_inv_plain(sym: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K3a: ``torch.linalg.cholesky_ex`` plus
    a triangular inverse, with the same NaN poisoning."""
    l11, info = torch.linalg.cholesky_ex(sym)
    eye = torch.eye(sym.shape[0], dtype=sym.dtype, device=sym.device)
    inv = torch.linalg.solve_triangular(l11, eye, upper=False)
    bad = info != 0
    nan = torch.full((), float("nan"), dtype=sym.dtype, device=sym.device)
    return (torch.where(bad, nan, l11),
            torch.where(bad, nan, inv.mH))


def _check(sym: torch.Tensor) -> None:
    if sym.dim() != 2 or sym.shape[0] != sym.shape[1]:
        raise ValueError(f"potrf_block_inv: square block expected, got "
                         f"{tuple(sym.shape)}")
    if sym.is_complex():
        raise NotImplementedError(
            "potrf_block_inv: complex dtypes have no CUDA kernel yet "
            "(ROADMAP)")
    if sym.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"potrf_block_inv: unsupported dtype {sym.dtype}")


def potrf_block_inv(sym: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(l11, inv(l11)^H) of a symmetric block. CPU tensors take
    ``potrf_block_inv_plain``; CUDA tensors launch the K3a kernel or
    raise. ``potrf_block_inv.launches`` counts kernel launches."""
    if not on_cuda(sym):
        return potrf_block_inv_plain(sym)
    _check(sym)
    w = sym.shape[0]
    if w == 0:
        return torch.empty_like(sym), torch.empty_like(sym)
    sym = sym.contiguous()
    W = padded_order(w)
    dev, dt = sym.device, sym.dtype
    l11 = torch.empty((w, w), dtype=dt, device=dev)
    inv_lh = torch.empty((w, w), dtype=dt, device=dev)
    # scratch: the factor being worked on, the inverse, the doubling's
    # products and the not-positive-definite flag
    work = torch.empty((W, W), dtype=dt, device=dev)
    xinv = torch.empty((W, W), dtype=dt, device=dev)
    tmp = torch.empty((cdiv(W * W, 4),), dtype=dt, device=dev)
    flag = torch.empty((1,), dtype=torch.int32, device=dev)
    fn = kernel_function("elx_potrf_block_inv", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(DTYPE_CODE[dt], w, W, sym.data_ptr(), sym.stride(0),
                l11.data_ptr(), inv_lh.data_ptr(), work.data_ptr(),
                xinv.data_ptr(), tmp.data_ptr(), flag.data_ptr(),
                current_stream(sym))
    check_launch(rc, "elx_potrf_block_inv")
    potrf_block_inv.launches += 1
    return l11, inv_lh


potrf_block_inv.launches = 0


# ---------------------------------------------------------------------------
# K3b and K3c: the fused panel tail (csrc/potrf_tail.cu)
# ---------------------------------------------------------------------------

_TAIL_ARGTYPES = ((ctypes.c_int,) * 6
                  + (ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong)
                  + (ctypes.c_void_p,) * 6 + (ctypes.c_int, ctypes.c_void_p))


def _apply_plain(pan21: torch.Tensor, inv_lh: torch.Tensor,
                 low_apply: bool) -> torch.Tensor:
    """L21 = pan21 inv_lh; with ``low_apply`` both operands rounded to
    bfloat16 (nearest even) and the products summed in float32."""
    if low_apply:
        return pan21.bfloat16().float() @ inv_lh.bfloat16().float()
    return pan21 @ inv_lh


def potrf_panel_tail_plain(sym_a11: torch.Tensor, pan: torch.Tensor,
                           low_apply: bool = False) -> torch.Tensor:
    """The plain PyTorch version of K3b: K3a's plain version for the
    diagonal block, then one product for the rows below it."""
    w = sym_a11.shape[0]
    l11, inv_lh = potrf_block_inv_plain(sym_a11)
    out = torch.empty(pan.shape, dtype=pan.dtype, device=pan.device)
    out[:w] = l11
    out[w:] = _apply_plain(pan[w:], inv_lh, low_apply)
    return out


def potrf_panel_tail_full_plain(sym_a11: torch.Tensor,
                                pan_full: torch.Tensor, kidx: int,
                                low_apply: bool = False) -> torch.Tensor:
    """The plain PyTorch version of K3c: zeros above tile ``kidx``, then
    K3b's plain version on the rows from there."""
    r0 = int(kidx) * sym_a11.shape[0]
    out = torch.zeros(pan_full.shape, dtype=pan_full.dtype,
                      device=pan_full.device)
    out[r0:] = potrf_panel_tail_plain(sym_a11, pan_full[r0:], low_apply)
    return out


def _check_tail(sym: torch.Tensor, pan: torch.Tensor, r0: int,
                low_apply: bool, name: str) -> None:
    if sym.dim() != 2 or sym.shape[0] != sym.shape[1] or pan.dim() != 2:
        raise ValueError(f"{name}: a square block and a 2-D panel expected, "
                         f"got {tuple(sym.shape)} and {tuple(pan.shape)}")
    w = sym.shape[0]
    if w == 0 or pan.shape[1] != w or r0 < 0 or r0 + w > pan.shape[0]:
        raise ValueError(f"{name}: the panel {tuple(pan.shape)} has no "
                         f"({w}, {w}) diagonal block at row {r0}")
    if sym.is_complex() or pan.is_complex():
        raise NotImplementedError(
            f"{name}: complex dtypes have no CUDA kernel yet (ROADMAP)")
    if sym.dtype not in (torch.float32, torch.float64) \
            or pan.dtype != sym.dtype:
        raise TypeError(f"{name}: unsupported dtypes {sym.dtype}, "
                        f"{pan.dtype}")
    if low_apply and sym.dtype != torch.float32:
        raise TypeError(f"{name}: low_apply needs float32")


def _tail_launch(sym: torch.Tensor, pan: torch.Tensor, r0: int,
                 low_apply: bool) -> torch.Tensor:
    """One launch of csrc/potrf_tail.cu: out (rows, w) with zeros above r0,
    L11 at r0 and L21 below."""
    sym = sym.contiguous()
    rows, w = pan.shape
    W = padded_order(w)
    dev, dt = sym.device, sym.dtype
    out = torch.empty((rows, w), dtype=dt, device=dev)
    # scratch: the factor being worked on, the inverse, the doubling's
    # products, inv(L11)^T and the not-positive-definite flag
    work = torch.empty((W, W), dtype=dt, device=dev)
    xinv = torch.empty((W, W), dtype=dt, device=dev)
    tmp = torch.empty((cdiv(W * W, 4),), dtype=dt, device=dev)
    invlh = torch.empty((w, w), dtype=dt, device=dev)
    flag = torch.empty((1,), dtype=torch.int32, device=dev)
    G = cooperative_grid("elx_potrf_tail_grid", sym)
    fn = kernel_function("elx_potrf_panel_tail", _TAIL_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(DTYPE_CODE[dt], rows, w, W, r0, int(bool(low_apply)),
                sym.data_ptr(), sym.stride(0), pan.data_ptr(), pan.stride(0),
                pan.stride(1), out.data_ptr(), work.data_ptr(),
                xinv.data_ptr(), tmp.data_ptr(), invlh.data_ptr(),
                flag.data_ptr(), G, current_stream(sym))
    check_launch(rc, "elx_potrf_panel_tail")
    return out


def potrf_panel_tail(sym_a11: torch.Tensor, pan: torch.Tensor,
                     low_apply: bool = False) -> torch.Tensor:
    """The fused panel tail [L11; L21] of a (Mt, w) history-updated panel
    whose symmetrized diagonal block is ``sym_a11`` (rows [0, w) of ``pan``
    are not read). Any Mt >= w, any w. CPU tensors take
    ``potrf_panel_tail_plain``; CUDA tensors launch the K3b kernel or
    raise. ``potrf_panel_tail.launches`` counts kernel launches."""
    if not on_cuda(sym_a11, pan):
        return potrf_panel_tail_plain(sym_a11, pan, low_apply)
    _check_tail(sym_a11, pan, 0, low_apply, "potrf_panel_tail")
    out = _tail_launch(sym_a11, pan, 0, low_apply)
    potrf_panel_tail.launches += 1
    return out


potrf_panel_tail.launches = 0


def potrf_panel_tail_full(sym_a11: torch.Tensor, pan_full: torch.Tensor,
                          kidx: int, low_apply: bool = False) -> torch.Tensor:
    """The same tail on the full-height (M, w) column whose diagonal block
    is tile ``kidx`` (rows kidx*w onwards); rows above are returned as
    zeros. CPU tensors take ``potrf_panel_tail_full_plain``; CUDA tensors
    launch the K3c kernel or raise. ``potrf_panel_tail_full.launches``
    counts kernel launches."""
    if not on_cuda(sym_a11, pan_full):
        return potrf_panel_tail_full_plain(sym_a11, pan_full, kidx,
                                           low_apply)
    r0 = int(kidx) * sym_a11.shape[0]
    _check_tail(sym_a11, pan_full, r0, low_apply, "potrf_panel_tail_full")
    out = _tail_launch(sym_a11, pan_full, r0, low_apply)
    potrf_panel_tail_full.launches += 1
    return out


potrf_panel_tail_full.launches = 0
