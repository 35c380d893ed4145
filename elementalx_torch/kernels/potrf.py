"""K3a: Cholesky factor and transposed inverse of one diagonal block.

Counterpart of ``elementalx/kernels/potrf.py:potrf_block_inv`` (body
``_potrf_diag_kernel``). The CUDA kernel is ``csrc/potrf.cu``; its header
says why the TPU design (whole block in VMEM, transposed layout) does not
carry over, what bounds the kernel on the H100 (its chain of dependent
steps) and what this first design gives up.

``potrf_block_inv(sym)`` returns ``(l11, invLH)``: ``l11`` the lower
Cholesky factor of the symmetric block (only its lower triangle is read)
with exact zeros above the diagonal, and ``invLH = inv(l11)^H``. A block
that is not numerically positive definite poisons both outputs with NaN.
Any order w >= 1, float32 and float64; the CUDA kernel reads a contiguous
copy of the block (the driver hands it a freshly symmetrized one).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .common import (
    DTYPE_CODE,
    cdiv,
    check_launch,
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
