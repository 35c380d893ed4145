"""K7: the symmetric matrix-vector product from the lower triangle.

Counterpart of ``elementalx/kernels/symv.py`` (``symv_lower`` and
``symv_lower_trailing``, TPU kernel ``_symv_lower_tpu`` with body
``_symv_kernel``). The CUDA kernel is ``csrc/symv.cu``, one cooperative
launch over the lower triangle built from K5's symv unit; its header says
what bounds it on the H100 (the bytes of the lower triangle) and how it
sums without float atomics.

``symv_lower(A, v)`` is ``H @ v`` with ``H = tril(A) + tril(A, -1)^T``:
only the lower triangle of A is read, so the strict upper triangle may
hold anything. (The JAX package's CPU route reads the whole of A and so
assumes it fully stored; the port's plain version reads the lower
triangle, as the kernel does.) ``symv_lower_trailing(a, v, k0)`` is the
same product over the trailing block ``a[k0:, k0:]``, read at k0 exactly:
the JAX kernel rounds k0 down to a multiple of its block and pads v with
zeros, which the CUDA kernel does not need, since it takes any order and
any row stride.

Types on CUDA: float32 and float64 (the TPU kernel refuses float64).
Complex input has no kernel; its CPU path works.
"""

from __future__ import annotations

import ctypes

import torch

from .common import (
    DTYPE_CODE,
    check_launch,
    cooperative_grid,
    current_stream,
    kernel_function,
    on_cuda,
)

_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p)


def symv_lower_plain(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K7: the symmetric matrix built from the
    lower triangle, times v."""
    H = torch.tril(A) + torch.tril(A, -1).mH
    return H @ v


def _check(A: torch.Tensor, v: torch.Tensor) -> None:
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"symv_lower: a square matrix expected, got "
                         f"{tuple(A.shape)}")
    if v.dim() != 1 or v.shape[0] != A.shape[0]:
        raise ValueError(f"symv_lower: a vector of length {A.shape[0]} "
                         f"expected, got {tuple(v.shape)}")
    if A.is_complex() or v.is_complex():
        raise NotImplementedError(
            "symv_lower: complex dtypes have no CUDA kernel yet (ROADMAP)")
    if A.dtype not in (torch.float32, torch.float64) or v.dtype != A.dtype:
        raise TypeError(f"symv_lower: unsupported dtypes {A.dtype}, "
                        f"{v.dtype}")


def symv_lower(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = H v from the lower triangle of A. CPU tensors take
    ``symv_lower_plain``; CUDA tensors launch the K7 kernel or raise.
    ``symv_lower.launches`` counts kernel launches (those of
    ``symv_lower_trailing`` included)."""
    if not on_cuda(A, v):
        return symv_lower_plain(A, v)
    _check(A, v)
    n = A.shape[0]
    if A.stride(1) != 1 or A.stride(0) < n:
        A = A.contiguous()
    v = v.contiguous()
    dev, dt = A.device, A.dtype
    y = torch.empty((n,), dtype=dt, device=dev)
    if n == 0:
        return y
    G = cooperative_grid("elx_symv_grid", A)
    ypart = torch.empty((G, n), dtype=dt, device=dev)
    fn = kernel_function("elx_symv_lower", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(DTYPE_CODE[dt], n, A.data_ptr(), A.stride(0),
                v.data_ptr(), y.data_ptr(), ypart.data_ptr(), G,
                current_stream(A))
    check_launch(rc, "elx_symv_lower")
    symv_lower.launches += 1
    return y


symv_lower.launches = 0


def symv_lower_trailing(a: torch.Tensor, v: torch.Tensor,
                        k0: int) -> torch.Tensor:
    """H v over the trailing block ``a[k0:, k0:]`` (lower triangle read),
    given the local vector v of length M - k0. The block is read in place
    at k0 exactly, through its row stride."""
    return symv_lower(a[k0:, k0:], v)
