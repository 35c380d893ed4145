"""K2: the masked rank-k update, C := alpha A B + beta C on one triangle.

Counterpart of ``elementalx/kernels/trrk.py`` (``masked_rank_k``, body
``_trrk_kernel``), the LocalTrrk workhorse. The CUDA kernel is
``csrc/trrk.cu`` on the tile core of ``csrc/gemm_tile.cuh``; its header
says what bounds it on the H100 and why, unlike the TPU kernel, it skips
the tiles off the triangle.

``masked_rank_k(lower, alpha, a, b, beta, c)`` returns a new (M, N)
tensor: on the lower (column <= row) or upper (column >= row) triangle
``alpha * (a @ b) + beta * c``, elsewhere ``c`` unchanged, bit for bit.
The CUDA kernel writes into a contiguous clone of ``c``, in place, and
touches only the triangle. As in the JAX kernel, ``c`` is read on the
whole triangle even when beta is 0, so a NaN there stays NaN.

Types on CUDA: float32, float64 and bfloat16 operands (a and b of one
type); bfloat16 accumulates in float32 and takes a bfloat16 or float32 c;
otherwise c has the operands' type. Any shapes, any strides. Complex input
has no kernel; its CPU path works.
"""

from __future__ import annotations

import ctypes

import torch

from .. import trace
from .common import (
    DTYPE_CODE,
    check_launch,
    current_stream,
    kernel_function,
    on_cuda,
)
from .matmul import matmul_plain

_SUPPORTED = {
    (torch.float32, torch.float32),
    (torch.float64, torch.float64),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
}

_ARGTYPES = ((ctypes.c_int,) * 6
             + (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong) * 3
             + (ctypes.c_double, ctypes.c_double, ctypes.c_void_p))


def triangle_mask(M: int, N: int, lower: bool,
                  device: torch.device) -> torch.Tensor:
    """(M, N) bool: column <= row (lower) or column >= row (upper)."""
    i = torch.arange(M, device=device)[:, None]
    j = torch.arange(N, device=device)[None, :]
    return (j <= i) if lower else (j >= i)


def masked_rank_k_plain(lower: bool, alpha, a: torch.Tensor,
                        b: torch.Tensor, beta, c: torch.Tensor
                        ) -> torch.Tensor:
    """The plain PyTorch version of K2, the JAX CPU route (trrk.py:51-59):
    one product in c's type, then a ``torch.where`` on the triangle."""
    prod = matmul_plain(a, b, out_dtype=c.dtype)
    keep = triangle_mask(c.shape[0], c.shape[1], lower, c.device)
    return torch.where(keep, alpha * prod + beta * c, c)


def _check(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or c.dim() != 2:
        raise ValueError("masked_rank_k: 2-D operands expected")
    if a.shape[1] != b.shape[0] or c.shape != (a.shape[0], b.shape[1]):
        raise ValueError(f"masked_rank_k: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} -> {tuple(c.shape)}")
    if a.is_complex() or b.is_complex() or c.is_complex():
        raise NotImplementedError(
            "masked_rank_k: complex dtypes have no CUDA kernel yet (ROADMAP)")
    if a.dtype != b.dtype or (a.dtype, c.dtype) not in _SUPPORTED:
        raise TypeError(f"masked_rank_k: unsupported dtypes {a.dtype} x "
                        f"{b.dtype} -> {c.dtype}")


def masked_rank_k(lower: bool, alpha, a: torch.Tensor, b: torch.Tensor,
                  beta, c: torch.Tensor) -> torch.Tensor:
    """C_tri := alpha A B + beta C on the triangle; the rest of C unchanged.
    CPU tensors take ``masked_rank_k_plain``; CUDA tensors launch the K2
    kernel or raise. ``masked_rank_k.launches`` counts kernel launches."""
    if not on_cuda(a, b, c):
        return masked_rank_k_plain(lower, alpha, a, b, beta, c)
    _check(a, b, c)
    out = c.clone(memory_format=torch.contiguous_format)
    M, K = a.shape
    N = b.shape[1]
    if M == 0 or N == 0:
        return out
    fn = kernel_function("elx_masked_rank_k", _ARGTYPES)
    with torch.cuda.device(a.device):
        rc = fn(DTYPE_CODE[a.dtype], DTYPE_CODE[c.dtype], int(bool(lower)),
                M, N, K, a.data_ptr(), a.stride(0), a.stride(1),
                b.data_ptr(), b.stride(0), b.stride(1),
                out.data_ptr(), out.stride(0), out.stride(1),
                float(alpha), float(beta), current_stream(a))
    check_launch(rc, "elx_masked_rank_k")
    trace.count(masked_rank_k)
    return out


trace.reset_counts(masked_rank_k)
