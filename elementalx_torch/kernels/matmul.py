"""K1: the local GEMM, C = A @ B with a float32 accumulator.

Counterpart of ``elementalx/kernels/matmul.py`` (``matmul_pallas``, body
``_matmul_kernel``). The CUDA kernel is ``csrc/matmul.cu`` on the tiled
FMA core of ``csrc/gemm_tile.cuh``; its header says what bounds it on the
H100 and what this first design gives up.

Unlike ``matmul_pallas`` it takes ragged shapes (the kernel masks its
edges) and strided operands: each operand is passed with its own row and
column strides, so transposed views such as ``row.mT`` and slices of a
larger buffer are read in place, without a contiguous copy.

Types: float32, float64 and bfloat16 inputs; bfloat16 accumulates in
float32 and, like ``local_gemm`` in the JAX package, returns bfloat16
unless ``out_dtype=torch.float32`` asks for the float32 result (the
``preferred_element_type`` of the JAX drivers' bf16-storage products).
float64 accumulates in float64. Complex inputs are not supported on CUDA.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .common import (
    DTYPE_CODE,
    check_launch,
    current_stream,
    kernel_function,
    on_cuda,
)

_SUPPORTED = {
    (torch.float32, torch.float32),
    (torch.float64, torch.float64),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
}

_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p)


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain PyTorch version of K1: ``torch.matmul`` with a float32
    accumulator for low-precision inputs."""
    out_dtype = out_dtype or a.dtype
    if a.dtype in (torch.bfloat16, torch.float16):
        return torch.matmul(a.float(), b.float()).to(out_dtype)
    return torch.matmul(a, b).to(out_dtype)


def _check(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul: 2-D operands expected, got {a.dim()}-D "
                         f"and {b.dim()}-D")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: inner dims mismatch {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"matmul: operands on {a.device} and {b.device}")
    if a.is_complex() or b.is_complex():
        raise NotImplementedError(
            "matmul: complex dtypes have no CUDA kernel yet (ROADMAP)")
    if a.dtype != b.dtype or (a.dtype, out_dtype) not in _SUPPORTED:
        raise TypeError(f"matmul: unsupported dtypes {a.dtype} x {b.dtype} "
                        f"-> {out_dtype}")


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B. CPU tensors take ``matmul_plain``; CUDA tensors launch
    the K1 kernel or raise. ``matmul.launches`` counts kernel launches."""
    out_dtype = out_dtype or a.dtype
    if not on_cuda(a, b):
        return matmul_plain(a, b, out_dtype)
    _check(a, b, out_dtype)
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    fn = kernel_function("elx_matmul", _ARGTYPES)
    with torch.cuda.device(a.device):
        rc = fn(DTYPE_CODE[a.dtype], DTYPE_CODE[out_dtype], M, N, K,
                a.data_ptr(), a.stride(0), a.stride(1),
                b.data_ptr(), b.stride(0), b.stride(1),
                c.data_ptr(), c.stride(0), c.stride(1), current_stream(a))
    check_launch(rc, "elx_matmul")
    matmul.launches += 1
    return c


matmul.launches = 0
