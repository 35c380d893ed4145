"""K1: the local GEMM, C = A @ B with a float32 accumulator.

Counterpart of ``elementalx/kernels/matmul.py`` (``matmul_pallas``, body
``_matmul_kernel``). The CUDA kernels are in ``csrc/matmul.cu``, on two
cores; ``route`` picks one from dtype, shape and alignment alone:

- ``"wgmma"``: bfloat16 operands that the TMA can read in place (a
  16-byte aligned base, one unit stride, the other stride a multiple of 16
  bytes; K = 0 reads nothing) go to the tensor cores, ``csrc/gemm_sm90.cuh``
  (TMA loads, a 4-stage shared-memory ring, wgmma, f32 accumulator);
- ``"fma_async"``: float32 operands with the same alignment go to the FP32
  FMA core fed by a cp.async ring, ``csrc/gemm_f32_pipe.cuh``; its result
  equals the ``"fma"`` core's bit for bit;
- ``"fma"``: everything else (float64, and float32 or bfloat16 operands
  that cannot be read so, such as a slice whose rows are not 16-byte
  multiples) goes to the tiled FMA core of ``csrc/gemm_tile.cuh``.

The header of ``csrc/matmul.cu`` says what bounds each on the H100.

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
_WGMMA_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p)
_ASYNC_ARGTYPES = _WGMMA_ARGTYPES[1:]

#: the cores and the C entry of each
CORES = {"wgmma": "elx_matmul_wgmma", "fma_async": "elx_matmul_fma_async",
         "fma": "elx_matmul"}

#: the core for operands read in place in 16-byte pieces, by dtype
FAST_CORE = {torch.bfloat16: "wgmma", torch.float32: "fma_async"}


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


def tma_unit_dim(x: torch.Tensor) -> Optional[int]:
    """The dimension (1 for row-major, 0 for column-major) over which the
    TMA or cp.async can read the 2-D operand ``x`` in place in 16-byte
    pieces: a 16-byte aligned base, stride 1 along it, the other stride a
    multiple of 16 bytes. None when there is none."""
    if x.data_ptr() % 16:
        return None
    for d in (1, 0):
        if x.stride(d) == 1 and (x.stride(1 - d) * x.element_size()) % 16 == 0:
            return d
    return None


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The K1 core a CUDA call C = A @ B takes, by dtype, shape and
    alignment alone: ``"wgmma"`` (tensor cores) for bfloat16 and
    ``"fma_async"`` for float32 operands that can be read in place in
    16-byte pieces (any when K = 0, which reads nothing), else ``"fma"``.
    No device is needed: the CPU tests check it."""
    fast = FAST_CORE.get(a.dtype)
    if fast is None or b.dtype != a.dtype:
        return "fma"
    if a.shape[1] == 0:
        return fast
    if tma_unit_dim(a) is None or tma_unit_dim(b) is None:
        return "fma"
    return fast


def _launch(core: str, a: torch.Tensor, b: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    """Launch K1's ``core`` on CUDA operands that it takes (``route``
    decides which; a test may hold two cores against each other) and
    return C; an empty C launches nothing. Counts nothing."""
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    with torch.cuda.device(a.device):
        if core == "fma":
            fn = kernel_function(CORES[core], _ARGTYPES)
            rc = fn(DTYPE_CODE[a.dtype], DTYPE_CODE[out_dtype], M, N, K,
                    a.data_ptr(), a.stride(0), a.stride(1),
                    b.data_ptr(), b.stride(0), b.stride(1),
                    c.data_ptr(), c.stride(0), c.stride(1), current_stream(a))
        else:
            # each operand's layout: A M-major (unit stride sam), B N-major
            # (unit stride sbn), or else K-major
            a_mn = int(K > 0 and tma_unit_dim(a) == 0)
            b_mn = int(K > 0 and tma_unit_dim(b) == 1)
            ops = (a.data_ptr(), a.stride(0), a.stride(1), a_mn,
                   b.data_ptr(), b.stride(0), b.stride(1), b_mn,
                   c.data_ptr(), c.stride(0), c.stride(1), current_stream(a))
            if core == "wgmma":
                fn = kernel_function(CORES[core], _WGMMA_ARGTYPES)
                rc = fn(DTYPE_CODE[out_dtype], M, N, K, *ops)
            else:
                fn = kernel_function(CORES[core], _ASYNC_ARGTYPES)
                rc = fn(M, N, K, *ops)
    check_launch(rc, f"K1 ({core})")
    return c


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B. CPU tensors take ``matmul_plain``; CUDA tensors launch
    the K1 kernel of ``route(a, b)`` or raise. ``matmul.launches_<core>``
    counts each core's launches, ``matmul.launches`` all of them
    (``reset_launches`` zeroes every count)."""
    out_dtype = out_dtype or a.dtype
    if not on_cuda(a, b):
        return matmul_plain(a, b, out_dtype)
    _check(a, b, out_dtype)
    core = route(a, b)
    c = _launch(core, a, b, out_dtype)
    if c.numel():  # an empty C launches nothing
        matmul.launches += 1
        name = f"launches_{core}"
        setattr(matmul, name, getattr(matmul, name) + 1)
    return c


def reset_launches() -> None:
    """Zero K1's launch counts (all cores)."""
    matmul.launches = 0
    for core in CORES:
        setattr(matmul, f"launches_{core}", 0)


reset_launches()
