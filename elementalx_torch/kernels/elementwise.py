"""K9: the level-1 elementwise kernels and the tiled transpose.

Counterpart of ``elementalx/kernels/elementwise.py`` (``axpy``, ``scale``
and ``hadamard`` through ``_ew_call``, ``fill`` and ``transpose``), the
Pallas analogues of Hydrogen's ``gpu/{Axpy,Scale,Hadamard,Fill,
Transpose}.cu``. The CUDA kernels are ``csrc/elementwise.cu``; its header
says what bounds them on the H100 (bytes) and how the transpose keeps
both its reads and its writes coalesced.

The five wrappers:

- ``axpby(alpha, x, beta, y)``: beta y + alpha x (Axpy is beta = 1);
- ``scale(alpha, x)``: alpha x;
- ``hadamard(x, y)``: x * y entrywise;
- ``fill(shape, alpha, dtype, device, extent)``: alpha on the logical
  ``extent`` = (m, n) corner of a ``shape`` array, 0 in the rest (the
  padding of a DistMatrix);
- ``transpose(x, conjugate)``: x^T, or x^H.

Each returns a fresh contiguous tensor; inputs are 2-D with any strides
(``.mT`` views are read in place). alpha and beta may be Python numbers or
0-d tensors: they reach the kernel as one element of the output's type on
the device (a tensor on the card costs no host synchronisation; a number
is written there by a fill launch, not copied from the host). bfloat16
computes in float32 and rounds once, as the plain versions do, so kernel
and plain version agree bit for bit.

Types on CUDA: float32, float64 and bfloat16. Complex input has no kernel
and raises ``NotImplementedError``; its CPU path works. The JAX package
falls back to jnp when alpha is traced or the shape is not (8, 128)-
tileable; on CUDA the port has no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .common import (
    DTYPE_CODE,
    check_launch,
    current_stream,
    kernel_function,
    on_cuda,
)

_INT32_MAX = 2 ** 31 - 1
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_AXPBY_ARGS = (_I, _I, _I, _P, _P, _L, _L, _P, _P, _L, _L, _P, _P)
_SCALE_ARGS = (_I, _I, _I, _P, _P, _L, _L, _P, _P)
_HADAMARD_ARGS = (_I, _I, _I, _P, _L, _L, _P, _L, _L, _P, _P)
_FILL_ARGS = (_I, _I, _I, _I, _I, _P, _P, _P)
_TRANSPOSE_ARGS = (_I, _I, _I, _P, _L, _L, _P, _P)


def device_scalar(v, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """v as a 0-d tensor of ``dtype`` on ``device``: a tensor is cast and
    moved (no host sync), a number is filled in on the device."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device, dtype=dtype).reshape(())
    return torch.full((), v, dtype=dtype, device=device)


def _arith(t: torch.Tensor) -> torch.Tensor:
    """The arithmetic type of a stored type: bfloat16 computes in float32."""
    return t.float() if t.dtype == torch.bfloat16 else t


# ---------------------------------------------------------------------------
# plain versions (CPU tensors take them; on the card only tests and
# chip_smoke.py call them)
# ---------------------------------------------------------------------------


def axpby_plain(alpha, x: torch.Tensor, beta, y: torch.Tensor
                ) -> torch.Tensor:
    """beta y + alpha x with alpha, beta in y's type (the JAX CPU route,
    elementwise.py:64, is beta = 1)."""
    a = device_scalar(alpha, y.dtype, y.device)
    b = device_scalar(beta, y.dtype, y.device)
    out = (_arith(b) * _arith(y) + _arith(a) * _arith(x)).to(y.dtype)
    return out.contiguous()


def scale_plain(alpha, x: torch.Tensor) -> torch.Tensor:
    """alpha x with alpha in x's type (elementwise.py:75)."""
    a = device_scalar(alpha, x.dtype, x.device)
    out = (_arith(a) * _arith(x)).to(x.dtype)
    return out.contiguous()


def hadamard_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x * y entrywise (elementwise.py:85)."""
    out = (_arith(x) * _arith(y)).to(x.dtype)
    return out.contiguous()


def fill_plain(shape: Sequence[int], alpha, dtype: torch.dtype,
               device=None, extent: Optional[Tuple[int, int]] = None
               ) -> torch.Tensor:
    """alpha on the ``extent`` corner of a ``shape`` array, 0 elsewhere
    (elementwise.py:112 with the padding masked, as level1.Fill needs)."""
    device = torch.device(device) if device is not None else torch.device(
        "cpu")
    m, n = extent if extent is not None else shape
    out = torch.zeros(tuple(shape), dtype=dtype, device=device)
    out[:m, :n] = device_scalar(alpha, dtype, device)
    return out


def transpose_plain(x: torch.Tensor, conjugate: bool = False
                    ) -> torch.Tensor:
    """x^T (or x^H) as a fresh contiguous tensor (elementwise.py:140)."""
    t = x.mT.clone(memory_format=torch.contiguous_format)
    return t.conj_physical_() if conjugate and t.is_complex() else t


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dim() != 2:
            raise ValueError(f"{name}: 2-D tensors expected, got "
                             f"{t.dim()}-D")
        if t.is_complex():
            raise NotImplementedError(
                f"{name}: complex dtypes have no CUDA kernel yet (ROADMAP)")
        if t.dtype not in DTYPE_CODE:
            raise TypeError(f"{name}: unsupported dtype {t.dtype}")
        if max(t.shape) > _INT32_MAX:
            raise ValueError(f"{name}: a dimension above 2^31 - 1")
    if any(t.dtype != ts[0].dtype for t in ts):
        raise TypeError(f"{name}: mixed dtypes {[t.dtype for t in ts]}")
    if any(t.shape != ts[0].shape for t in ts):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in ts]}")


def _launch(fn_name: str, argtypes: tuple, like: torch.Tensor, *args) -> None:
    fn = kernel_function(fn_name, argtypes)
    with torch.cuda.device(like.device):
        rc = fn(DTYPE_CODE[like.dtype], *args, current_stream(like))
    check_launch(rc, fn_name)


def axpby(alpha, x: torch.Tensor, beta, y: torch.Tensor) -> torch.Tensor:
    """beta y + alpha x. CPU tensors take ``axpby_plain``; CUDA tensors
    launch K9's axpby or raise. ``axpby.launches`` counts launches."""
    if not on_cuda(x, y):
        return axpby_plain(alpha, x, beta, y)
    _check("axpby", x, y)
    a = device_scalar(alpha, y.dtype, y.device)
    b = device_scalar(beta, y.dtype, y.device)
    out = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    if out.numel():
        m, n = y.shape
        _launch("elx_ew_axpby", _AXPBY_ARGS, y, m, n, a.data_ptr(),
                x.data_ptr(), x.stride(0), x.stride(1), b.data_ptr(),
                y.data_ptr(), y.stride(0), y.stride(1), out.data_ptr())
        axpby.launches += 1
    return out


def scale(alpha, x: torch.Tensor) -> torch.Tensor:
    """alpha x. CPU tensors take ``scale_plain``; CUDA tensors launch K9's
    scale or raise. ``scale.launches`` counts launches."""
    if not on_cuda(x):
        return scale_plain(alpha, x)
    _check("scale", x)
    a = device_scalar(alpha, x.dtype, x.device)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel():
        m, n = x.shape
        _launch("elx_ew_scale", _SCALE_ARGS, x, m, n, a.data_ptr(),
                x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr())
        scale.launches += 1
    return out


def hadamard(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x * y entrywise. CPU tensors take ``hadamard_plain``; CUDA tensors
    launch K9's hadamard or raise. ``hadamard.launches`` counts launches."""
    if not on_cuda(x, y):
        return hadamard_plain(x, y)
    _check("hadamard", x, y)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel():
        m, n = x.shape
        _launch("elx_ew_hadamard", _HADAMARD_ARGS, x, m, n, x.data_ptr(),
                x.stride(0), x.stride(1), y.data_ptr(), y.stride(0),
                y.stride(1), out.data_ptr())
        hadamard.launches += 1
    return out


def fill(shape: Sequence[int], alpha, dtype: torch.dtype, device=None,
         extent: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """A ``shape`` array holding alpha on its ``extent`` = (m, n) corner
    (all of it by default) and 0 elsewhere. A CPU ``device`` takes
    ``fill_plain``; a CUDA one launches K9's fill or raises.
    ``fill.launches`` counts launches."""
    device = torch.device(device) if device is not None else torch.device(
        "cpu")
    if device.type != "cuda":
        return fill_plain(shape, alpha, dtype, device, extent)
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    _check("fill", out)
    m, n = extent if extent is not None else shape
    a = device_scalar(alpha, dtype, device)
    if out.numel():
        M, N = out.shape
        _launch("elx_ew_fill", _FILL_ARGS, out, M, N, max(min(m, M), 0),
                max(min(n, N), 0), a.data_ptr(), out.data_ptr())
        fill.launches += 1
    return out


def transpose(x: torch.Tensor, conjugate: bool = False) -> torch.Tensor:
    """x^T (x^H when ``conjugate``) as a fresh contiguous tensor. CPU
    tensors take ``transpose_plain``; CUDA tensors launch K9's tiled
    transpose or raise (the conjugate of a real tensor is its transpose).
    ``transpose.launches`` counts launches."""
    if not on_cuda(x):
        return transpose_plain(x, conjugate)
    _check("transpose", x)
    m, n = x.shape
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if out.numel():
        _launch("elx_ew_transpose", _TRANSPOSE_ARGS, x, m, n, x.data_ptr(),
                x.stride(0), x.stride(1), out.data_ptr())
        transpose.launches += 1
    return out


axpby.launches = 0
scale.launches = 0
hadamard.launches = 0
fill.launches = 0
transpose.launches = 0
