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
0-d tensors. A number goes to the kernel by value, rounded on the host to
the output's type exactly as ``torch.full`` rounds it (``host_scalar``),
so a call launches one kernel; a tensor is cast to the output's type on
the device and read there through its pointer (no host synchronisation).
bfloat16 computes in float32 and rounds once, as the plain versions do, so
kernel and plain version agree bit for bit. The wrappers launch through
``common.launch``, the lean host path.

Types on CUDA: float32, float64 and bfloat16. Complex input has no kernel
and raises ``NotImplementedError``; its CPU path works. The JAX package
falls back to jnp when alpha is traced or the shape is not (8, 128)-
tileable; on CUDA the port has no fallback.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence, Tuple

import torch

from .common import DTYPE_CODE, Entry, launch, on_cuda

_INT32_MAX = 2 ** 31 - 1
#: every K9 call goes through one C entry, its arguments packed into
#: csrc/elementwise.cu's EwCall: op, dtype, m, n, mv, nv, alpha (pointer,
#: value), x (pointer, two strides), beta (pointer, value), y (pointer, two
#: strides), out, stream
_EW = Entry("elx_ew", packed="<6qQdQ2qQdQ2q2Q")
_AXPBY, _SCALE, _HADAMARD, _FILL, _TRANSPOSE = range(5)

#: below this magnitude a float32 or bfloat16 rounding can neither
#: overflow nor meet torch's overflow check
_SAFE = 3.0e38
#: a float32 (struct rounds a double to it to nearest even) and its bits
_F32, _U32 = struct.Struct("<f"), struct.Struct("<I")


def device_scalar(v, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """v as a 0-d tensor of ``dtype`` on ``device``: a tensor is cast and
    moved (no host sync), a number is filled in on the device."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device, dtype=dtype).reshape(())
    return torch.full((), v, dtype=dtype, device=device)


def host_scalar(v, dtype: torch.dtype) -> float:
    """The Python number v rounded to ``dtype`` on the host exactly as
    ``torch.full((), v, dtype=dtype)`` rounds it, as a float: float64
    keeps it; float32 rounds it to nearest even; bfloat16 rounds it to
    float32 and then to bfloat16, both to nearest even (PyTorch's double
    rounding). NaN, infinities and magnitudes from 3e38 up go through
    ``torch.full`` on the CPU itself, which keeps its NaN, its overflow to
    inf and its overflow error."""
    f = float(v)
    if dtype is torch.float64:
        return f
    if not abs(f) < _SAFE:
        return torch.full((), f, dtype=dtype).item()
    f32 = _F32.pack(f)
    if dtype is torch.float32:
        return _F32.unpack(f32)[0]
    bits = _U32.unpack(f32)[0]
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return _F32.unpack(_U32.pack(bits))[0]


def _scalar(v, like: torch.Tensor):
    """(device pointer, value, holder) of a K9 scalar for a kernel writing
    like's type: a tensor is cast and moved to like's device (its pointer,
    0.0, and the cast tensor, which the caller keeps alive until the
    launch), a number rounded on the host (0, its value, None)."""
    if type(v) is not float and isinstance(v, torch.Tensor):
        t = device_scalar(v, like.dtype, like.device)
        return t.data_ptr(), 0.0, t
    return 0, host_scalar(v, like.dtype), None


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


def _check(name: str, x: torch.Tensor,
           y: Optional[torch.Tensor] = None) -> None:
    """Raise unless x (and y) are 2-D arrays of one dtype that K9 takes, of
    one shape with sides below 2^31."""
    ts = (x,) if y is None else (x, y)
    if (x.dim() == 2 and x.dtype in DTYPE_CODE
            and (y is None or (y.dtype is x.dtype and y.shape == x.shape))
            and max(x.shape) <= _INT32_MAX):
        return
    for t in ts:
        if t.dim() != 2:
            raise ValueError(f"{name}: 2-D tensors expected, got "
                             f"{t.dim()}-D")
        if t.is_complex():
            raise NotImplementedError(
                f"{name}: complex dtypes have no CUDA kernel yet (ROADMAP)")
        if t.dtype not in DTYPE_CODE:
            raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    if y is not None and y.dtype != x.dtype:
        raise TypeError(f"{name}: mixed dtypes {[t.dtype for t in ts]}")
    if y is not None and y.shape != x.shape:
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in ts]}")
    raise ValueError(f"{name}: a dimension above 2^31 - 1")


def axpby(alpha, x: torch.Tensor, beta, y: torch.Tensor) -> torch.Tensor:
    """beta y + alpha x. CPU tensors take ``axpby_plain``; CUDA tensors
    launch K9's axpby or raise. ``axpby.launches`` counts launches."""
    if not (x.is_cuda and y.is_cuda or on_cuda(x, y)):
        return axpby_plain(alpha, x, beta, y)
    _check("axpby", x, y)
    ap, av, ak = _scalar(alpha, y)
    bp, bv, bk = _scalar(beta, y)
    m, n = y.shape
    out = torch.empty_like(y, memory_format=torch.contiguous_format)
    if m and n:
        sx0, sx1 = x.stride()
        sy0, sy1 = y.stride()
        launch(_EW, y, _AXPBY, DTYPE_CODE[y.dtype], m, n, 0, 0, ap, av,
               x.data_ptr(), sx0, sx1, bp, bv, y.data_ptr(), sy0, sy1,
               out.data_ptr())
        axpby.launches += 1
    return out


def scale(alpha, x: torch.Tensor) -> torch.Tensor:
    """alpha x. CPU tensors take ``scale_plain``; CUDA tensors launch K9's
    scale or raise. ``scale.launches`` counts launches."""
    if not (x.is_cuda or on_cuda(x)):
        return scale_plain(alpha, x)
    _check("scale", x)
    ap, av, ak = _scalar(alpha, x)
    m, n = x.shape
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if m and n:
        sx0, sx1 = x.stride()
        launch(_EW, x, _SCALE, DTYPE_CODE[x.dtype], m, n, 0, 0, ap, av,
               x.data_ptr(), sx0, sx1, 0, 0.0, 0, 0, 0, out.data_ptr())
        scale.launches += 1
    return out


def hadamard(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x * y entrywise. CPU tensors take ``hadamard_plain``; CUDA tensors
    launch K9's hadamard or raise. ``hadamard.launches`` counts launches."""
    if not (x.is_cuda and y.is_cuda or on_cuda(x, y)):
        return hadamard_plain(x, y)
    _check("hadamard", x, y)
    m, n = x.shape
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if m and n:
        sx0, sx1 = x.stride()
        sy0, sy1 = y.stride()
        launch(_EW, x, _HADAMARD, DTYPE_CODE[x.dtype], m, n, 0, 0, 0, 0.0,
               x.data_ptr(), sx0, sx1, 0, 0.0, y.data_ptr(), sy0, sy1,
               out.data_ptr())
        hadamard.launches += 1
    return out


def fill(shape: Sequence[int], alpha, dtype: torch.dtype, device=None,
         extent: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """A ``shape`` array holding alpha on its ``extent`` = (m, n) corner
    (all of it by default) and 0 elsewhere. A CPU ``device`` takes
    ``fill_plain``; a CUDA one launches K9's fill or raises.
    ``fill.launches`` counts launches."""
    if type(device) is not torch.device:
        device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return fill_plain(shape, alpha, dtype, device, extent)
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    _check("fill", out)
    m, n = extent if extent is not None else shape
    ap, av, ak = _scalar(alpha, out)
    M, N = out.shape
    if M and N:
        launch(_EW, out, _FILL, DTYPE_CODE[dtype], M, N, max(min(m, M), 0),
               max(min(n, N), 0), ap, av, 0, 0, 0, 0, 0.0, 0, 0, 0,
               out.data_ptr())
        fill.launches += 1
    return out


def transpose(x: torch.Tensor, conjugate: bool = False) -> torch.Tensor:
    """x^T (x^H when ``conjugate``) as a fresh contiguous tensor. CPU
    tensors take ``transpose_plain``; CUDA tensors launch K9's tiled
    transpose or raise (the conjugate of a real tensor is its transpose).
    ``transpose.launches`` counts launches."""
    if not (x.is_cuda or on_cuda(x)):
        return transpose_plain(x, conjugate)
    _check("transpose", x)
    m, n = x.shape
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if m and n:
        sx0, sx1 = x.stride()
        launch(_EW, x, _TRANSPOSE, DTYPE_CODE[x.dtype], m, n, 0, 0, 0, 0.0,
               x.data_ptr(), sx0, sx1, 0, 0.0, 0, 0, 0, out.data_ptr())
        transpose.launches += 1
    return out


axpby.launches = 0
scale.launches = 0
hadamard.launches = 0
fill.launches = 0
transpose.launches = 0
