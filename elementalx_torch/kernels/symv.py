"""K7: the symmetric matrix-vector product from the lower triangle.

Counterpart of ``elementalx/kernels/symv.py`` (``symv_lower`` and
``symv_lower_trailing``, TPU kernel ``_symv_lower_tpu`` with body
``_symv_kernel``). The CUDA kernels are in ``csrc/symv.cu``, one
cooperative launch over the lower triangle on one of the two cores
that ``route`` picks from dtype and layout alone:

- ``"tma"``: the H100 design (``SymvTiles`` of ``csrc/symv_unit.cuh``,
  which K5 runs too): 64 x 64 tiles through a TMA ring in shared memory,
  each used for both of its products. TMA reads A in place when its row
  stride is a multiple of 16 bytes, at any offset: a slice such as
  ``a[k0:, k0:]`` is read through a tensor map over the parent's storage;
- ``"async"``: any other row stride: the same tiles, walk and sums,
  the ring filled by cp.async (4-byte copies, or 8-byte ones where A's
  base and rows allow them, ``copy_bytes``) instead of TMA boxes; on a
  matrix whose base is 16-byte aligned it gives the ``"tma"`` core's bits
  on a copy with 16-byte rows.

The first design, the scalar symv unit (``"unit"``), is no route's any
more; ``_launch("unit", ...)`` still runs it, to be timed in turns.

The header of ``csrc/symv.cu`` says what bounds them on the H100 (the
bytes of the lower triangle) and how they sum without float atomics.

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

from .. import trace
from .common import DTYPE_CODE, Entry, cooperative_grid, launch, on_cuda
from .common import raw_stream

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_UNIT = Entry("elx_symv_lower", (_I, _I, _P, _L, _P, _P, _P, _I, _P))
_TMA = Entry("elx_symv_lower_tma", (_I, _I, _P, _I, _L, _P, _P, _P, _I, _P))
_ASYNC = Entry("elx_symv_lower_async",
               (_I, _I, _P, _I, _L, _I, _P, _P, _P, _I, _P))

#: the cores and the C entry that sizes each one's grid
CORES = {"tma": "elx_symv_tma_grid", "async": "elx_symv_async_grid",
         "unit": "elx_symv_grid"}


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


def _readable(A: torch.Tensor) -> bool:
    """A is read in place: unit column stride, rows at least n apart."""
    return A.stride(1) == 1 and A.stride(0) >= A.shape[0]


def route(A: torch.Tensor) -> str:
    """The K7 core a CUDA call on A takes, by dtype and layout alone:
    ``"tma"`` when the row stride of the matrix the kernel reads (A in
    place, or its contiguous copy when A's columns are not unit-stride) is
    a multiple of 16 bytes, else ``"async"``. The base's alignment does
    not matter to ``"tma"``: the tensor map starts at the 16-byte boundary
    at or before A's first element. No device is needed: the CPU tests
    check it."""
    lda = A.stride(0) if _readable(A) else A.shape[0]
    return "tma" if (lda * A.element_size()) % 16 == 0 else "async"


def copy_bytes(A: torch.Tensor) -> int:
    """The bytes of each cp.async copy of the ``"async"`` core on A (read
    in place): 8 where A's base is 8-byte aligned and its rows are 8-byte
    multiples apart (float32 pairs; float64 always), else 4. From the
    layout alone: the CPU tests check it."""
    elem = A.element_size()
    if elem == 8 or (A.data_ptr() % 8 == 0
                     and (A.stride(0) * elem) % 8 == 0):
        return 8
    return 4


#: ypart scratch per (device index, dtype, stream): every block of either
#: core zeroes its own partial before use, so calls on one stream may
#: share it
_WORKSPACE: dict = {}


def _workspace(A: torch.Tensor, G: int, n: int, stream: int) -> torch.Tensor:
    key = (A.get_device(), A.dtype, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < G * n:
        ws = _WORKSPACE[key] = torch.empty((G * n,), dtype=A.dtype,
                                           device=A.device)
    return ws


def _launch(core: str, A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch K7's ``core`` on CUDA A (read in place) and v; return y.
    Counts nothing (a test may hold the cores against each other)."""
    n = A.shape[0]
    y = torch.empty((n,), dtype=A.dtype, device=A.device)
    if n == 0:
        return y
    G = cooperative_grid(CORES[core], A)
    ws = _workspace(A, G, n, raw_stream(A))
    elem = A.element_size()
    ptr = A.data_ptr()
    # the tile geometry's offset: A's columns after the 16-byte boundary
    c0 = (ptr % 16) // elem
    if core == "tma":
        launch(_TMA, A, DTYPE_CODE[A.dtype], n, ptr - c0 * elem, c0,
               A.stride(0), v.data_ptr(), y.data_ptr(), ws.data_ptr(), G)
    elif core == "async":
        launch(_ASYNC, A, DTYPE_CODE[A.dtype], n, ptr, c0, A.stride(0),
               copy_bytes(A), v.data_ptr(), y.data_ptr(), ws.data_ptr(), G)
    else:
        launch(_UNIT, A, DTYPE_CODE[A.dtype], n, A.data_ptr(), A.stride(0),
               v.data_ptr(), y.data_ptr(), ws.data_ptr(), G)
    return y


def symv_lower(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = H v from the lower triangle of A. CPU tensors take
    ``symv_lower_plain``; CUDA tensors launch the K7 kernel of
    ``route(A)`` or raise. ``symv_lower.launches_<core>`` counts each
    core's launches, ``symv_lower.launches`` all of them (those of
    ``symv_lower_trailing`` included; ``reset_launches`` zeroes them)."""
    if not on_cuda(A, v):
        return symv_lower_plain(A, v)
    _check(A, v)
    if not _readable(A):
        A = A.contiguous()
    v = v.contiguous()
    core = route(A)
    y = _launch(core, A, v)
    if A.shape[0]:
        trace.count(symv_lower, core)
    return y


def reset_launches() -> None:
    """Zero K7's launch counts (every core)."""
    trace.reset_counts(symv_lower, CORES)


reset_launches()


def symv_lower_trailing(a: torch.Tensor, v: torch.Tensor,
                        k0: int) -> torch.Tensor:
    """H v over the trailing block ``a[k0:, k0:]`` (lower triangle read),
    given the local vector v of length M - k0. The block is read in place
    at k0 exactly, through its row stride."""
    return symv_lower(a[k0:, k0:], v)
