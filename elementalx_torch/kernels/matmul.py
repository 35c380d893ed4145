"""K1: the local GEMM, C = A @ B with a float32 accumulator.

Counterpart of ``elementalx/kernels/matmul.py`` (``matmul_pallas``, body
``_matmul_kernel``). The CUDA kernels are in ``csrc/matmul.cu`` and
``csrc/gemm_skinny.cu``; ``route`` picks one from dtype, shape and
alignment alone:

- ``"skinny"``: float32 and float64 products of at most ``SKINNY_N``
  columns, any strides and alignment, go to ``csrc/gemm_skinny.cu``,
  which streams A once at HBM bandwidth (``skinny_plan`` lays out the
  launch: a warp or a thread a row of C, 16-byte loads where A allows,
  K split where the rows alone would leave the card idle);
- ``"wgmma"``: bfloat16 operands that the TMA can read in place (a
  16-byte aligned base, one unit stride, the other stride a multiple of 16
  bytes; K = 0 reads nothing) go to the tensor cores, ``csrc/gemm_sm90.cuh``
  (TMA loads, a 4-stage shared-memory ring, wgmma, f32 accumulator);
- ``"fma_async"``: float32 operands with one unit stride each go to the
  FP32 FMA core fed by a cp.async ring, ``csrc/gemm_f32_pipe.cuh``, in
  16-byte copies where the operands are read so and in 4-byte copies
  otherwise (rows of 777 floats, an odd base); its result equals the
  ``"fma"`` core's bit for bit;
- ``"dmma"``: float64 operands with one unit stride each go to the FP64
  tensor cores, ``csrc/gemm_dmma.cuh`` (mma.sync m16n8k8 f64 fed by a
  cp.async ring, 16-byte copies where the operands allow them and 8-byte
  ones otherwise);
- ``"fma"``: everything else (float64 operands with no unit stride,
  bfloat16 operands the TMA cannot read, other operands with no unit
  stride) goes to the tiled FMA core of ``csrc/gemm_tile.cuh``.

The headers of ``csrc/matmul.cu`` and ``csrc/gemm_skinny.cu`` say what
bounds each on the H100.

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
import functools
from typing import Optional, Tuple

import torch

from .. import trace
from .common import DTYPE_CODE, Entry, cdiv, launch, on_cuda

_SUPPORTED = {
    (torch.float32, torch.float32),
    (torch.float64, torch.float64),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
}

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: each operand's pointer and strides, then (the cp.async and tensor
#: cores) whether it is read M- or N-major
_OPS = (_P, _L, _L) * 3
_MN_OPS = (_P, _L, _L, _I) * 2 + (_P, _L, _L)

#: the cores and the C entry of each
CORES = {"wgmma": Entry("elx_matmul_wgmma", (_I,) * 4 + _MN_OPS + (_P,)),
         "fma_async": Entry("elx_matmul_fma_async",
                            (_I,) * 3 + _MN_OPS + (_I, _P)),
         "dmma": Entry("elx_matmul_dmma", (_I,) * 3 + _MN_OPS + (_I, _P)),
         "fma": Entry("elx_matmul", (_I,) * 5 + _OPS + (_P,)),
         "skinny": Entry("elx_matmul_skinny",
                         (_I,) * 6 + _OPS + (_P, _I, _I, _P))}

#: the core for operands read in place in 16-byte pieces, by dtype (K8's
#: too)
FAST_CORE = {torch.bfloat16: "wgmma", torch.float32: "fma_async"}
#: K1's cores for operands with a unit stride each, in any alignment, by
#: dtype: the cp.async cores
ASYNC_CORE = {torch.float32: "fma_async", torch.float64: "dmma"}

#: the widest C the skinny route takes, and its types
SKINNY_N = 16
SKINNY_DTYPES = (torch.float32, torch.float64)
#: blocks of csrc/gemm_skinny.cu an SM holds (its launch bounds), and the
#: least k a slice of a split K takes
SKINNY_BLOCKS_PER_SM = 4
SKINNY_MIN_SLICE = 512


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


def unit_dim(x: torch.Tensor) -> Optional[int]:
    """The dimension over which the 2-D operand ``x`` has stride 1 (the
    one ``tma_unit_dim`` names where there is one), or None."""
    d = tma_unit_dim(x)
    if d is not None:
        return d
    for d in (1, 0):
        if x.stride(d) == 1:
            return d
    return None


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The K1 core a CUDA call C = A @ B takes, by dtype, shape and
    alignment alone: ``"skinny"`` for float32 and float64 with at most
    ``SKINNY_N`` columns; ``"wgmma"`` (tensor cores) for bfloat16 operands
    that can be read in place in 16-byte pieces; ``"fma_async"`` for
    float32 and ``"dmma"`` (FP64 tensor cores) for float64 operands with a
    unit stride each (any when K = 0, which reads nothing); else
    ``"fma"``. No device is needed: the CPU tests check it."""
    if (a.dtype in SKINNY_DTYPES and b.dtype == a.dtype
            and b.shape[1] <= SKINNY_N):
        return "skinny"
    fast = ASYNC_CORE.get(a.dtype) or FAST_CORE.get(a.dtype)
    if fast is None or b.dtype != a.dtype:
        return "fma"
    if a.shape[1] == 0:
        return fast
    if fast == "wgmma":
        unit = tma_unit_dim(a) is not None and tma_unit_dim(b) is not None
    else:
        unit = unit_dim(a) is not None and unit_dim(b) is not None
    return fast if unit else "fma"


def narrow_copies(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the cp.async cores (``"fma_async"``, ``"dmma"``) copy A
    and B one element at a time (4- or 8-byte copies) instead of in
    16-byte pieces: when K > 0 and an operand cannot be read in 16-byte
    pieces (``tma_unit_dim`` is None: a base off 16 bytes, or rows not
    16-byte multiples apart, such as rows of 777 floats or doubles). From
    the layout alone: the CPU tests check it."""
    return a.shape[1] > 0 and (tma_unit_dim(a) is None
                               or tma_unit_dim(b) is None)


def skinny_plan(a: torch.Tensor, sms: int) -> Tuple[int, int, int, int]:
    """(cols, vec, S, kslice): how the skinny route runs C = A @ B on a
    card of ``sms`` SMs. cols = 1 when A's m stride is the smaller (a
    thread a row of C, 256 rows a block), else 0 (a warp a row, 8 rows a
    block); vec = 1 for 16-byte loads (a warp a row, A's k stride 1, its
    base and row stride multiples of 16 bytes); where the rows give fewer
    blocks than ``sms`` x ``SKINNY_BLOCKS_PER_SM``, K is cut into S slices
    of kslice k (a multiple of 128, at least ``SKINNY_MIN_SLICE``),
    else S = 1 and kslice = K. Device-free: the CPU tests check it."""
    M, K = a.shape
    cols = int(a.stride(0) < a.stride(1))
    vec = int(not cols and a.stride(1) == 1 and a.data_ptr() % 16 == 0
              and (a.stride(0) * a.element_size()) % 16 == 0)
    blocks = cdiv(M, 256 if cols else 8)
    target = sms * SKINNY_BLOCKS_PER_SM
    if blocks >= target or K < 2 * SKINNY_MIN_SLICE:
        return cols, vec, 1, max(K, 1)
    S = min(cdiv(target, blocks), K // SKINNY_MIN_SLICE)
    kslice = cdiv(cdiv(K, S), 128) * 128
    return cols, vec, cdiv(K, kslice), kslice


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    entry = CORES[core]
    if core == "skinny":
        cols, vec, S, kslice = skinny_plan(a, _sm_count(c.get_device()))
        ws = (torch.empty((S, M, N), dtype=c.dtype, device=c.device)
              if S > 1 else None)
        launch(entry, c, DTYPE_CODE[a.dtype], cols, vec, M, N, K,
               a.data_ptr(), a.stride(0), a.stride(1),
               b.data_ptr(), b.stride(0), b.stride(1),
               c.data_ptr(), c.stride(0), c.stride(1),
               ws.data_ptr() if ws is not None else None, S, kslice)
        return c
    if core == "fma":
        launch(entry, c, DTYPE_CODE[a.dtype], DTYPE_CODE[out_dtype], M, N, K,
               a.data_ptr(), a.stride(0), a.stride(1),
               b.data_ptr(), b.stride(0), b.stride(1),
               c.data_ptr(), c.stride(0), c.stride(1))
        return c
    # each operand's layout: A M-major (unit stride sam), B N-major (unit
    # stride sbn), or else K-major
    a_mn = int(K > 0 and unit_dim(a) == 0)
    b_mn = int(K > 0 and unit_dim(b) == 1)
    ops = (a.data_ptr(), a.stride(0), a.stride(1), a_mn,
           b.data_ptr(), b.stride(0), b.stride(1), b_mn,
           c.data_ptr(), c.stride(0), c.stride(1))
    if core == "wgmma":
        launch(entry, c, DTYPE_CODE[out_dtype], M, N, K, *ops)
    else:
        # element-sized copies unless both operands are read in 16-byte
        # pieces
        launch(entry, c, M, N, K, *ops, int(narrow_copies(a, b)))
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
        trace.count(matmul, core)
    return c


def reset_launches() -> None:
    """Zero K1's launch counts (all cores)."""
    trace.reset_counts(matmul, CORES)


reset_launches()
