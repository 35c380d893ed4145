"""K6: the band -> tridiagonal bulge chase of the SBR reduction.

Counterpart of ``elementalx/kernels/sb2tr.py`` (``sb2tr``, body
``_sb2tr_kernel``). The CUDA kernel is ``csrc/sb2tr.cu``; its header says
why the TPU design (the whole band in VMEM, an 8x8 ring of blocks in a
pre-shifted store) does not carry over, how the sweeps are pipelined
across SMs (the lag of three ops between consecutive sweeps, derived from
the windows) and what bounds it.

``sb2tr(a_band, b)`` returns ``(vout, d, e)``: the chase reflectors
``vout`` (n, smax, b) with ``vout[j, s] = [tau | v[1:]]`` in exactly the
op order and windows of ``lapack/sbr._sb2tr_dense`` (``_apply_q2``'s
diamond grouping relies on that order), and the tridiagonal (d, e). The
input is the dense symmetric band matrix (n, n) that ``band_reduce``
returns; its lower triangle is read. The TPU kernel's pre-shifted input
store (``sbr._band_to_ds``) is a layout for its lane rotations and has no
counterpart here.

Unlike the TPU kernel (float32, b % 128 == 0) the CUDA kernel takes
float32 and float64 and any b >= 2.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .common import (
    DTYPE_CODE,
    check_launch,
    current_stream,
    kernel_function,
    on_cuda,
)

_ARGTYPES = (ctypes.c_int,) * 4 + (ctypes.c_void_p,) * 4


def sb2tr_plain(a_band: torch.Tensor, b: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K6: ``lapack.sbr._sb2tr_dense`` in
    K6's output contract."""
    from ..lapack.sbr import _sb2tr_dense

    a_tri, vout = _sb2tr_dense(a_band, b)
    return vout, torch.diagonal(a_tri).clone(), \
        torch.diagonal(a_tri, -1).clone()


def _check(a: torch.Tensor, b: int) -> None:
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"sb2tr: a square band matrix expected, got "
                         f"{tuple(a.shape)}")
    if a.is_complex():
        raise NotImplementedError(
            "sb2tr: complex dtypes have no CUDA kernel (ROADMAP)")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sb2tr: unsupported dtype {a.dtype}")
    if b < 2:
        raise ValueError(f"sb2tr: bandwidth b >= 2 expected, got {b}")


def sb2tr(a_band: torch.Tensor, b: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(vout, d, e) of the chase. CPU tensors take ``sb2tr_plain``; CUDA
    tensors launch the K6 kernel or raise. ``sb2tr.launches`` counts
    kernel launches. ``a_band`` is not written."""
    from ..lapack.sbr import chase_smax

    if not on_cuda(a_band):
        return sb2tr_plain(a_band, b)
    _check(a_band, b)
    n = a_band.shape[0]
    smax = chase_smax(n, b)
    work = a_band.clone(memory_format=torch.contiguous_format)
    vout = torch.zeros((n, smax, b), dtype=a_band.dtype,
                       device=a_band.device)
    progress = torch.zeros((n,), dtype=torch.int32, device=a_band.device)
    fn = kernel_function("elx_sb2tr", _ARGTYPES)
    with torch.cuda.device(a_band.device):
        rc = fn(DTYPE_CODE[a_band.dtype], n, b, smax, work.data_ptr(),
                vout.data_ptr(), progress.data_ptr(), current_stream(work))
    check_launch(rc, "elx_sb2tr")
    sb2tr.launches += 1
    return vout, torch.diagonal(work).clone(), torch.diagonal(work, -1).clone()


sb2tr.launches = 0
