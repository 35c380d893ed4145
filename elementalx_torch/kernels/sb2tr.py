"""K6: the band -> tridiagonal bulge chase of the SBR reduction.

Counterpart of ``elementalx/kernels/sb2tr.py`` (``sb2tr``, body
``_sb2tr_kernel``). The CUDA kernel is ``csrc/sb2tr.cu``; its header says
why the TPU design (the whole band in VMEM, an 8x8 ring of blocks in a
pre-shifted store) does not carry over, how the sweeps are pipelined
across SMs (a lag of two ops between consecutive sweeps, derived from the
windows) and what bounds it.

Two routes, chosen by ``route`` from b and the dtype alone: "cluster"
(one thread-block cluster of ``cluster_size(b, dtype)`` CTAs a sweep, the
window's rows in the CTAs' shared memory) wherever its three blocks of
ceil(b / C) x b words fit in a CTA's shared memory, and "l2" (the first
design: one block a sweep, every pass through L2) for wider float64
bands. ``sb2tr.launches_<route>`` count each route, ``sb2tr.launches``
their sum.

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

from .. import trace
from .common import DTYPE_CODE, Entry, launch, on_cuda

_ENTRY = Entry("elx_sb2tr", (ctypes.c_int,) * 6 + (ctypes.c_void_p,) * 4)

ROUTES = ("cluster", "l2")
_ROUTE_CODE = {"l2": 0, "cluster": 1}
#: threads of a cluster CTA (kCT in csrc/sb2tr.cu) and the shared memory a
#: CTA of the H100 may ask for (227 KB)
_CLUSTER_THREADS = 512
SMEM_OPTIN = 232448
#: the most CTAs a cluster may have (16 with the non-portable size)
MAX_CLUSTER = 16


def _cluster_smem(b: int, rows: int, itemsize: int) -> int:
    """cluster_smem in csrc/sb2tr.cu: bytes of shared memory a CTA of the
    cluster route asks for."""
    return 16 + itemsize * (3 * rows * b + 6 * b + 2 * rows + 3
                            + _CLUSTER_THREADS // 32)


def cluster_size(b: int, dtype: torch.dtype) -> int:
    """CTAs a sweep on the cluster route: the power of two that gives each
    CTA about 32 rows of the window (8 at b = 256, 4 at b = 128, 1 up to
    b = 32), doubled until the three blocks fit in shared memory; 0 when
    not even 16 do (the l2 route)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    c = 1
    while c < -(-b // 32):
        c *= 2
    c = min(c, MAX_CLUSTER)
    while _cluster_smem(b, -(-b // c), itemsize) > SMEM_OPTIN:
        if c == MAX_CLUSTER:
            return 0
        c *= 2
    return c


def route(b: int, dtype: torch.dtype) -> str:
    """The K6 route for a band of width b in dtype."""
    return "cluster" if cluster_size(b, dtype) else "l2"


def chain_ops(n: int, b: int, lag: int = 2) -> int:
    """Ops on the critical path of the chase when op (j, s) waits for op
    (j-1, s+lag-1) and op (j, s-1): the longest chain of the dependency
    graph (B's corner wait is not counted)."""
    from ..lapack.sbr import chase_ops

    prev = []
    for j in range(max(n - 2, 0)):
        ops = chase_ops(n, b, j)
        cur, t = [], 0
        for s in range(ops):
            dep = prev[min(s + lag - 1, len(prev) - 1)] if prev else 0
            t = max(t, dep) + 1
            cur.append(t)
        prev = cur
    return prev[-1] if prev else 0


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


def _launch(rt: str, a_band: torch.Tensor, b: int, csize: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One K6 launch on route ``rt`` (for the cluster route with
    ``csize`` CTAs a cluster, ``cluster_size`` when 0), counted on that
    route. ``sb2tr`` calls it with ``route``'s choice on a checked band;
    tests and probes hold routes and cluster sizes against each other with
    it."""
    from ..lapack.sbr import chase_smax

    if rt == "cluster":
        csize = csize or cluster_size(b, a_band.dtype)
        if not 1 <= csize <= MAX_CLUSTER:
            raise ValueError(f"sb2tr: no cluster route for b={b} in "
                             f"{a_band.dtype}")
    n = a_band.shape[0]
    smax = chase_smax(n, b)
    work = a_band.clone(memory_format=torch.contiguous_format)
    vout = torch.zeros((n, smax, b), dtype=a_band.dtype,
                       device=a_band.device)
    flags = torch.zeros((2 * n + 1,), dtype=torch.int32,
                        device=a_band.device)
    launch(_ENTRY, work, _ROUTE_CODE[rt], csize, DTYPE_CODE[a_band.dtype], n,
           b, smax, work.data_ptr(), vout.data_ptr(), flags.data_ptr())
    trace.count(sb2tr, rt)
    return vout, torch.diagonal(work).clone(), torch.diagonal(work, -1).clone()


def sb2tr(a_band: torch.Tensor, b: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(vout, d, e) of the chase. CPU tensors take ``sb2tr_plain``; CUDA
    tensors launch the K6 kernel on ``route``'s choice or raise.
    ``a_band`` is not written."""
    if not on_cuda(a_band):
        return sb2tr_plain(a_band, b)
    _check(a_band, b)
    return _launch(route(b, a_band.dtype), a_band, b)


def reset_launches() -> None:
    """Zero K6's launch counts (every route and the sum)."""
    trace.reset_counts(sb2tr, ROUTES)


reset_launches()
