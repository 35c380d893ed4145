"""K4: the partial-pivoted LU of a tall panel, rows kept in place.

Counterpart of ``elementalx/kernels/getrf.py`` (``getrf_panel``, body
``_getrf_kernel``, and ``pallas_getrf``). The CUDA kernel is
``csrc/getrf.cu``; its header says why the TPU design (the transposed
panel in VMEM, one-hot MXU gathers) does not carry over, what bounds the
kernel on the H100 (a chain of one dependent pivot search a column) and
what each route gives up.

Two routes, chosen by ``route`` from the shape and dtype alone:
"cluster" (one thread-block cluster of ``cluster_ctas(Mt, dtype)`` CTAs
holds a 32-column group of all Mt rows in its shared memory, one cluster
barrier a column) wherever that fits, and "grid" (the first design: a
cooperative launch, one ``grid.sync()`` a column) for taller panels.
``getrf_panel.launches_<route>`` count each route, ``.launches`` their
sum.

``getrf_panel(a)`` returns ``(out, piv)`` with the contract of the JAX
kernel: rows stay in their original positions; the row elected for column
j (``piv[j]``) holds its U row from column j on and its multipliers
before it; a row never elected holds w multipliers. Pivots are the
largest magnitude among the rows not yet elected, the lowest row on equal
magnitudes; a zero pivot divides by 1. ``packed_getrf`` gathers that into
the LAPACK packed layout and the logical -> original row map.

Unlike the TPU kernel (f32, 128-multiples, at most 8 MB) the CUDA kernel
takes float32 and float64 panels of any (Mt, w) with Mt >= w. Complex
panels have no CUDA kernel yet; their CPU path works.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .. import trace
from .common import (
    DTYPE_CODE,
    check_launch,
    current_stream,
    kernel_function,
    on_cuda,
)

#: columns of one group and most CTAs of a group launch (kNB, kMaxGrid in
#: csrc/getrf.cu)
GROUP = 32
MAX_GRID = 1024

_ARGTYPES = (ctypes.c_int,) * 5 + (ctypes.c_void_p,) * 10

ROUTES = ("cluster", "grid")
_ROUTE_CODE = {"grid": 0, "cluster": 1}
#: the shared memory a CTA of the H100 may ask for (227 KB), the most CTAs
#: a cluster may have (16, the non-portable size), and room left for the
#: cluster kernel's static shared memory
SMEM_OPTIN = 232448
MAX_CLUSTER = 16
_STATIC_SMEM = 12288


def cluster_ctas(Mt: int, dtype: torch.dtype) -> int:
    """CTAs of the cluster route for an (Mt, w) panel: the power of two
    that gives each CTA about 512 rows (at most 16: at Mt = 8192, 16 CTAs
    of 512 rows ran 1.91 ms against 8 of 1024 rows' 2.40, NVIDIA H100
    80GB HBM3 at 700 W, probes/k4_k6.py), doubled until a CTA's rows of
    one group (33 words a row and a flag byte) fit in shared memory; 0
    when not even 16 CTAs hold them (the grid route)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    c = 1
    while c < min(-(-Mt // 512), MAX_CLUSTER):
        c *= 2
    while True:
        rpc = -(-Mt // c)
        if rpc * ((GROUP + 1) * itemsize + 1) + _STATIC_SMEM <= SMEM_OPTIN:
            return c
        if c == MAX_CLUSTER:
            return 0
        c *= 2


def route(Mt: int, dtype: torch.dtype) -> str:
    """The K4 route for an (Mt, w) panel in dtype."""
    return "cluster" if cluster_ctas(Mt, dtype) else "grid"


def lu_plain(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """LAPACK getrf through ``torch.linalg.lu_factor_ex``: ``(packed,
    lperm)`` with rows in pivoted order and ``lperm`` the logical ->
    original row map, as ``jax.lax.linalg.lu`` returns ``(lu, _, perm)``.
    A singular panel factors without error, its zero pivots leaving their
    column unscaled. The swap sequence becomes a permutation on the host
    (O(w) steps)."""
    Mt, w = a.shape
    packed, swaps, _ = torch.linalg.lu_factor_ex(a)
    perm = np.arange(Mt)
    for j, s in enumerate(swaps.cpu().numpy() - 1):
        perm[j], perm[s] = perm[s], perm[j]
    return packed, torch.as_tensor(perm, device=a.device)


def getrf_panel_plain(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K4: ``lu_plain`` with its rows put back
    in their original positions, and the elected rows as ``piv``."""
    packed, lperm = lu_plain(a)
    out = torch.empty_like(packed)
    out[lperm] = packed
    return out, lperm[: a.shape[1]]


def _check(a: torch.Tensor) -> None:
    if a.dim() != 2 or a.shape[0] < a.shape[1]:
        raise ValueError(f"getrf_panel: a tall (Mt, w) panel with Mt >= w "
                         f"expected, got {tuple(a.shape)}")
    if a.is_complex():
        raise NotImplementedError(
            "getrf_panel: complex dtypes have no CUDA kernel yet (ROADMAP)")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"getrf_panel: unsupported dtype {a.dtype}")


def _launch(rt: str, a: torch.Tensor, csize: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K4 call on route ``rt`` (the cluster route with ``csize`` CTAs,
    ``cluster_ctas`` when 0), counted on that route. ``getrf_panel`` calls
    it with ``route``'s choice; tests and probes hold the routes and
    cluster sizes against each other with it."""
    _check(a)
    Mt, w = a.shape
    dev, dt = a.device, a.dtype
    if rt == "cluster":
        csize = csize or cluster_ctas(Mt, dt)
        if not 1 <= csize <= MAX_CLUSTER:
            raise ValueError(f"getrf_panel: no cluster route for Mt={Mt} "
                             f"in {dt}")
    out = a.clone(memory_format=torch.contiguous_format)  # factored in place
    piv = torch.empty((w,), dtype=torch.int32, device=dev)
    used = torch.empty((Mt,), dtype=torch.int32, device=dev)
    mbuf = torch.empty((Mt, GROUP), dtype=dt, device=dev)
    ubuf = torch.empty((GROUP, w), dtype=dt, device=dev)
    grid_scratch = [0, 0, 0, 0]
    if rt == "grid":
        grid_scratch = [
            torch.empty((2, MAX_GRID, GROUP), dtype=dt, device=dev),
            torch.empty((2, MAX_GRID), dtype=dt, device=dev),
            torch.empty((2, MAX_GRID), dtype=torch.int32, device=dev),
            # the rows' group columns, where a CTA's share exceeds shared
            # memory
            torch.empty(((Mt + MAX_GRID) * (GROUP + 1),), dtype=dt,
                        device=dev)]
    ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else None
            for x in grid_scratch]
    fn = kernel_function("elx_getrf_panel", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(_ROUTE_CODE[rt], csize, DTYPE_CODE[dt], Mt, w,
                out.data_ptr(), piv.data_ptr(), used.data_ptr(),
                mbuf.data_ptr(), ubuf.data_ptr(), *ptrs, current_stream(a))
    check_launch(rc, "elx_getrf_panel")
    trace.count(getrf_panel, rt)
    return out, piv.long()


def getrf_panel(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, piv) of a panel, rows in place. CPU tensors take
    ``getrf_panel_plain``; CUDA tensors launch the K4 kernel on
    ``route``'s choice or raise. ``a`` is not written."""
    if not on_cuda(a):
        return getrf_panel_plain(a)
    _check(a)
    return _launch(route(a.shape[0], a.dtype), a)


def reset_launches() -> None:
    """Zero K4's launch counts (every route and the sum)."""
    trace.reset_counts(getrf_panel, ROUTES)


reset_launches()


def packed_getrf(sl: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """LAPACK-packed pivoted LU of a panel through ``getrf_panel``:
    ``(packed, lperm)`` with the ``_getrf`` contract of lapack/lu.py —
    ``packed`` rows in pivoted order (U on and above the diagonal of the
    first w rows, unit-L multipliers below), ``lperm`` the elected rows
    followed by the others in ascending order. The counterpart of
    ``pallas_getrf``.

    ``lperm`` is built on the device and the host never waits for it: the
    elected flags are written by ``index_fill_``, whose 1 travels as a
    kernel argument (``elected[piv] = 1`` would copy it from pageable
    host memory, which waits for the stream to drain), and the rows never
    elected come from a sort, not from ``torch.nonzero``."""
    Mt, w = sl.shape
    out, piv = getrf_panel(sl)
    elected = torch.zeros((Mt,), dtype=torch.int8, device=sl.device)
    elected.index_fill_(0, piv, 1)
    # a stable sort puts the rows never elected first, in ascending order
    rest = torch.argsort(elected, stable=True)[: Mt - w]
    lperm = torch.cat([piv, rest])
    return out[lperm], lperm
