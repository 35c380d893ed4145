"""K3a, K3b and K3c: the Cholesky diagonal block and the fused panel tail.

K3a is the counterpart of ``elementalx/kernels/potrf.py:potrf_block_inv``
(body ``_potrf_diag_kernel``). ``potrf_block_inv(sym)`` returns ``(l11,
invLH)``: ``l11`` the lower Cholesky factor of the symmetric block (only
its lower triangle is read) with exact zeros above the diagonal, and
``invLH = inv(l11)^H``. A block that is not numerically positive definite
poisons both outputs with NaN. Any order w >= 1, float32 and float64; the
CUDA kernel reads a contiguous copy of the block (the driver hands it a
freshly symmetrized one).

K3b and K3c are the counterparts of ``potrf_panel_tail`` (body
``_potrf_kernel``) and ``potrf_panel_tail_full`` (body
``_potrf_kernel_full``): the whole panel tail [L11; L21 = A21 inv(L11)^H]
in one C entry of ``csrc/potrf_tail.cu``. K3c is K3b on the full-height
column with zeros above the diagonal tile. Unlike the TPU kernels
(float32, Mt and w multiples of 128) they take any (Mt, w), float32 and
float64; ``low_apply`` (float32 only) rounds both operands of the L21
product to bfloat16. A block that is not positive definite poisons every
row from the diagonal tile down with NaN (the JAX kernel poisons some
columns).

Each has two routes; ``route(w, dtype)`` picks one from w and the dtype
alone, the same for K3a and K3b:

- ``"cluster"`` (w <= ``CLUSTER_MAX_W[dtype]``: 512 in float32, 384 in
  float64): one launch. One thread-block cluster of ceil(w / 32) CTAs
  holds the block on chip and factors it 32 columns a step, two cluster
  barriers a step, building inv(L11) row-block by row-block as it goes
  (``csrc/potrf.cu``); for K3b the launch's other CTAs form each column
  block of L21 as soon as its row-block of inv(L11) is published
  (``csrc/potrf_tail.cu``).
- ``"blocked"`` (wider blocks): left-looking over diagonal blocks of
  ``CLUSTER_MAX_W``, each on the cluster kernel, the history products and
  the inverse's off-diagonal blocks on K1's cores; for K3b, then L21 in
  one product.

``<wrapper>.launches_<route>`` count each route's launches,
``.launches`` their sum; ``reset_launches()`` zeroes them all. The
scratch of a call (the routes' flags and products, K3b's inv(L11)^H) is
cached per (device, stream, dtype, w, route) in ``_SCRATCH``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import trace
from .common import DTYPE_CODE, Entry, launch, on_cuda, raw_stream

#: widest block the cluster route holds on chip (kClusterMaxW in
#: csrc/potrf_cluster.cuh), and the diagonal blocks of the blocked route
CLUSTER_MAX_W = {torch.float32: 512, torch.float64: 384}

#: elements of the factor CTAs' exchange tiles (kExchange in
#: csrc/potrf_cluster.cuh: 17 tiles of 32 x 32)
EXCHANGE = 17 * 32 * 32

ROUTES = TAIL_ROUTES = ("cluster", "blocked")
_ROUTE_CODE = {"cluster": 1, "blocked": 2}

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_BLOCK_INV = Entry("elx_potrf_block_inv",
                   (_I, _I, _I, _P, _L, _P, _P, _P, _P, _P))
_TAIL = Entry("elx_potrf_panel_tail",
              (_I,) * 6 + (_P, _L, _P, _L, _L, _P, _P, _P, _P))


def route(w: int, dtype: torch.dtype) -> str:
    """The route a CUDA call of K3a or K3b on a (w, w) diagonal block of
    ``dtype`` takes: ``"cluster"`` up to ``CLUSTER_MAX_W[dtype]``, else
    ``"blocked"``."""
    return "cluster" if w <= CLUSTER_MAX_W[dtype] else "blocked"


def workspace(tail: bool, rt: str, w: int, dtype: torch.dtype
              ) -> Tuple[int, int]:
    """(elements of dtype, int32 flags) of scratch a call on route ``rt``
    needs, as the C entries split it: the factor CTAs' exchange tiles
    (``EXCHANGE``), the blocked route's panel and product buffers (w x
    CLUSTER_MAX_W each), K3b's inv(L11)^T (w x w), and five counters
    (csrc/potrf_cluster.cuh)."""
    elems = EXCHANGE + (w * w if tail else 0) + (
        2 * w * CLUSTER_MAX_W[dtype] if rt == "blocked" else 0)
    return elems, 5


#: cached scratch: (tail, route, device index, stream, dtype, w) ->
#: (elements, flags)
_SCRATCH: dict = {}


def _scratch(tail: bool, rt: str, t: torch.Tensor, w: int, stream: int):
    key = (tail, rt, t.get_device(), stream, t.dtype, w)
    got = _SCRATCH.get(key)
    if got is None:
        elems, ints = workspace(tail, rt, w, t.dtype)
        got = _SCRATCH[key] = (
            torch.empty((max(elems, 1),), dtype=t.dtype, device=t.device),
            torch.zeros((ints,), dtype=torch.int32, device=t.device))
    return got


def potrf_block_inv_plain(sym: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K3a: ``torch.linalg.cholesky_ex`` plus
    a triangular inverse, with the same NaN poisoning."""
    l11, info = torch.linalg.cholesky_ex(sym)
    eye = torch.eye(sym.shape[0], dtype=sym.dtype, device=sym.device)
    inv = torch.linalg.solve_triangular(l11, eye, upper=False)
    bad = info != 0
    nan = torch.full((), float("nan"), dtype=sym.dtype, device=sym.device)
    return (torch.where(bad, nan, l11),
            torch.where(bad, nan, inv.mH))


def _check(sym: torch.Tensor) -> None:
    if sym.dim() != 2 or sym.shape[0] != sym.shape[1]:
        raise ValueError(f"potrf_block_inv: square block expected, got "
                         f"{tuple(sym.shape)}")
    if sym.is_complex():
        raise NotImplementedError(
            "potrf_block_inv: complex dtypes have no CUDA kernel yet "
            "(ROADMAP)")
    if sym.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"potrf_block_inv: unsupported dtype {sym.dtype}")


def _launch(rt: str, sym: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K3a call on route ``rt`` (a CUDA block that ``_check`` passes),
    counted on that route. ``potrf_block_inv`` calls it with ``route``'s
    choice; tests and chip_smoke.py hold the routes against each other
    with it."""
    w = sym.shape[0]
    if w == 0:
        return torch.empty_like(sym), torch.empty_like(sym)
    if rt == "cluster" and w > CLUSTER_MAX_W[sym.dtype]:
        raise ValueError(f"potrf_block_inv: no cluster route for w={w} in "
                         f"{sym.dtype}")
    sym = sym.contiguous()
    l11 = torch.empty((w, w), dtype=sym.dtype, device=sym.device)
    inv_lh = torch.empty((w, w), dtype=sym.dtype, device=sym.device)
    ws, flags = _scratch(False, rt, sym, w, raw_stream(sym))
    launch(_BLOCK_INV, sym, _ROUTE_CODE[rt], DTYPE_CODE[sym.dtype], w,
           sym.data_ptr(), sym.stride(0), l11.data_ptr(), inv_lh.data_ptr(),
           ws.data_ptr(), flags.data_ptr())
    trace.count(potrf_block_inv, rt)
    return l11, inv_lh


def potrf_block_inv(sym: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(l11, inv(l11)^H) of a symmetric block. CPU tensors take
    ``potrf_block_inv_plain``; CUDA tensors launch the K3a kernel on
    ``route``'s choice or raise."""
    if not on_cuda(sym):
        return potrf_block_inv_plain(sym)
    _check(sym)
    return _launch(route(sym.shape[0], sym.dtype), sym)


# ---------------------------------------------------------------------------
# K3b and K3c: the fused panel tail (csrc/potrf_tail.cu)
# ---------------------------------------------------------------------------

def _apply_plain(pan21: torch.Tensor, inv_lh: torch.Tensor,
                 low_apply: bool) -> torch.Tensor:
    """L21 = pan21 inv_lh; with ``low_apply`` both operands rounded to
    bfloat16 (nearest even) and the products summed in float32."""
    if low_apply:
        return pan21.bfloat16().float() @ inv_lh.bfloat16().float()
    return pan21 @ inv_lh


def potrf_panel_tail_plain(sym_a11: torch.Tensor, pan: torch.Tensor,
                           low_apply: bool = False) -> torch.Tensor:
    """The plain PyTorch version of K3b: K3a's plain version for the
    diagonal block, then one product for the rows below it."""
    w = sym_a11.shape[0]
    l11, inv_lh = potrf_block_inv_plain(sym_a11)
    out = torch.empty(pan.shape, dtype=pan.dtype, device=pan.device)
    out[:w] = l11
    out[w:] = _apply_plain(pan[w:], inv_lh, low_apply)
    return out


def potrf_panel_tail_full_plain(sym_a11: torch.Tensor,
                                pan_full: torch.Tensor, kidx: int,
                                low_apply: bool = False) -> torch.Tensor:
    """The plain PyTorch version of K3c: zeros above tile ``kidx``, then
    K3b's plain version on the rows from there."""
    r0 = int(kidx) * sym_a11.shape[0]
    out = torch.zeros(pan_full.shape, dtype=pan_full.dtype,
                      device=pan_full.device)
    out[r0:] = potrf_panel_tail_plain(sym_a11, pan_full[r0:], low_apply)
    return out


def _check_tail(sym: torch.Tensor, pan: torch.Tensor, r0: int,
                low_apply: bool, name: str) -> None:
    if sym.dim() != 2 or sym.shape[0] != sym.shape[1] or pan.dim() != 2:
        raise ValueError(f"{name}: a square block and a 2-D panel expected, "
                         f"got {tuple(sym.shape)} and {tuple(pan.shape)}")
    w = sym.shape[0]
    if w == 0 or pan.shape[1] != w or r0 < 0 or r0 + w > pan.shape[0]:
        raise ValueError(f"{name}: the panel {tuple(pan.shape)} has no "
                         f"({w}, {w}) diagonal block at row {r0}")
    if sym.is_complex() or pan.is_complex():
        raise NotImplementedError(
            f"{name}: complex dtypes have no CUDA kernel yet (ROADMAP)")
    if sym.dtype not in (torch.float32, torch.float64) \
            or pan.dtype != sym.dtype:
        raise TypeError(f"{name}: unsupported dtypes {sym.dtype}, "
                        f"{pan.dtype}")
    if low_apply and sym.dtype != torch.float32:
        raise TypeError(f"{name}: low_apply needs float32")


def _tail_launch(rt: str, sym: torch.Tensor, pan: torch.Tensor, r0: int,
                 low_apply: bool) -> torch.Tensor:
    """One call of csrc/potrf_tail.cu on route ``rt``: out (rows, w) with
    zeros above r0, L11 at r0 and L21 below. Counts nothing."""
    rows, w = pan.shape
    if rt == "cluster" and w > CLUSTER_MAX_W[sym.dtype]:
        raise ValueError(f"potrf_panel_tail: no cluster route for w={w} in "
                         f"{sym.dtype}")
    sym = sym.contiguous()
    out = torch.empty((rows, w), dtype=sym.dtype, device=sym.device)
    ws, flags = _scratch(True, rt, sym, w, raw_stream(sym))
    launch(_TAIL, sym, _ROUTE_CODE[rt], DTYPE_CODE[sym.dtype], rows, w, r0,
           int(bool(low_apply)), sym.data_ptr(), sym.stride(0),
           pan.data_ptr(), pan.stride(0), pan.stride(1), out.data_ptr(),
           ws.data_ptr(), flags.data_ptr())
    return out


def potrf_panel_tail(sym_a11: torch.Tensor, pan: torch.Tensor,
                     low_apply: bool = False) -> torch.Tensor:
    """The fused panel tail [L11; L21] of a (Mt, w) history-updated panel
    whose symmetrized diagonal block is ``sym_a11`` (rows [0, w) of ``pan``
    are not read). Any Mt >= w, any w. CPU tensors take
    ``potrf_panel_tail_plain``; CUDA tensors launch the K3b kernel on
    ``route``'s choice or raise."""
    if not on_cuda(sym_a11, pan):
        return potrf_panel_tail_plain(sym_a11, pan, low_apply)
    _check_tail(sym_a11, pan, 0, low_apply, "potrf_panel_tail")
    rt = route(sym_a11.shape[0], sym_a11.dtype)
    out = _tail_launch(rt, sym_a11, pan, 0, low_apply)
    trace.count(potrf_panel_tail, rt)
    return out


def potrf_panel_tail_full(sym_a11: torch.Tensor, pan_full: torch.Tensor,
                          kidx: int, low_apply: bool = False) -> torch.Tensor:
    """The same tail on the full-height (M, w) column whose diagonal block
    is tile ``kidx`` (rows kidx*w onwards); rows above are returned as
    zeros. CPU tensors take ``potrf_panel_tail_full_plain``; CUDA tensors
    launch the K3c kernel on ``route``'s choice or raise."""
    if not on_cuda(sym_a11, pan_full):
        return potrf_panel_tail_full_plain(sym_a11, pan_full, kidx,
                                           low_apply)
    r0 = int(kidx) * sym_a11.shape[0]
    _check_tail(sym_a11, pan_full, r0, low_apply, "potrf_panel_tail_full")
    rt = route(sym_a11.shape[0], sym_a11.dtype)
    out = _tail_launch(rt, sym_a11, pan_full, r0, low_apply)
    trace.count(potrf_panel_tail_full, rt)
    return out


def reset_launches() -> None:
    """Zero the launch counts of K3a, K3b and K3c (every route and the
    sums)."""
    for fn, routes in ((potrf_block_inv, ROUTES),
                       (potrf_panel_tail, TAIL_ROUTES),
                       (potrf_panel_tail_full, TAIL_ROUTES)):
        trace.reset_counts(fn, routes)


reset_launches()
