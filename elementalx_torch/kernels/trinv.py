"""K10: the inverse of (a batch of) upper-triangular matrices in one launch.

Replaces no TPU kernel: the JAX package inverts triangles in plain XLA
(``elementalx/blas/trinv.py``), a batched 16 x 16 substitution and then
log2(n/16) doubling levels of batched products. That chain is
``trinv_plain`` here, the version CPU tensors take; on the card it issued
about 105 device kernels and 280 host ops for one 512-wide inverse, so
K10 (``csrc/trinv.cu``, whose header gives its design and bound) was added
to do the whole inverse in one launch.

``trinv(U, unit=False)`` returns inv(U) for U (..., n, n) upper triangular,
leading dimensions a batch, reading only the upper triangle (with ``unit``
only the strictly upper one: the diagonal is taken as 1). The result is a
new contiguous tensor with zeros below the diagonal.

On CUDA: float32 and float64 (the others raise), any strides. U is read in
place through its batch, row and column strides (``.mT`` views included)
whenever its leading dimensions collapse into one batch stride; otherwise
``reshape`` copies it once. Up to ``MAX_N`` the inverse is one launch; a
larger triangle's diagonal blocks of order MAX_N or less are inverted by one
launch (two where the last is shorter) and joined up a binary tree, each
off-diagonal block -inv(A) B inv(C) through K1. ``trinv.launches`` counts
the launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import trace
from .common import DTYPE_CODE, Entry, cdiv, launch, on_cuda
from .matmul import _sm_count, matmul

#: the largest order inverted in one launch (csrc/trinv.cu:kMaxN)
MAX_N = 1024
#: the stripe widths the kernel is built for
WIDTHS = (16, 4)

_BASE = 16  # the plain version's unblocked block

_ENTRY = Entry("elx_trinv",
               (ctypes.c_int,) * 5
               + (ctypes.c_void_p,) + (ctypes.c_longlong,) * 3
               + (ctypes.c_void_p,) + (ctypes.c_longlong,) * 3
               + (ctypes.c_void_p,))


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _blocks(U: torch.Tensor, s: int) -> torch.Tensor:
    """View of a (..., P, P) tensor as (..., P/s, P/s, s, s) blocks."""
    q = U.shape[-1] // s
    return U.reshape(*U.shape[:-2], q, s, q, s).transpose(-3, -2)


def _inv_upper_unblocked(U: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of small upper-triangular blocks by back
    substitution, one row of the inverse per step (writes its own output
    buffer in place)."""
    n = U.shape[-1]
    X = torch.zeros_like(U)
    eye = torch.eye(n, dtype=U.dtype, device=U.device)
    for i in range(n - 1, -1, -1):
        rhs = eye[i] - (U[..., i:i + 1, i + 1:] @ X[..., i + 1:, :])[..., 0, :]
        X[..., i, :] = rhs / U[..., i, i:i + 1]
    return X


def trinv_plain(U: torch.Tensor, unit: bool = False) -> torch.Tensor:
    """The plain version: the JAX package's batched recursive 2x2 block
    partitioning,

        inv([[A, B], [0, C]]) = [[inv(A), -inv(A) B inv(C)], [0, inv(C)]]

    with every diagonal block of one granularity inverted at once (one
    batched substitution at 16 x 16, then two batched ``torch.matmul``
    products a doubling level). The triangle is embedded in a (..., P, P)
    buffer, P the next power of two, whose padding diagonal (with ``unit``
    the whole diagonal) is set to 1 through a view of the diagonal
    (``fill_``: the 1 travels as a kernel argument, so the host does not
    wait for the stream)."""
    n = U.shape[-1]
    batch = U.shape[:-2]
    P = max(_next_pow2(n), _BASE)
    Up = U.new_zeros((*batch, P, P))
    Up[..., :n, :n] = torch.triu(U, 1 if unit else 0)
    Up.diagonal(dim1=-2, dim2=-1)[..., 0 if unit else n:].fill_(1)

    L = _inv_upper_unblocked(
        _blocks(Up, _BASE).diagonal(dim1=-4, dim2=-3).movedim(-1, -3))
    s = _BASE
    while s < P:
        A = L[..., 0::2, :, :]
        C = L[..., 1::2, :, :]
        B = _blocks(Up, s)[..., 0::2, 1::2, :, :].diagonal(
            dim1=-4, dim2=-3).movedim(-1, -3)
        TR = -torch.matmul(A, torch.matmul(B, C))
        top = torch.cat([A, TR], dim=-1)
        bot = torch.cat([torch.zeros_like(TR), C], dim=-1)
        L = torch.cat([top, bot], dim=-2)
        s *= 2
    return L[..., 0, :n, :n]


def stripe_width(n: int, batch: int, sms: int) -> int:
    """The stripe width W of a launch: 16 where ``batch`` matrices of order
    n give at least ``sms`` stripes of 16 columns (the batch fills the card,
    and wide stripes read U fewer times), else 4, so that one matrix of
    order 512 or more fills the card with its stripes; the heaviest
    stripe's chain of n / 32 tile steps sets the time then. Device-free:
    the CPU tests check it."""
    return 16 if batch * cdiv(n, 16) >= sms else 4


def _check(U: torch.Tensor) -> None:
    if U.dim() < 2 or U.shape[-1] != U.shape[-2]:
        raise ValueError(f"trinv: square matrices expected, got "
                         f"{tuple(U.shape)}")
    if U.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"trinv: {U.dtype} has no CUDA kernel (float32 and "
                        f"float64 only)")


def _launch(U: torch.Tensor, X: torch.Tensor, unit: bool,
            width: int) -> None:
    """One launch of K10 at stripe width ``width``: X[b] = inv(U[b]) for
    the (batch, n, n) views U and X, n at most MAX_N. Where U's column
    stride is the smaller, the kernel is given J U^T J (J the order
    reversal; its row stride is then U's column stride) and writes
    J inv(U)^T J = inv(J U^T J) through X's strides reversed the same way.
    Counts nothing (a test may hold the widths against each other)."""
    batch, n, _ = U.shape
    sb, sr, sc = U.stride()
    xb, xr, xc = X.stride()
    u, x = U.data_ptr(), X.data_ptr()
    if abs(sc) < abs(sr):
        u += (n - 1) * (sr + sc) * U.element_size()
        x += (n - 1) * (xr + xc) * X.element_size()
        sr, sc, xr, xc = -sc, -sr, -xc, -xr
    launch(_ENTRY, X, DTYPE_CODE[U.dtype], width, int(bool(unit)), n, batch,
           u, sb, sr, sc, x, xb, xr, xc)


def leaves(n: int):
    """(nb, q): a triangle of order n above MAX_N is cut into diagonal
    blocks of order nb (16-aligned, at most MAX_N), a power of two of them
    at most, q of them full and, where q nb < n, one shorter last block."""
    parts = _next_pow2(cdiv(n, MAX_N))
    nb = cdiv(cdiv(n, parts), 16) * 16
    return nb, n // nb


def _invert(U: torch.Tensor, X: torch.Tensor, unit: bool, block) -> None:
    """X = inv(U) for (batch, n, n) views: ``block(U, X, unit)`` inverts a
    batch of triangles of order MAX_N or less in place. A larger triangle
    is cut as ``leaves`` says; its q full diagonal blocks are inverted by
    one call of ``block`` on their strided (q, nb, nb) view, the last block
    by another, and the blocks are joined pairwise up a binary tree,

        inv([[A, B], [0, C]]) = [[inv(A), -inv(A) (B inv(C))], [0, inv(C)]]

    the off-diagonal block formed by two K1 products. B lies in U's upper
    triangle."""
    batch, n, _ = U.shape
    if n <= MAX_N:
        block(U, X, unit)
        return
    nb, q = leaves(n)
    for b in range(batch):
        Ub, Xb = U[b], X[b]
        diag = [(torch.as_strided(M, (q, nb, nb),
                                  (nb * (M.stride(0) + M.stride(1)),
                                   *M.stride()), M.storage_offset()))
                for M in (Ub, Xb)]
        block(*diag, unit)
        if q * nb < n:
            block(Ub[None, q * nb:, q * nb:], Xb[None, q * nb:, q * nb:],
                  unit)
        s = nb
        while s < n:
            for i0 in range(0, n - s, 2 * s):
                i1, i2 = i0 + s, min(i0 + 2 * s, n)
                Xb[i1:i2, i0:i1].zero_()
                torch.neg(matmul(Xb[i0:i1, i0:i1],
                                 matmul(Ub[i0:i1, i1:i2], Xb[i1:i2, i1:i2])),
                          out=Xb[i0:i1, i1:i2])
            s *= 2


def _block(U: torch.Tensor, X: torch.Tensor, unit: bool) -> None:
    _launch(U, X, unit,
            stripe_width(U.shape[-1], U.shape[0], _sm_count(X.get_device())))
    trace.count(trinv)


def trinv(U: torch.Tensor, unit: bool = False) -> torch.Tensor:
    """inv(U) for (a batch of) upper-triangular U, entries below the
    diagonal ignored (with ``unit`` the diagonal too, taken as 1). CPU
    tensors take ``trinv_plain``; CUDA tensors launch K10 or raise."""
    if not on_cuda(U):
        return trinv_plain(U, unit)
    _check(U)
    n = U.shape[-1]
    X = torch.empty(U.shape, dtype=U.dtype, device=U.device)
    if X.numel():
        _invert(U.reshape(-1, n, n), X.view(-1, n, n), unit, _block)
    return X


trace.reset_counts(trinv)
