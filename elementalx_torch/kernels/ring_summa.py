"""K8: the ring SUMMA, C = A @ B over a 1-D ring of the grid's positions.

Counterpart of ``elementalx/kernels/ring_summa.py`` (``ring_summa``, body
``_ring_kernel``), the analogue of the reference fork's NVSHMEM GEMM. The
ring is the grid flattened mc-major (rank = i*c + j). A and B both go to
rows over the ring, [VC,*]: rank ``my`` holds A_my (M/p x K) and B_my
(K/p x N). The result per rank is

    C_my = sum over s of A_my[:, blk(h)] @ B_h,  h = (my - s) mod p,

with blk(h) the h-th of p column blocks of width kb = K/p, accumulated in
f32 (f64 for f64) and rounded once to A's type; C goes back to [MC,MR].

The CUDA kernel is ``csrc/ring_summa.cu``; its header says how it pulls B
blocks through a pointer table where the TPU kernel pushes them round the
ring, and what bounds it. ``ring_summa_kernel`` is its wrapper on the
per-rank blocks, ``ring_summa_plain`` the plain version (the same holder
order, the same accumulation), and ``ring_summa`` the DistMatrix entry.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from ..core.dmatrix import DistMatrix
from ..core.redistribute import Copy
from ..core.types import MC, MR, STAR, VC
from .common import DTYPE_CODE, check_launch, current_stream, kernel_function, on_cuda

#: ranks one launch can take (the kernel's pointer tables)
MAX_RANKS = 64

_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p)


def _shapes(a_blocks: Sequence[torch.Tensor],
            b_blocks: Sequence[torch.Tensor]):
    """(p, Mloc, K, kb, N), checking that the blocks form a ring."""
    p = len(a_blocks)
    if p == 0 or len(b_blocks) != p:
        raise ValueError(f"ring_summa: {len(a_blocks)} A blocks and "
                         f"{len(b_blocks)} B blocks")
    Mloc, K = a_blocks[0].shape
    kb, N = b_blocks[0].shape
    if kb * p != K:
        raise ValueError(f"ring_summa: A blocks are {Mloc} x {K} but B "
                         f"blocks {kb} x {N} over {p} ranks")
    for x in a_blocks:
        if tuple(x.shape) != (Mloc, K):
            raise ValueError("ring_summa: A blocks of different shapes")
    for x in b_blocks:
        if tuple(x.shape) != (kb, N):
            raise ValueError("ring_summa: B blocks of different shapes")
    return p, Mloc, K, kb, N


def ring_summa_plain(a_blocks: Sequence[torch.Tensor],
                     b_blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The plain PyTorch version of K8: the ring loop over the holders in
    the same order, each step's product added to an accumulator in f32
    (f64 for f64), one rounding to A's type at the end. Rank ``my`` reads
    B_h where it lies, as the kernel does."""
    p, _, _, kb, _ = _shapes(a_blocks, b_blocks)
    out = []
    for my, a in enumerate(a_blocks):
        acc_dt = torch.promote_types(a.dtype, torch.float32)
        acc = None
        for s in range(p):
            h = (my - s) % p
            term = (a[:, h * kb:(h + 1) * kb].to(acc_dt)
                    @ b_blocks[h].to(device=a.device, dtype=acc_dt))
            acc = term if acc is None else acc.add_(term)
        out.append(acc.to(a.dtype))
    return out


def _check(a_blocks, b_blocks) -> None:
    blocks = list(a_blocks) + list(b_blocks)
    devices = {x.device for x in blocks}
    if len(devices) > 1:
        raise NotImplementedError(
            "ring_summa: K8 across cards (positions on several CUDA "
            "devices) waits for a machine with several of them; a virtual "
            "grid on one card runs it")
    dt = a_blocks[0].dtype
    if any(x.is_complex() for x in blocks):
        raise NotImplementedError(
            "ring_summa: complex dtypes have no CUDA kernel yet (ROADMAP)")
    if dt not in DTYPE_CODE or any(x.dtype != dt for x in blocks):
        raise TypeError(f"ring_summa: unsupported dtypes "
                        f"{sorted({str(x.dtype) for x in blocks})}")
    if not all(x.is_contiguous() for x in blocks):
        raise ValueError("ring_summa: every block must be contiguous")
    if len(a_blocks) > MAX_RANKS:
        raise ValueError(f"ring_summa: at most {MAX_RANKS} ranks")


def ring_summa_kernel(a_blocks: Sequence[torch.Tensor],
                      b_blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """C blocks of the ring SUMMA (rank r holds a_blocks[r], b_blocks[r]).
    CPU tensors take ``ring_summa_plain``; CUDA tensors launch the K8
    kernel, one launch for every rank on the card, or raise.
    ``ring_summa_kernel.launches`` counts kernel launches."""
    if not on_cuda(*a_blocks, *b_blocks):
        return ring_summa_plain(a_blocks, b_blocks)
    p, Mloc, K, _, N = _shapes(a_blocks, b_blocks)
    _check(a_blocks, b_blocks)
    a0 = a_blocks[0]
    c_blocks = [torch.empty((Mloc, N), dtype=a0.dtype, device=a0.device)
                for _ in range(p)]
    if Mloc == 0 or N == 0:
        return c_blocks

    def table(xs):
        return (ctypes.c_longlong * p)(*xs)

    fn = kernel_function("elx_ring_summa", _ARGTYPES)
    with torch.cuda.device(a0.device):
        rc = fn(DTYPE_CODE[a0.dtype], p, p, Mloc, N, K, table(range(p)),
                table(x.data_ptr() for x in a_blocks),
                table(x.data_ptr() for x in b_blocks),
                table(x.data_ptr() for x in c_blocks), current_stream(a0))
    check_launch(rc, "elx_ring_summa")
    ring_summa_kernel.launches += 1
    return c_blocks


ring_summa_kernel.launches = 0


def ring_summa(A: DistMatrix, B: DistMatrix) -> DistMatrix:
    """C = A @ B through K8 over all positions of the grid, flattened to a
    1-D ring: A and B to [VC,*] (``Copy``), the kernel on the per-rank
    blocks, C back to [MC,MR]."""
    g = A.grid
    An = A.redistribute(MC, MR).canonical()
    Bn = B.redistribute(MC, MR).canonical()
    if An.n != Bn.m:
        raise ValueError(f"ring_summa: inner dims mismatch {An.shape} x "
                         f"{Bn.shape}")
    if not An.sharded:
        c = ring_summa_kernel([An.data.contiguous()], [Bn.data.contiguous()])
        return DistMatrix.from_padded(c[0], An.m, Bn.n, MC, MR, g, A.wrap)
    Av, Bv = Copy(An, VC, STAR), Copy(Bn, VC, STAR)
    c = ring_summa_kernel([x.contiguous() for x in Av.blocks],
                          [x.contiguous() for x in Bv.blocks])
    Cv = DistMatrix(None, An.m, Bn.n, VC, STAR, g, A.wrap, tuple(c))
    return Copy(Cv, MC, MR)
