"""K8: the ring SUMMA, C = A @ B over a 1-D ring of the grid's positions.

Counterpart of ``elementalx/kernels/ring_summa.py`` (``ring_summa``, body
``_ring_kernel``), the analogue of the reference fork's NVSHMEM GEMM. The
ring is the grid flattened mc-major (rank = i*c + j). A and B both go to
rows over the ring, [VC,*]: rank ``my`` holds A_my (M/p x K) and B_my
(K/p x N). The result per rank is

    C_my = sum over s of A_my[:, blk(h)] @ B_h,  h = (my - s) mod p,

with blk(h) the h-th of p column blocks of width kb = K/p, accumulated in
f32 (f64 for f64) and rounded once to A's type; C goes back to [MC,MR].

The CUDA kernels are in ``csrc/ring_summa.cu``; its header says how they
pull B blocks through a table where the TPU kernel pushes them round the
ring, and what bounds them. ``route`` picks the core as K1's does: bfloat16
rings that the TMA can read go to the tensor cores
(``csrc/gemm_sm90.cuh``), float32 ones to the FP32 FMA core on the cp.async
ring (``csrc/gemm_f32_pipe.cuh``, the FMA core's result bit for bit), the
rest to K1's FMA core. ``ring_summa_kernel`` is its wrapper on the
per-rank blocks, ``ring_summa_plain`` the plain version (the same holder
order, the same accumulation), and ``ring_summa`` the DistMatrix entry.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from .. import trace
from ..core.dmatrix import DistMatrix
from ..core.redistribute import Copy
from ..core.types import MC, MR, STAR, VC
from .common import DTYPE_CODE, Entry, launch, on_cuda
from .matmul import FAST_CORE, tma_unit_dim

#: ranks one launch can take (the kernel's pointer tables)
MAX_RANKS = 64

#: the fast cores' arguments (p, slots, Mloc, N, K, then the tables of
#: ranks and of A, B and C, and the stream); the FMA core's take the dtype
#: first
_FAST_ARGTYPES = (ctypes.c_int,) * 5 + (ctypes.c_void_p,) * 5

#: the cores and the C entry of each
CORES = {"wgmma": Entry("elx_ring_summa_wgmma", _FAST_ARGTYPES),
         "fma_async": Entry("elx_ring_summa_fma_async", _FAST_ARGTYPES),
         "fma": Entry("elx_ring_summa", (ctypes.c_int,) + _FAST_ARGTYPES)}

#: the fast cores' k-step (64 on the tensor cores, 32 on the FMA pipeline):
#: kb = K/p must be a multiple of it, so that no k-step crosses two holders
FAST_KB = 64


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


def route(a_blocks: Sequence[torch.Tensor],
          b_blocks: Sequence[torch.Tensor]) -> str:
    """The K8 core a CUDA ring takes, by dtype, shape and alignment alone:
    ``"wgmma"`` (bfloat16) or ``"fma_async"`` (float32) for blocks that can
    be read row-major in place in 16-byte pieces, with kb = K/p a positive
    multiple of ``FAST_KB``, else ``"fma"``. No device is needed: the CPU
    tests check it."""
    _, _, _, kb, _ = _shapes(a_blocks, b_blocks)
    blocks = list(a_blocks) + list(b_blocks)
    fast = FAST_CORE.get(blocks[0].dtype)
    if fast is None or any(x.dtype != blocks[0].dtype for x in blocks):
        return "fma"
    if kb == 0 or kb % FAST_KB:
        return "fma"
    if any(tma_unit_dim(x) != 1 for x in blocks):
        return "fma"
    return fast


def ring_summa_kernel(a_blocks: Sequence[torch.Tensor],
                      b_blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """C blocks of the ring SUMMA (rank r holds a_blocks[r], b_blocks[r]).
    CPU tensors take ``ring_summa_plain``; CUDA tensors launch the K8
    kernel of ``route``, one launch for every rank on the card, or raise.
    ``ring_summa_kernel.launches_<core>`` counts each core's launches,
    ``.launches`` all of them."""
    if not on_cuda(*a_blocks, *b_blocks):
        return ring_summa_plain(a_blocks, b_blocks)
    _shapes(a_blocks, b_blocks)
    _check(a_blocks, b_blocks)
    core = route(a_blocks, b_blocks)
    c_blocks = _launch(core, a_blocks, b_blocks)
    if c_blocks[0].numel():  # empty C blocks launch nothing
        trace.count(ring_summa_kernel, core)
    return c_blocks


def _launch(core: str, a_blocks: Sequence[torch.Tensor],
            b_blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Launch K8's ``core`` on checked CUDA blocks that it takes (``route``
    decides which; a test may hold two cores against each other) and
    return the C blocks; empty ones launch nothing. Counts nothing."""
    p, Mloc, K, _, N = _shapes(a_blocks, b_blocks)
    a0 = a_blocks[0]
    c_blocks = [torch.empty((Mloc, N), dtype=a0.dtype, device=a0.device)
                for _ in range(p)]
    if Mloc == 0 or N == 0:
        return c_blocks

    def table(xs):
        return (ctypes.c_longlong * p)(*xs)

    args = (p, p, Mloc, N, K, table(range(p)),
            table(x.data_ptr() for x in a_blocks),
            table(x.data_ptr() for x in b_blocks),
            table(x.data_ptr() for x in c_blocks))
    if core == "fma":
        args = (DTYPE_CODE[a0.dtype],) + args
    launch(CORES[core], a0, *args)
    return c_blocks


def reset_launches() -> None:
    """Zero K8's launch counts (all cores)."""
    trace.reset_counts(ring_summa_kernel, CORES)


reset_launches()


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
