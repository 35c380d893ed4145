"""Hermitian eigensolvers: HermitianEig, its subset forms and
HermitianGenDefEig.

Counterpart of ``elementalx/lapack/hermitian_eig.py`` (reference:
src/lapack_like/spectral/HermitianEig.cpp:430-533: scale ->
tridiagonalize -> HermitianTridiagEig -> backtransform). Two
tridiagonalizations: the one-stage latrd reduction (lapack/condense.py,
K5 on every panel on the card) and the two-stage SBR reduction
(lapack/sbr.py, K6 for the chase). The tridiagonal stage is the batched
bisection and inverse-iteration solver (lapack/tridiag_eig.py); the
backtransforms are products. HermitianGenDefEig reduces a definite pencil
to a standard problem through Cholesky (K3a, or the fused tail K3b under
``ELX_PALLAS_POTRF=1``) and TwoSidedTrsm or TwoSidedTrmm (level 3).

Not ported yet: the refinement tier (``ctrl.refine``, ROADMAP queue 1
item 9), SDC, which needs polar and QR (items 6 and 8), and
SkewHermitianEig, which needs complex CUDA kernels (item 13).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..blas.level1 import MakeHermitian, MaxAbs
from ..blas.level3 import Trmm, TwoSidedTrmm, TwoSidedTrsm
from ..blas.trsm import Trsm
from ..core.dmatrix import DistMatrix
from ..core.types import (
    ADJOINT,
    ASCENDING,
    LEFT,
    LOWER,
    MC,
    MR,
    NON_UNIT,
    NORMAL,
    SortType,
    UpperOrLower,
)
from ..kernels.common import on_cuda
from .cholesky import Cholesky
from .condense import HermitianTridiag, tridiag_apply_q
from .sbr import sbr_apply_q, sbr_tridiag
from .tridiag_eig import tridiag_eig, tridiag_eigvalsh

#: ``tridiag_alg="auto"`` on a CUDA tensor takes SBR only with this band
#: and from this order on. Tridiagonalization plus backtransform of an
#: n x n block, best of three, NVIDIA H100 80GB HBM3 at 700 W
#: (chip_smoke.py phase 8, PERF.md section 5), latrd / SBR b=256 / SBR
#: b=128 in ms, with K6 on its cluster route: n=1024 89.4 / 65.4 / 72.3;
#: 2048 168.7 / 124.7 / 134.9; 4096 333.7 / 244.8 / 337.9; 8192 921.7 /
#: 579.8 / 730.0. SBR b=256 is the fastest at every measured n, but
#: HermitianGenDefEig at n=8192 through it read a scaled residual of
#: 167.3 against its gate of 100 (latrd: 75.2; chip_smoke.py phase 11),
#: so the default band (256) stays on latrd. SBR b=128 beat latrd at every
#: n in another run of the same script but tied it at 4096 in this one,
#: so it is taken only from 8192, where it wins by a fifth in both.
SBR_AUTO_BAND, SBR_AUTO_MIN_N = 128, 8192


class HermitianEigCtrl(NamedTuple):
    """Reference: include/El/lapack_like/spectral.hpp:411-433.
    ``tridiag_alg``: "latrd" or "sbr" force a tridiagonalization; "auto"
    takes SBR on a CUDA tensor with band SBR_AUTO_BAND from order
    SBR_AUTO_MIN_N on, where the card measured it faster, and latrd
    otherwise (on the CPU always latrd, as the JAX package off the TPU).
    ``band``: the SBR stage-1 bandwidth. ``use_sdc`` and ``sort`` are
    carried as in the JAX package, which reads neither."""

    blocksize: Optional[int] = None
    use_sdc: bool = False
    sort: SortType = ASCENDING
    refine: bool = False
    refine_iters: int = 8
    tridiag_alg: str = "auto"
    band: int = 256


def _use_sbr(ctrl: HermitianEigCtrl, A: DistMatrix,
             data: torch.Tensor) -> bool:
    can = A.grid.size == 1 and data.dtype == torch.float32
    if ctrl.tridiag_alg == "sbr":
        return can
    if ctrl.tridiag_alg == "auto":
        return (can and on_cuda(data) and ctrl.band == SBR_AUTO_BAND
                and A.m >= SBR_AUTO_MIN_N)
    if ctrl.tridiag_alg == "latrd":
        return False
    raise ValueError(f"unknown tridiag_alg {ctrl.tridiag_alg!r}")


def HermitianEig(uplo: UpperOrLower, A: DistMatrix, vectors: bool = True,
                 ctrl: Optional[HermitianEigCtrl] = None):
    """The full spectrum (w ascending) and, with ``vectors``, the
    eigenvectors Q as a DistMatrix (reference: HermitianEig.cpp:1003-1040).
    The matrix is scaled into a safe range on the device, with no host
    synchronisation, and w is scaled back."""
    ctrl = ctrl or HermitianEigCtrl()
    if ctrl.refine:
        raise NotImplementedError(
            "HermitianEig: ctrl.refine is not ported (ROADMAP queue 1 "
            "item 9)")
    n = A.m
    if n != A.n:
        raise ValueError("HermitianEig requires square A")

    # scale to a safe range (reference: HermitianEig.cpp:430-448)
    Af = MakeHermitian(uplo, A.redistribute(MC, MR))
    rdt = Af.data.real.dtype
    maxabs = MaxAbs(Af)
    fi = torch.finfo(rdt)
    underflow = fi.tiny ** 0.5
    overflow = fi.max ** 0.5 / n
    one = torch.ones((), dtype=rdt, device=Af.device)
    scale = torch.where(maxabs > overflow, overflow / maxabs,
                        torch.where((maxabs < underflow) & (maxabs > 0),
                                    underflow / maxabs, one))
    Af = Af.with_data(Af.data * scale.to(Af.dtype))

    if _use_sbr(ctrl, A, Af.data):
        b = ctrl.band
        npad = -(-n // b) * b
        Ag = Af.data.new_zeros((npad, npad))
        Ag[:n, :n] = Af.data[:n, :n]
        sfact = sbr_tridiag(Ag, b=b)
        d, e = sfact.d[:n], sfact.e[: max(n - 1, 0)]
        if not vectors:
            return tridiag_eigvalsh(d, e) / scale
        w, Z = tridiag_eig(d, e)
        Zp = Z.new_zeros((npad, n))
        Zp[:n] = Z
        Qg = sbr_apply_q(sfact, Zp, b)[:n]
        return w / scale, DistMatrix.from_global(Qg, MC, MR, A.grid)

    fact = HermitianTridiag(LOWER, Af, blocksize=ctrl.blocksize)
    d, e = fact.d[:n], fact.e[: max(n - 1, 0)]
    if not vectors:
        return tridiag_eigvalsh(d, e) / scale
    w, Z = tridiag_eig(d, e)
    # backtransform: Q = (Q_householder D) Z
    M = fact.packed.data.shape[0]
    Zfull = fact.packed.data.new_zeros((M, M))
    Zfull[:n, :n] = Z.to(Zfull.dtype)
    Qd = tridiag_apply_q(fact, Zfull, adjoint=False,
                         blocksize=ctrl.blocksize)
    Q = DistMatrix.from_padded(Af.mask_padding(Qd), n, n, MC, MR, A.grid,
                               A.wrap)
    return w / scale, Q


def HermitianEigSubset(uplo: UpperOrLower, A: DistMatrix, il: int, iu: int,
                       ctrl: Optional[HermitianEigCtrl] = None):
    """Eigenpairs with (0-based, inclusive) indices il..iu (reference:
    HermitianEig.cpp subset dispatch)."""
    w, Q = HermitianEig(uplo, A, vectors=True, ctrl=ctrl)
    n = A.m
    return w[il:iu + 1], DistMatrix.from_global(Q.data[:n, il:iu + 1],
                                                MC, MR, A.grid)


def HermitianEigValueSubset(uplo: UpperOrLower, A: DistMatrix,
                            vl: float, vu: float,
                            ctrl: Optional[HermitianEigCtrl] = None):
    """Eigenpairs with eigenvalues in (vl, vu] (reference:
    HermitianEig.cpp value-range dispatch). The count is data-dependent,
    so the selection synchronises with the host. Returns
    (w_subset, Q_subset), or (an empty array, None) when none lies in the
    range."""
    w, Q = HermitianEig(uplo, A, vectors=True, ctrl=ctrl)
    wnp = w.cpu().numpy()
    sel = np.where((wnp > vl) & (wnp <= vu))[0]
    if sel.size == 0:
        return wnp[:0], None
    lo, hi = int(sel[0]), int(sel[-1])
    n = A.m
    return w[lo:hi + 1], DistMatrix.from_global(Q.data[:n, lo:hi + 1],
                                                MC, MR, A.grid)


def HermitianGenDefEig(uplo: UpperOrLower, A: DistMatrix, B: DistMatrix,
                       vectors: bool = True,
                       ctrl: Optional[HermitianEigCtrl] = None,
                       pencil: str = "AXBX"):
    """Generalized Hermitian-definite eigenproblems with B HPD (reference:
    spectral/HermitianGenDefEig.cpp, the Pencil enum), through the
    Cholesky factor B = L L^H:
      AXBX:  A x = lambda B x  ->  C = inv(L) A inv(L)^H,  x = L^{-H} z
      ABX:   A B x = lambda x  ->  C = L^H A L,            x = L^{-H} z
      BAX:   B A x = lambda x  ->  C = L^H A L,            x = L z
    As in the JAX package, A is read whole, only the lower triangle of B
    is read, and ``uplo`` is not consulted. Returns w (and X as a
    DistMatrix with ``vectors``)."""
    L = Cholesky(LOWER, B)
    if pencil == "AXBX":
        C = TwoSidedTrsm(LOWER, NON_UNIT, A.redistribute(MC, MR), L)
    elif pencil in ("ABX", "BAX"):
        C = TwoSidedTrmm(LOWER, NON_UNIT, A.redistribute(MC, MR), L)
    else:
        raise ValueError(pencil)
    if not vectors:
        return HermitianEig(LOWER, C, vectors=False, ctrl=ctrl)
    w, Z = HermitianEig(LOWER, C, vectors=True, ctrl=ctrl)
    if pencil in ("AXBX", "ABX"):
        X = Trsm(LEFT, LOWER, ADJOINT, NON_UNIT, 1.0, L, Z)
    else:
        X = Trmm(LEFT, LOWER, NORMAL, NON_UNIT, 1.0, L, Z)
    return w, X
