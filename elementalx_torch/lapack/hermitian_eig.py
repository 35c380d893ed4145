"""Hermitian eigensolvers: HermitianEig and its subset forms.

Counterpart of ``elementalx/lapack/hermitian_eig.py`` (reference:
src/lapack_like/spectral/HermitianEig.cpp:430-533: scale ->
tridiagonalize -> HermitianTridiagEig -> backtransform). Two
tridiagonalizations: the one-stage latrd reduction (lapack/condense.py,
K5 on every panel on the card) and the two-stage SBR reduction
(lapack/sbr.py, K6 for the chase). The tridiagonal stage is the batched
bisection and inverse-iteration solver (lapack/tridiag_eig.py); the
backtransforms are products.

Not ported yet: the refinement tier (``ctrl.refine``, ROADMAP queue 1
item 9), and SDC, SkewHermitianEig and HermitianGenDefEig, which need
polar, QR and TwoSidedTrsm (items 6, 8 and 10).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..blas.level1 import MakeHermitian, MaxAbs
from ..core.dmatrix import DistMatrix
from ..core.types import ASCENDING, LOWER, MC, MR, SortType, UpperOrLower
from ..kernels.common import on_cuda
from .condense import HermitianTridiag, tridiag_apply_q
from .sbr import sbr_apply_q, sbr_tridiag
from .tridiag_eig import tridiag_eig, tridiag_eigvalsh

#: ``tridiag_alg="auto"`` on a CUDA tensor takes SBR only with this band
#: and from this order on, the one case where the card measured SBR
#: faster than latrd. Tridiagonalization plus backtransform of an n x n
#: block, best of three, NVIDIA H100 80GB HBM3 at 700 W (PERF.md
#: section 5), latrd / SBR b=256 / SBR b=128 in ms:
#: n=1024 106.1 / 219.3 / 126.7; 2048 189.0 / 504.8 / 221.7; 4096 474.8 /
#: 1120.1 / 478.9; 8192 1781.7 / 2412.5 / 1095.0. So b=128 wins at 8192
#: and ties at 4096, and the default b=256 loses to latrd at every n.
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
