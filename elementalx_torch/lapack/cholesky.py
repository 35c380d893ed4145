"""Cholesky factorization, its solve, and HPDSolve.

Counterpart of the single-device path of ``elementalx/lapack/cholesky.py``
(reference: src/lapack_like/factor/Cholesky.cpp:96-145,
factor/Cholesky/LowerVariant2.hpp): the LEFT-looking blocked scheme
``_chol_lower_left``. For each nb-wide panel it applies the history
product of the factor columns to its left, then the panel tail. By
default the diagonal block goes through the K3a kernel (kernels/potrf.py),
which returns L11 and inv(L11)^H, and L21 = A21 inv(L11)^H is one product
through ``local_gemm`` and so the K1 kernel. With ``ELX_PALLAS_POTRF=1``
(read at call time, as the JAX driver reads it) a float32 carrier takes
the fused panel tail instead: K3b returns [L11; L21] in one launch, with
the L21 product on bfloat16 operands for bfloat16 or float16 storage.
Every product of the factorization runs in full FP32 on float32 data (the JAX
package uses bf16x3 there).

The recursive multi-device form (``_chol_lower_rec``) waits for the
multi-GPU grid, ROADMAP queue 1 item 11.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .. import trace
from ..core.dmatrix import DistMatrix
from ..core.environment import Blocksize, NonHPDMatrixException
from ..core.types import (
    ADJOINT,
    LEFT,
    LOWER,
    MC,
    MR,
    NON_UNIT,
    NORMAL,
    Orientation,
    UPPER,
    UpperOrLower,
)
from ..blas.gemm import local_gemm
from ..blas.trsm import Trsm
from ..kernels.potrf import potrf_block_inv, potrf_panel_tail

_LOW = (torch.bfloat16, torch.float16)


def _chol_lower_left(a: torch.Tensor, nb: int,
                     store: Optional[torch.dtype] = None) -> torch.Tensor:
    """LEFT-looking blocked lower Cholesky of a padded array whose pad
    diagonal is 1 (lower triangle valid, upper ignored).

    The factor is accumulated in one preallocated (M, M) buffer, written
    in place panel by panel: a functional update (the JAX package's
    dynamic-update-slice) would copy the whole factor at every panel.

    ``store`` (e.g. bfloat16): ``a`` and the factor are kept in the
    storage dtype, each panel is upcast to a float32 carrier, the history
    products read bf16 operands and return float32, and K3a only ever sees
    float32.

    ``ELX_PALLAS_POTRF=1`` with a float32 carrier takes the fused panel
    tail (K3b), with its L21 product on bfloat16 operands (``low_apply``)
    for low-precision storage, as the JAX driver gates it. The JAX gate's
    other conditions are left out: K3b takes any (Mt, w), so the TPU's
    tile conditions (M % nb == 0, nb % 128 == 0) do not apply, and a CPU
    tensor takes K3b's plain version instead of being refused."""
    M = a.shape[0]
    sdt = store or a.dtype
    low = a.dtype in _LOW
    cdt = torch.float32 if low else a.dtype
    fuse_tail = (cdt == torch.float32
                 and os.environ.get("ELX_PALLAS_POTRF") == "1")
    Lbuf = torch.zeros((M, M), dtype=sdt, device=a.device)
    for k0 in range(0, M, nb):
        with trace.span("lapack.cholesky.panel"):
            w = min(nb, M - k0)
            pan = a[k0:, k0:k0 + w].to(cdt)
            if k0 > 0:
                # The history product, split as the JAX driver splits it:
                # the old columns [0, k0 - nb), then the previous block's
                # rank-nb term.
                j0 = k0 - nb
                if j0 > 0:
                    hist = Lbuf[k0:, :j0]
                    row = Lbuf[k0:k0 + w, :j0]
                    pan = pan - local_gemm(hist, row.mH, out_dtype=cdt)
                prev = Lbuf[k0:, j0:k0]
                pan = pan - local_gemm(prev, prev[:w].mH, out_dtype=cdt)
            a11 = pan[:w]
            sym = torch.tril(a11) + torch.tril(a11, -1).mH
            if fuse_tail:
                Lbuf[k0:, k0:k0 + w] = potrf_panel_tail(sym, pan,
                                                        low_apply=low)
                continue
            l11, inv_lh = potrf_block_inv(sym)
            Lbuf[k0:k0 + w, k0:k0 + w] = l11
            if k0 + w < M:
                Lbuf[k0 + w:, k0:k0 + w] = local_gemm(pan[w:], inv_lh)
    return Lbuf


def _set_pad_diag(d: torch.Tensor, m: int, val) -> torch.Tensor:
    """Set the padding diagonal (rows/cols >= m) of ``d`` to ``val``, in
    place, and return ``d`` (the JAX code's masked where over the whole
    array). Written through a view of the diagonal, so the host does not
    wait for the stream as an indexed store of a Python number would."""
    d.diagonal()[m:].fill_(val)
    return d


def _prep_lower_tri(A: DistMatrix, uplo: UpperOrLower) -> torch.Tensor:
    """Padded data whose LOWER triangle holds the Hermitian matrix and
    whose padding diagonal is 1. Only the lower triangle is meaningful;
    UPPER input is read through its adjoint (a view)."""
    d = A.redistribute(MC, MR).data
    if uplo == UPPER:
        d = d.mH
    if d.shape[0] > A.m:
        d = _set_pad_diag(d.clone(), A.m, 1)  # never write the caller's data
    return d


def Cholesky(uplo: UpperOrLower, A: DistMatrix,
             blocksize: Optional[int] = None) -> DistMatrix:
    """Return the Cholesky factor in the uplo triangle
    (reference: Cholesky.cpp:96; LOWER: A = L L^H, UPPER: A = U^H U).

    Raises NonHPDMatrixException when the matrix is numerically non-HPD
    (reference: factor/Cholesky/UpperVariant3.hpp:28-30): K3a poisons a
    failed panel with NaN, and the factor is checked once at the end."""
    if A.m != A.n:
        raise ValueError("Cholesky requires a square matrix")
    with trace.span("lapack.Cholesky", A.device):
        return _cholesky(uplo, A, blocksize)


def _cholesky(uplo: UpperOrLower, A: DistMatrix,
              blocksize: Optional[int]) -> DistMatrix:
    nb = blocksize or Blocksize()
    if blocksize is None:
        # panel-width knees of the JAX driver (measured on a TPU v5e,
        # cholesky.py:345-356), kept as they are until the H100 is measured
        low_store = A.dtype in _LOW
        if A.data.shape[0] >= 12288:
            nb = max(nb, 512)
        else:
            nb = max(nb, 1024 if low_store else 2048)
    d = _prep_lower_tri(A, uplo)
    store = A.dtype if A.dtype in _LOW else None
    L = _set_pad_diag(_chol_lower_left(d, nb, store), A.m, 0)
    out = A.redistribute(MC, MR).with_data(L)
    if uplo == UPPER:
        from ..blas.level1 import Adjoint

        out = Adjoint(out)
    with trace.span("lapack.cholesky.nan_check"):
        failed = bool(torch.isnan(out.data).any())
    if failed:
        raise NonHPDMatrixException()
    return out


@trace.traced("lapack.SolveAfter")
def SolveAfter(uplo: UpperOrLower, orientation: Orientation, A: DistMatrix,
               B: DistMatrix) -> DistMatrix:
    """Solve using a computed Cholesky factor
    (reference: factor/Cholesky/SolveAfter.hpp). A holds the factor in
    uplo; solves A_original X = B via two triangular solves."""
    if uplo == LOWER:
        Y = Trsm(LEFT, LOWER, NORMAL, NON_UNIT, 1.0, A, B)
        return Trsm(LEFT, LOWER, ADJOINT, NON_UNIT, 1.0, A, Y)
    Y = Trsm(LEFT, UPPER, ADJOINT, NON_UNIT, 1.0, A, B)
    return Trsm(LEFT, UPPER, NORMAL, NON_UNIT, 1.0, A, Y)


@trace.traced("lapack.HPDSolve")
def HPDSolve(uplo: UpperOrLower, orientation: Orientation, A: DistMatrix,
             B: DistMatrix, blocksize: Optional[int] = None) -> DistMatrix:
    """Solve A X = B for HPD A (reference: src/lapack_like/solve/HPD.cpp):
    Cholesky + SolveAfter."""
    L = Cholesky(uplo, A, blocksize)
    return SolveAfter(uplo, orientation, L, B)
