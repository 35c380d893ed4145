"""elementalx_torch — elementalx ported to PyTorch on one NVIDIA H100.

The port of the JAX package ``elementalx`` (the reference, which stays in
the repository unchanged). Plain tensor code is PyTorch; every kernel the
JAX package wrote in Pallas for the TPU becomes a CUDA kernel written by
hand for Hopper (``elementalx_torch/kernels``), each with a plain PyTorch
version that CPU tensors take. This package never imports JAX.

The ported slices: the HPD-solve main path (a one-device Grid, an
[MC,MR] DistMatrix, Gemm, Trsm, Cholesky and HPDSolve), the LU path
(Permutation, LU, LUFullPiv, LUMod and LinearSolve) and the HermitianEig
path (HermitianTridiag, HermitianTridiagEig, HermitianEig and its subset
forms). The namespace is
flat, as the reference's El:: is; the top-level SolveAfter is the
Cholesky one, and the LU one is ``lapack.lu.SolveAfter``.
"""

__version__ = "0.1.0"

import os as _os

import torch as _torch

# LAPACK-grade accuracy is this library's contract: float32 products run
# in full FP32, never in TF32 (about three decimal digits), as the JAX
# package forces "highest" matmul precision. Opt out (e.g. when embedding
# the library in an ML pipeline) with ELEMENTALX_NO_PRECISION_OVERRIDE=1.
if not _os.environ.get("ELEMENTALX_NO_PRECISION_OVERRIDE"):
    _torch.backends.cuda.matmul.allow_tf32 = False
    _torch.backends.cudnn.allow_tf32 = False

from .core import *  # noqa: F401,F403,E402
from . import blas, kernels, lapack  # noqa: F401,E402
from .blas import (  # noqa: F401,E402
    Adjoint,
    Gemm,
    MakeHermitian,
    MakeTrapezoidal,
    MaxAbs,
    Nrm2,
    Transpose,
    Trsm,
)
from .lapack import (  # noqa: F401,E402
    LU,
    Cholesky,
    HermitianEig,
    HermitianEigCtrl,
    HermitianEigSubset,
    HermitianEigValueSubset,
    HermitianTridiag,
    HermitianTridiagEig,
    HPDSolve,
    LinearSolve,
    LUFullPiv,
    LUMod,
    Permutation,
    SolveAfter,
)
