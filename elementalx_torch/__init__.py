"""elementalx_torch — elementalx ported to PyTorch on the NVIDIA H100.

The port of the JAX package ``elementalx`` (the reference, which stays in
the repository unchanged). Plain tensor code is PyTorch; every kernel the
JAX package wrote in Pallas for the TPU becomes a CUDA kernel written by
hand for Hopper (``elementalx_torch/kernels``), each with a plain PyTorch
version that CPU tensors take. This package never imports JAX.

The ported slices: the HPD-solve main path (a one-device Grid, an
[MC,MR] DistMatrix, Gemm, Trsm, Cholesky and HPDSolve, with the fused
panel tail under ELX_PALLAS_POTRF=1), the LU path (Permutation, LU,
LUFullPiv, LUMod and LinearSolve), the HermitianEig path
(HermitianTridiag, HermitianTridiagEig, HermitianEig and its subset
forms), the BLAS levels 1, 2 and 3 (all of them but MultiShiftTrsm),
HermitianGenDefEig, and QR/LQ/RQ/GQR/GRQ with the least-squares family
(LeastSquares, Ridge, Tikhonov, LSE, GLM). The namespace is flat, as the
reference's El:: is: every public blas/lapack entry point is lifted to the
package root. The top-level SolveAfter is the Cholesky one, and the LU
one is ``lapack.lu.SolveAfter``.

The distributed GEMM slice: a Grid of r x c positions, each on a
torch.device (several positions may share one: a virtual grid), a
DistMatrix sharded over it as the JAX NamedSharding cuts it, the
collectives between positions and every redistribution (``copy``), the
SUMMA A/B/C/Dot, Cannon and 3-D Gemm, and the ring SUMMA on K8. Other
operations raise NotImplementedError on a grid of several positions.
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
from .core import redistribute as copy  # noqa: F401,E402  (copy::)
from . import blas, kernels, lapack  # noqa: F401,E402
from .kernels.ring_summa import ring_summa  # noqa: F401,E402
from .blas import (  # noqa: F401,E402
    Adjoint,
    ApplyGivensSequence,
    DiagonalSolve,
    FillDiagonal,
    Gemm,
    Gemm3D,
    Gemv,
    Ger,
    Geru,
    GetDiagonal,
    Hemm,
    Hemv,
    Her,
    Her2,
    Her2k,
    Herk,
    HermitianFromEVD,
    MakeHermitian,
    MakeSymmetric,
    MakeTrapezoidal,
    MaxAbs,
    NormalFromEVD,
    Nrm2,
    Symm,
    Symv,
    Syr,
    Syr2,
    Syr2k,
    Syrk,
    Transpose,
    Trdtrmm,
    Trmm,
    Trmv,
    Trr,
    Trr2,
    Trr2k,
    Trrk,
    Trsm,
    Trsv,
    Trtrmm,
    TwoSidedTrmm,
    TwoSidedTrsm,
    use_explicit_summa,
)
from .lapack import (  # noqa: F401,E402
    GLM,
    GQR,
    GRQ,
    LQ,
    LSE,
    QR,
    LU,
    Cholesky,
    HermitianEig,
    HermitianEigCtrl,
    HermitianEigSubset,
    HermitianEigValueSubset,
    HermitianGenDefEig,
    HermitianTridiag,
    HermitianTridiagEig,
    HPDSolve,
    LinearSolve,
    LUFullPiv,
    LUMod,
    LeastSquares,
    Permutation,
    Ridge,
    SolveAfter,
    Tikhonov,
)

# Flat like El::: lift every public blas/lapack entry point to the package
# root, never overriding a name bound above (as the JAX package does).
for _mod in (blas, lapack):
    for _name, _obj in vars(_mod).items():
        if _name[:1].isupper() and callable(_obj):
            globals().setdefault(_name, _obj)
del _mod, _name, _obj
