"""LAPACK-like drivers of the ported slices: HPD solve, LU, HermitianEig
and HermitianGenDefEig, QR/LQ/RQ/GQR/GRQ and the least-squares family."""

from . import (  # noqa: F401
    cholesky,
    condense,
    euclidean_min,
    gqr,
    hermitian_eig,
    lq,
    lu,
    perm,
    qr,
    reflect,
    sbr,
    solve,
    tridiag_eig,
)
from .cholesky import Cholesky, HPDSolve, SolveAfter  # noqa: F401
from .lu import LU, LUFullPiv, LUMod, LinearSolve  # noqa: F401
from .perm import Permutation  # noqa: F401
from .condense import HermitianTridiag  # noqa: F401
from .hermitian_eig import (  # noqa: F401
    HermitianEig,
    HermitianEigCtrl,
    HermitianEigSubset,
    HermitianEigValueSubset,
    HermitianGenDefEig,
)
from .tridiag_eig import HermitianTridiagEig  # noqa: F401
from .qr import (  # noqa: F401
    QR,
    ApplyQ,
    CholeskyQR,
    ColPivQR,
    ExplicitQR,
    QRFactorization,
    TSQR,
)
from .lq import LQ, ExplicitLQ, ExplicitRQ, LQFactorization  # noqa: F401
from .gqr import GQR, GRQ  # noqa: F401
from .euclidean_min import GLM, LSE, LeastSquares, Ridge, Tikhonov  # noqa: F401
