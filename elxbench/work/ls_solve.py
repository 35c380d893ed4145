"""Nominal work of one ``ls_solve`` call, as LAPACK counts it (the
operation counts of xGEQRF, xORMQR with SIDE = 'L' and xTRSM that xGELS
runs, LAPACK Working Note 41), whatever implements the solve, for a
square A (m = n) and nrhs right-hand sides.

Bytes: each input byte read once and each output byte written once
(A and B in, X out).
"""


def flops(n: int, nrhs: int) -> float:
    """xGEQRF (m = n): 4n^3/3 + 2n^2 + 14n/3 (2mn^2 - 2n^3/3 + mn + n^2 +
    14n/3 for m >= n); xORMQR (m = k = n): 4mk nrhs - 2k^2 nrhs + 3k nrhs;
    xTRSM: n^2 nrhs."""
    geqrf = 4 * n ** 3 / 3 + 2 * n ** 2 + 14 * n / 3
    ormqr = (2 * n * n + 3 * n) * nrhs
    trsm = n * n * nrhs
    return geqrf + ormqr + trsm


def nbytes(n: int, nrhs: int, itemsize: int) -> float:
    return (n * n + 2 * n * nrhs) * itemsize
