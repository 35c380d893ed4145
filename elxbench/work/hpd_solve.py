"""Nominal work of one ``hpd_solve`` call, as LAPACK counts it (its
operation counts of xPOTRF and xPOTRS), whatever implements the solve.

Bytes: each input byte read once and each output byte written once
(A and B in, X out).
"""


def flops(n: int, nrhs: int) -> float:
    """xPOTRF: n^3/3 + n^2/2 + n/6; xPOTRS: 2 n^2 nrhs."""
    return n ** 3 / 3 + n ** 2 / 2 + n / 6 + 2 * n * n * nrhs


def nbytes(n: int, nrhs: int, itemsize: int) -> float:
    return (n * n + 2 * n * nrhs) * itemsize
