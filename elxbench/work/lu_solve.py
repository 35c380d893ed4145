"""Nominal work of one ``lu_solve`` call, as LAPACK counts it (its
operation counts of xGETRF for a square matrix and of xGETRS), whatever
implements the solve (HPL counts 2n^3/3 + 2n^2 for one right-hand side).

Bytes: each input byte read once and each output byte written once
(A and B in, X out).
"""


def flops(n: int, nrhs: int) -> float:
    """xGETRF: 2n^3/3 - n^2/2 - n/6; xGETRS: (2 n^2 - n) nrhs."""
    return 2 * n ** 3 / 3 - n ** 2 / 2 - n / 6 + (2 * n * n - n) * nrhs


def nbytes(n: int, nrhs: int, itemsize: int) -> float:
    return (n * n + 2 * n * nrhs) * itemsize
