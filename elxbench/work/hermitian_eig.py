"""Nominal work of one ``hermitian_eig`` call, as LAPACK Working Note 41
counts it, whatever implements the eigensolver: xSYTRD's reduction to
tridiagonal form, 4 n^3 / 3, and xORMTR's backtransform of all n
eigenvectors, 2 n^3; the MRRR stage's O(n^2) is left out.

Bytes: A read once, Q and w written once.
"""


def flops(n: int, nrhs: int) -> float:
    """4 n^3 / 3 + 2 n^3 = 10 n^3 / 3 (no right-hand side: ``nrhs`` is
    not read)."""
    return 10 * n ** 3 / 3


def nbytes(n: int, nrhs: int, itemsize: int) -> float:
    return (2 * n * n + n) * itemsize
