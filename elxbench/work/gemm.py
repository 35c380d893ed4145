"""Nominal work of one ``gemm`` call, as BLAS counts xGEMM with alpha = 1
and beta = 0: 2 m k n operations for C = A B, here m = k = n and
n = nrhs columns of B and C, whatever implements the product.

Bytes: each input byte read once and each output byte written once
(A and B in, C out).
"""


def flops(n: int, nrhs: int) -> float:
    """xGEMM (m = k = n, n_C = nrhs): 2 n^2 nrhs."""
    return 2 * n * n * nrhs


def nbytes(n: int, nrhs: int, itemsize: int) -> float:
    return (n * n + 2 * n * nrhs) * itemsize
