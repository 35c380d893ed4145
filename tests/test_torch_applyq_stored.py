"""ApplyQ with the compact-WY T's that QR kept
(``elementalx_torch/lapack/qr.py``): QR stores the T each panel's
trailing update applied, and ApplyQ without a ``blocksize`` applies Q or
Q^H panel by panel at the factor's width with those T's, building one
only for a panel that had no trailing update. On the same factorization
that gives the operator the rebuilt path ``ApplyQ(..., blocksize=nb)``
gives, to rounding: 1e-5 of max|out| in float32, 1e-12 in float64.
A factorization without stored T's, or an explicit ``blocksize``, keeps
ApplyPackedReflectors and builds every block's T. ``applyq_blocks``
counts the blocks each way.
"""

import math

import pytest
import torch

import elementalx_torch as Et
from elementalx_torch.core.environment import Blocksize
from elementalx_torch.lapack import qr as tqr
from elementalx_torch.lapack.reflect import ApplyPackedReflectors
from elxbench import cells
from elxbench.judge import numbers

CPU = Et.Grid("cpu")
REF = cells.load_cell("ls.f32.n16384").reference
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
NRHS = 6

# name: (m, n, dtype, nb, (stored, rebuilt) a call)
CASES = {
    # float32 at nb = 256: one CholeskyQR2 panel ("fast"), then three
    # geqrf ones ("short"); the last, with no trailing update, has no T
    "cholqr2_square": (1024, 1024, torch.float32, 256, (3, 1)),
    # float64 takes geqrf panels only; their T's come from build_wy_T
    "geqrf_square": (320, 320, torch.float64, 64, (4, 1)),
    # tall: two CholeskyQR2 panels
    "cholqr2_tall": (2048, 512, torch.float32, 256, (1, 1)),
    "geqrf_tall": (300, 192, torch.float64, 64, (2, 1)),
    # ncols not a multiple of nb: a last panel 188 (float32: below the
    # CholeskyQR2 width, so geqrf) or 10 columns wide
    "cholqr2_ragged": (1200, 700, torch.float32, 256, (2, 1)),
    "geqrf_ragged": (250, 202, torch.float64, 64, (3, 1)),
    # wide: every panel has a trailing update, so every T is stored
    "geqrf_wide": (150, 260, torch.float64, 64, (3, 0)),
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers at once: keep torch to one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def _problem(m, n, dtype, seed=17):
    g = _gen(seed)
    a = torch.randn(m, n, generator=g, dtype=torch.float64) / math.sqrt(m)
    b = torch.randn(m, NRHS, generator=g, dtype=torch.float64)
    return (Et.DistMatrix.from_global(a.to(dtype), grid=CPU),
            Et.DistMatrix.from_global(b.to(dtype), grid=CPU))


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _applied(adjoint, fact, B, blocksize=None):
    """ApplyQ's result and the blocks it counted (stored, rebuilt)."""
    tqr.applyq_blocks.update(stored=0, rebuilt=0)
    out = tqr.ApplyQ(adjoint, fact, B, blocksize).replicated()
    return out, tuple(tqr.applyq_blocks.values())


@pytest.mark.parametrize("adjoint", [True, False], ids=["QhB", "QB"])
@pytest.mark.parametrize("case", list(CASES))
def test_stored_T_gives_the_rebuilt_operator(case, adjoint):
    m, n, dtype, nb, blocks = CASES[case]
    A, B = _problem(m, n, dtype)
    fact = tqr.QR(A, blocksize=nb)
    assert fact.panel_width == nb
    assert len(fact.panel_T) == -(-min(m, n) // nb)
    got, counted = _applied(adjoint, fact, B)
    assert counted == blocks
    want, rebuilt = _applied(adjoint, fact, B, blocksize=nb)
    assert rebuilt == (0, len(fact.panel_T))
    assert got.dtype == dtype
    assert _rel(got, want) < TOL[dtype]


def _no_stored_T(kind, A):
    """A factorization of A without stored T's, and the blocksize ApplyQ is
    given (None: its default)."""
    if kind == "from_reference":
        fact = tqr.QR(A, blocksize=64)
        return tqr.QRFactorization.from_reference(
            fact.packed.data.numpy(), fact.tau.numpy(), A.m, A.n,
            grid=CPU), None
    if kind == "colpiv":
        return tqr.ColPivQR(A)[0], None
    return tqr.QR(A, blocksize=64), 32


@pytest.mark.parametrize("adjoint", [True, False], ids=["QhB", "QB"])
@pytest.mark.parametrize("kind", ["from_reference", "colpiv", "blocksize"])
def test_without_stored_T_apply_packed_reflectors_builds_every_block(
        kind, adjoint):
    A, B = _problem(200, 150, torch.float64)
    fact, blocksize = _no_stored_T(kind, A)
    assert kind == "blocksize" or fact.panel_T is None
    nb = blocksize or Blocksize()
    got, counted = _applied(adjoint, fact, B, blocksize)
    assert counted == (0, -(-150 // nb))
    want = ApplyPackedReflectors(fact.packed.data, fact.tau, B.data, nb, 150,
                                 adjoint=adjoint)
    assert torch.equal(got, want[:200])


def _least_squares(a, b, nb):
    Et.PushBlocksizeStack(nb)
    try:
        X = Et.LeastSquares(Et.NORMAL, Et.DistMatrix.from_global(a, grid=CPU),
                            Et.DistMatrix.from_global(b, grid=CPU))
        return X.replicated()[:X.m, :X.n]
    finally:
        Et.PopBlocksizeStack()


# (m, n, (stored, rebuilt) a solve): m >= n factors A and applies Q^H;
# m < n factors A^H (1024 x 512: one "fast" panel and one "short" one
# without a trailing update) and applies Q
@pytest.mark.parametrize("m,n,blocks", [(1024, 1024, (3, 1)),
                                        (512, 1024, (1, 1))],
                         ids=["overdetermined", "minimum_norm"])
def test_least_squares_on_stored_T_against_the_reference(m, n, blocks):
    """resid = ||B - A X||inf / (||A||inf ||X||inf m eps), as the benchmark
    judges the cell, against the plain reference's X: for m < n the
    minimum-norm X_ref = A^T (A A^T)^{-1} B, the square solve of the
    reference."""
    g = _gen(23)
    a = torch.randn(m, n, generator=g, dtype=torch.float32) / math.sqrt(n)
    b = torch.randn(m, NRHS, generator=g, dtype=torch.float32)
    tqr.applyq_blocks.update(stored=0, rebuilt=0)
    x = _least_squares(a, b, 256)
    assert tuple(tqr.applyq_blocks.values()) == blocks
    a64, b64 = a.double(), b.double()
    if m >= n:
        x_ref = REF.solve(a64, b64, "float64")
    else:
        x_ref = a64.mT @ REF.solve(a64 @ a64.mT, b64, "float64")
    got = numbers(a64, b64, x, x_ref, torch.finfo(torch.float32).eps)
    # the limit test_torch_ls_solve.py holds the port to at order n
    assert got["resid"] < 0.3 * 96 / m, got
    if m < n:
        # the minimum-norm X (read 11 here); another solution of A X = B
        # lies O(1/eps) away from it
        assert got["fwd"] < 1e3, got
