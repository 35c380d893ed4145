"""Port parity: BLAS levels 2 and 3 (Herk ... Trdtrmm, Gemv ... Trsv) and
the level-1 operations they need.

Mirrors ``tests/blas/test_level3.py`` and ``tests/blas/test_level2.py``:
each input is made with numpy from a seed and given to the JAX package on
a one-device grid and to its PyTorch port on the CPU, where K2 (the
masked rank-k update) and K7 (the lower-triangle symv) take their plain
versions. Every result is held against the JAX package's and against the
numpy formula of the JAX test. float64 and complex128: 1e-12 relative to
the result's largest entry (the same products, summed in other orders);
float32: 1e-5.
"""

import numpy as np
import pytest
import torch

import jax

import elementalx as El
import elementalx_torch as Et
from elementalx.blas import level1 as jl1
from elementalx.blas import level2 as jl2
from elementalx.blas import level3 as jl3
from elementalx.core import types as J
from elementalx_torch.blas import level1 as tl1
from elementalx_torch.blas import level2 as tl2
from elementalx_torch.blas import level3 as tl3
from elementalx_torch.core import types as T

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers at once: keep torch to one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jgrid():
    return El.Grid(devices=jax.devices()[:1])


@pytest.fixture
def rng():
    return np.random.default_rng(40)


CPU = Et.Grid("cpu")


def _j(g, a):
    return El.DistMatrix.from_global(a, grid=g)


def _t(a):
    return Et.DistMatrix.from_global(a, grid=CPU)


def _tag(v):
    return getattr(T, v.name)


def _close(port, ref, tol=TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err < tol, f"relative error {err} >= {tol}"


def _both(out, jref, ref, tol=TOL):
    """The port's DistMatrix against the JAX package's and the formula."""
    o = out.global_array()
    _close(o, jref.global_array(), tol)
    _close(o, ref, tol)


def _cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rand_tri(rng, n, lower=True):
    a = rng.standard_normal((n, n))
    t = np.tril(a) if lower else np.triu(a)
    np.fill_diagonal(t, np.abs(t.diagonal()) + n)
    return t


# ---------------------------------------------------------------------------
# level 1: the operations levels 2 and 3 need
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("uplo", [J.LOWER, J.UPPER], ids=["lo", "up"])
@pytest.mark.parametrize("conj", [False, True], ids=["sym", "herm"])
def test_make_symmetric(jgrid, rng, uplo, conj):
    a = _cplx(rng, 9, 9)
    out = tl1.MakeSymmetric(_tag(uplo), _t(a), conjugate=conj)
    _close(out.global_array(),
           jl1.MakeSymmetric(uplo, _j(jgrid, a), conjugate=conj)
           .global_array())


@pytest.mark.parametrize("offset", [-2, 0, 3])
def test_fill_get_diagonal(jgrid, rng, offset):
    a = rng.standard_normal((7, 10))
    _close(tl1.FillDiagonal(_t(a), 2.5, offset).global_array(),
           jl1.FillDiagonal(_j(jgrid, a), 2.5, offset).global_array())
    d = tl1.GetDiagonal(_t(a), offset)
    jd = jl1.GetDiagonal(_j(jgrid, a), offset)
    assert (d.m, d.n, d.dist) == (jd.m, jd.n, (T.MD, T.STAR))
    _close(d.global_array(), jd.global_array())


@pytest.mark.parametrize("side", [J.LEFT, J.RIGHT], ids=["L", "R"])
@pytest.mark.parametrize("orient", [J.NORMAL, J.ADJOINT], ids=["N", "H"])
def test_diagonal_solve(jgrid, rng, side, orient):
    a = _cplx(rng, 6, 6)
    dv = _cplx(rng, 6, 1) + 3
    out = tl1.DiagonalSolve(_tag(side), _tag(orient), _t(dv), _t(a))
    ref = jl1.DiagonalSolve(side, orient, _j(jgrid, dv), _j(jgrid, a))
    _close(out.global_array(), ref.global_array())


# ---------------------------------------------------------------------------
# level 3 (tests/blas/test_level3.py)
# ---------------------------------------------------------------------------


def test_herk_syrk(jgrid, rng):
    m, k = 14, 9
    a, c = _cplx(rng, m, k), _cplx(rng, m, m)
    out = tl3.Herk(T.LOWER, T.NORMAL, 2.0, _t(a), beta=0.5, C=_t(c))
    jref = jl3.Herk(J.LOWER, J.NORMAL, 2.0, _j(jgrid, a), beta=0.5,
                    C=_j(jgrid, c))
    _both(out, jref, np.tril(2.0 * a @ a.conj().T + 0.5 * c) + np.triu(c, 1))
    out2 = tl3.Syrk(T.UPPER, T.TRANSPOSE, 1.0, _t(a))
    jref2 = jl3.Syrk(J.UPPER, J.TRANSPOSE, 1.0, _j(jgrid, a))
    _both(out2, jref2, np.triu(a.T @ a))


def test_herk_f32_upper_adjoint(jgrid, rng):
    """Real float32 (K2's working type on the card): 1e-5 relative."""
    a = rng.standard_normal((30, 17)).astype(np.float32)
    c = rng.standard_normal((17, 17)).astype(np.float32)
    out = tl3.Herk(T.UPPER, T.ADJOINT, -1.0, _t(a), beta=1.0, C=_t(c))
    assert out.dtype == torch.float32
    jref = jl3.Herk(J.UPPER, J.ADJOINT, -1.0, _j(jgrid, a), beta=1.0,
                    C=_j(jgrid, c))
    ref = np.triu(c - a.T.astype(np.float64) @ a) + np.tril(c, -1)
    _both(out, jref, ref, 1e-5)
    np.testing.assert_array_equal(np.tril(out.global_array(), -1),
                                  np.tril(c, -1))


def test_her2k_syr2k(jgrid, rng):
    m, k = 12, 7
    a, b = _cplx(rng, m, k), _cplx(rng, m, k)
    out = tl3.Her2k(T.LOWER, T.NORMAL, 1.5, _t(a), _t(b))
    jref = jl3.Her2k(J.LOWER, J.NORMAL, 1.5, _j(jgrid, a), _j(jgrid, b))
    _both(out, jref, np.tril(1.5 * a @ b.conj().T + 1.5 * b @ a.conj().T))
    out2 = tl3.Syr2k(T.UPPER, T.NORMAL, 2.0, _t(a), _t(b))
    jref2 = jl3.Syr2k(J.UPPER, J.NORMAL, 2.0, _j(jgrid, a), _j(jgrid, b))
    _both(out2, jref2, np.triu(2.0 * (a @ b.T + b @ a.T)))


def test_her2k_syr2k_with_c(jgrid, rng):
    """With C and beta the other triangle is C's, the triangle
    alpha (..) + beta C; a complex alpha is conjugated in Her2k's second
    term."""
    m, k = 10, 4
    a, b, c = _cplx(rng, k, m), _cplx(rng, k, m), _cplx(rng, m, m)
    alpha = 0.5 - 1.25j
    out = tl3.Her2k(T.UPPER, T.ADJOINT, alpha, _t(a), _t(b), beta=-2.0,
                    C=_t(c))
    jref = jl3.Her2k(J.UPPER, J.ADJOINT, alpha, _j(jgrid, a), _j(jgrid, b),
                     beta=-2.0, C=_j(jgrid, c))
    ah, bh = a.conj().T, b.conj().T
    full = alpha * ah @ bh.conj().T + np.conj(alpha) * bh @ ah.conj().T
    _both(out, jref, np.triu(full - 2.0 * c) + np.tril(c, -1))
    ar, br, cr = (rng.standard_normal((m, k)), rng.standard_normal((m, k)),
                  rng.standard_normal((m, m)))
    out2 = tl3.Syr2k(T.LOWER, T.NORMAL, 0.75, _t(ar), _t(br), beta=3.0,
                     C=_t(cr))
    jref2 = jl3.Syr2k(J.LOWER, J.NORMAL, 0.75, _j(jgrid, ar),
                      _j(jgrid, br), beta=3.0, C=_j(jgrid, cr))
    _both(out2, jref2, np.tril(0.75 * (ar @ br.T + br @ ar.T) + 3.0 * cr)
          + np.triu(cr, 1))


def test_symm_symv(jgrid, rng):
    n, k = 15, 6
    a, b = rng.standard_normal((n, n)), rng.standard_normal((n, k))
    asym = np.tril(a) + np.tril(a, -1).T
    out = tl3.Symm(T.LEFT, T.LOWER, 1.0, _t(a), _t(b))
    _both(out, jl3.Symm(J.LEFT, J.LOWER, 1.0, _j(jgrid, a), _j(jgrid, b)),
          asym @ b)
    x = rng.standard_normal((n, 1))
    out2 = tl2.Symv(T.LOWER, 1.0, _t(a), _t(x))
    _both(out2, jl2.Symv(J.LOWER, 1.0, _j(jgrid, a), _j(jgrid, x)),
          asym @ x)


def test_symm_right_hemm(jgrid, rng):
    n, k = 9, 5
    a, b, c = _cplx(rng, n, n), _cplx(rng, k, n), _cplx(rng, k, n)
    aherm = np.triu(a) + np.triu(a, 1).conj().T
    np.fill_diagonal(aherm, aherm.diagonal().real)
    out = tl3.Hemm(T.RIGHT, T.UPPER, 2.0, _t(a), _t(b), beta=0.5, C=_t(c))
    jref = jl3.Hemm(J.RIGHT, J.UPPER, 2.0, _j(jgrid, a), _j(jgrid, b),
                    beta=0.5, C=_j(jgrid, c))
    _both(out, jref, 2.0 * b @ aherm + 0.5 * c)


def test_trmm(jgrid, rng):
    n, k = 13, 8
    t = _rand_tri(rng, n, lower=True)
    b = rng.standard_normal((n, k))
    out = tl3.Trmm(T.LEFT, T.LOWER, T.NORMAL, T.NON_UNIT, 1.0, _t(t), _t(b))
    jref = jl3.Trmm(J.LEFT, J.LOWER, J.NORMAL, J.NON_UNIT, 1.0,
                    _j(jgrid, t), _j(jgrid, b))
    _both(out, jref, t @ b)
    b2 = rng.standard_normal((k, n))
    out2 = tl3.Trmm(T.RIGHT, T.LOWER, T.TRANSPOSE, T.NON_UNIT, 2.0, _t(t),
                    _t(b2))
    jref2 = jl3.Trmm(J.RIGHT, J.LOWER, J.TRANSPOSE, J.NON_UNIT, 2.0,
                     _j(jgrid, t), _j(jgrid, b2))
    _both(out2, jref2, 2.0 * b2 @ t.T)
    # UNIT: the stored diagonal is not read
    tu = np.triu(t) + 7.0
    out3 = tl3.Trmm(T.LEFT, T.UPPER, T.NORMAL, T.UNIT, 1.0, _t(tu), _t(b))
    tri = np.triu(tu, 1) + np.eye(n)
    _both(out3, jl3.Trmm(J.LEFT, J.UPPER, J.NORMAL, J.UNIT, 1.0,
                         _j(jgrid, tu), _j(jgrid, b)), tri @ b)


@pytest.mark.parametrize("uplo", [J.LOWER, J.UPPER], ids=["lo", "up"])
def test_trrk(jgrid, rng, uplo):
    """Square (the JAX test's case) and rectangular C, where the triangle
    is column <= row (or >= row) of the m x n array."""
    n, k = 12, 5
    a, b, c = (rng.standard_normal((n, k)), rng.standard_normal((k, n)),
               rng.standard_normal((n, n)))
    out = tl3.Trrk(_tag(uplo), T.NORMAL, T.NORMAL, -1.0, _t(a), _t(b), 1.0,
                   _t(c))
    jref = jl3.Trrk(uplo, J.NORMAL, J.NORMAL, -1.0, _j(jgrid, a),
                    _j(jgrid, b), 1.0, _j(jgrid, c))
    tri, rest = ((np.tril, lambda x: np.triu(x, 1)) if uplo == J.LOWER
                 else (np.triu, lambda x: np.tril(x, -1)))
    _both(out, jref, tri(c - a @ b) + rest(c))
    m = 17
    a2, b2, c2 = (rng.standard_normal((k, m)), rng.standard_normal((n, k)),
                  rng.standard_normal((m, n)))
    out2 = tl3.Trrk(_tag(uplo), T.TRANSPOSE, T.TRANSPOSE, 0.5, _t(a2),
                    _t(b2), -1.0, _t(c2))
    jref2 = jl3.Trrk(uplo, J.TRANSPOSE, J.TRANSPOSE, 0.5, _j(jgrid, a2),
                     _j(jgrid, b2), -1.0, _j(jgrid, c2))
    _both(out2, jref2, tri(0.5 * a2.T @ b2.T - c2) + rest(c2))


def test_trr2k(jgrid, rng):
    n, k = 11, 4
    a, b, c, d, e = (rng.standard_normal((n, k)), rng.standard_normal((n, k)),
                     rng.standard_normal((k, n)), rng.standard_normal((k, n)),
                     rng.standard_normal((n, n)))
    out = tl3.Trr2k(T.UPPER, T.NORMAL, T.TRANSPOSE, T.TRANSPOSE, T.NORMAL,
                    1.5, _t(a), _t(b), -0.5, _t(c), _t(d), 2.0, _t(e))
    jref = jl3.Trr2k(J.UPPER, J.NORMAL, J.TRANSPOSE, J.TRANSPOSE, J.NORMAL,
                     1.5, _j(jgrid, a), _j(jgrid, b), -0.5, _j(jgrid, c),
                     _j(jgrid, d), 2.0, _j(jgrid, e))
    full = 1.5 * a @ b.T - 0.5 * c.T @ d + 2.0 * e
    _both(out, jref, np.triu(full) + np.tril(e, -1))


@pytest.mark.parametrize("uplo", [J.LOWER, J.UPPER], ids=["lo", "up"])
def test_trtrmm(jgrid, rng, uplo):
    n = 10
    t = _rand_tri(rng, n, lower=uplo == J.LOWER) + np.tril(
        rng.standard_normal((n, n)), -1) * (uplo == J.UPPER)
    out = tl3.Trtrmm(_tag(uplo), _t(t))
    jref = jl3.Trtrmm(uplo, _j(jgrid, t))
    if uplo == J.LOWER:
        ref = np.tril(np.tril(t).T @ np.tril(t)) + np.triu(t, 1)
    else:
        ref = np.triu(np.triu(t) @ np.triu(t).T) + np.tril(t, -1)
    _both(out, jref, ref)


@pytest.mark.parametrize("uplo", [J.LOWER, J.UPPER], ids=["lo", "up"])
def test_trdtrmm(jgrid, rng, uplo):
    """LDL-packed input: LOWER gives L inv(D) L^T on the lower triangle;
    UPPER gives U^T (U inv(D)) on the upper one, the JAX package's order
    of the product."""
    n = 9
    a = rng.standard_normal((n, n))
    np.fill_diagonal(a, rng.uniform(1, 2, n))
    out = tl3.Trdtrmm(_tag(uplo), _t(a))
    jref = jl3.Trdtrmm(uplo, _j(jgrid, a))
    dinv = np.diag(1 / a.diagonal())
    if uplo == J.LOWER:
        L = np.tril(a, -1) + np.eye(n)
        ref = np.tril(L @ dinv @ L.T) + np.triu(a, 1)
    else:
        U = np.triu(a, 1) + np.eye(n)
        ref = np.triu(U.T @ U @ dinv) + np.tril(a, -1)
    _both(out, jref, ref)


def test_two_sided_trsm_trmm(jgrid, rng):
    n = 12
    a = rng.standard_normal((n, n))
    ell = np.linalg.cholesky(a + a.T + 2 * n * np.eye(n))
    s = rng.standard_normal((n, n))
    s = s + s.T
    out = tl3.TwoSidedTrsm(T.LOWER, T.NON_UNIT, _t(s), _t(ell))
    jref = jl3.TwoSidedTrsm(J.LOWER, J.NON_UNIT, _j(jgrid, s),
                            _j(jgrid, ell))
    _both(out, jref, np.linalg.solve(ell, np.linalg.solve(ell, s.T).T),
          1e-10)
    out2 = tl3.TwoSidedTrmm(T.LOWER, T.NON_UNIT, _t(s), _t(ell))
    jref2 = jl3.TwoSidedTrmm(J.LOWER, J.NON_UNIT, _j(jgrid, s),
                             _j(jgrid, ell))
    _both(out2, jref2, ell.T @ s @ ell)
    u = ell.T
    out3 = tl3.TwoSidedTrsm(T.UPPER, T.NON_UNIT, _t(s), _t(u))
    jref3 = jl3.TwoSidedTrsm(J.UPPER, J.NON_UNIT, _j(jgrid, s), _j(jgrid, u))
    _both(out3, jref3, np.linalg.solve(u.T, np.linalg.solve(u.T, s.T).T),
          1e-10)
    out4 = tl3.TwoSidedTrmm(T.UPPER, T.NON_UNIT, _t(s), _t(u))
    jref4 = jl3.TwoSidedTrmm(J.UPPER, J.NON_UNIT, _j(jgrid, s), _j(jgrid, u))
    _both(out4, jref4, u @ s @ u.T)


def test_hermitian_from_evd(jgrid, rng):
    n = 10
    a = rng.standard_normal((n, n))
    a = a + a.T
    w, q = np.linalg.eigh(a)
    out = tl3.HermitianFromEVD(T.LOWER, _t(q), torch.tensor(w))
    jref = jl3.HermitianFromEVD(J.LOWER, _j(jgrid, q), jax.numpy.asarray(w))
    _both(out, jref, a, 1e-11)
    out2 = tl3.NormalFromEVD(_t(q), w)
    _close(out2.global_array(), a, 1e-11)


# ---------------------------------------------------------------------------
# level 2 (tests/blas/test_level3.py's level-2 cases and test_level2.py)
# ---------------------------------------------------------------------------


def test_level2_rank_updates(jgrid, rng):
    n = 11
    x, a = _cplx(rng, n, 1), _cplx(rng, n, n)
    out = tl2.Her(T.LOWER, 1.0, _t(x), _t(a))
    _both(out, jl2.Her(J.LOWER, 1.0, _j(jgrid, x), _j(jgrid, a)),
          np.tril(a + x @ x.conj().T) + np.triu(a, 1))
    y = _cplx(rng, n, 1)
    out2 = tl2.Her2(T.UPPER, 0.5 + 0.5j, _t(x), _t(y), _t(a))
    jref2 = jl2.Her2(J.UPPER, 0.5 + 0.5j, _j(jgrid, x), _j(jgrid, y),
                     _j(jgrid, a))
    full = a + (0.5 + 0.5j) * x @ y.conj().T + (0.5 - 0.5j) * y @ x.conj().T
    _both(out2, jref2, np.triu(full) + np.tril(a, -1))


@pytest.mark.parametrize("conj", [False, True], ids=["T", "H"])
def test_syr_syr2(jgrid, rng, conj):
    n = 8
    x, y, a = _cplx(rng, n, 1), _cplx(rng, n, 1), _cplx(rng, n, n)
    p = (lambda v: v.conj().T) if conj else (lambda v: v.T)
    out = tl2.Syr(T.UPPER, 2.0, _t(x), _t(a), conjugate=conj)
    jref = jl2.Syr(J.UPPER, 2.0, _j(jgrid, x), _j(jgrid, a), conjugate=conj)
    _both(out, jref, np.triu(a + 2.0 * x @ p(x)) + np.tril(a, -1))
    out2 = tl2.Syr2(T.LOWER, -1.0, _t(x), _t(y), _t(a), conjugate=conj)
    jref2 = jl2.Syr2(J.LOWER, -1.0, _j(jgrid, x), _j(jgrid, y),
                     _j(jgrid, a), conjugate=conj)
    _both(out2, jref2, np.tril(a - x @ p(y) - y @ p(x)) + np.triu(a, 1))


def test_ger_geru(jgrid, rng):
    m, n = 7, 5
    x, y, a = _cplx(rng, m, 1), _cplx(rng, n, 1), _cplx(rng, m, n)
    _both(tl2.Ger(2.0, _t(x), _t(y), _t(a)),
          jl2.Ger(2.0, _j(jgrid, x), _j(jgrid, y), _j(jgrid, a)),
          a + 2.0 * x @ y.conj().T)
    _both(tl2.Geru(2.0, _t(x), _t(y), _t(a)),
          jl2.Geru(2.0, _j(jgrid, x), _j(jgrid, y), _j(jgrid, a)),
          a + 2.0 * x @ y.T)


def test_gemv(jgrid, rng):
    m, n = 17, 9
    a, x, y = (rng.standard_normal((m, n)), rng.standard_normal((n, 1)),
               rng.standard_normal((m, 1)))
    out = tl2.Gemv(T.NORMAL, 2.0, _t(a), _t(x), beta=-1.0, y=_t(y))
    jref = jl2.Gemv(J.NORMAL, 2.0, _j(jgrid, a), _j(jgrid, x), beta=-1.0,
                    y=_j(jgrid, y))
    _both(out, jref, 2.0 * a @ x - y)


@pytest.mark.parametrize("uplo", [J.LOWER, J.UPPER], ids=["lo", "up"])
def test_symv_hemv_routes(jgrid, rng, uplo):
    """LOWER real one-column Symv is K7 (its plain version here); UPPER,
    several columns and complex Hemv are the symmetrized A and Gemm. All
    against the JAX package, with beta and y."""
    n = 13
    a, x, y = (rng.standard_normal((n, n)), rng.standard_normal((n, 1)),
               rng.standard_normal((n, 1)))
    if uplo == J.LOWER:
        asym = np.tril(a) + np.tril(a, -1).T
    else:
        asym = np.triu(a) + np.triu(a, 1).T
    out = tl2.Symv(_tag(uplo), 1.5, _t(a), _t(x), beta=-2.0, y=_t(y))
    jref = jl2.Symv(uplo, 1.5, _j(jgrid, a), _j(jgrid, x), beta=-2.0,
                    y=_j(jgrid, y))
    _both(out, jref, 1.5 * asym @ x - 2.0 * y)
    x3 = rng.standard_normal((n, 3))
    _both(tl2.Symv(_tag(uplo), 1.0, _t(a), _t(x3)),
          jl2.Symv(uplo, 1.0, _j(jgrid, a), _j(jgrid, x3)), asym @ x3)
    ac, xc = _cplx(rng, n, n), _cplx(rng, n, 1)
    herm = np.tril(ac) + np.tril(ac, -1).conj().T if uplo == J.LOWER \
        else np.triu(ac) + np.triu(ac, 1).conj().T
    np.fill_diagonal(herm, herm.diagonal().real)
    _both(tl2.Hemv(_tag(uplo), 1.0, _t(ac), _t(xc)),
          jl2.Hemv(uplo, 1.0, _j(jgrid, ac), _j(jgrid, xc)), herm @ xc)


def test_symv_lower_reads_only_the_lower_triangle(monkeypatch, rng):
    """The K7 route never reads the strict upper triangle: NaN there does
    not reach y, and the route really calls K7's wrapper."""
    from elementalx_torch.kernels import symv as ksymv

    calls = []
    real = ksymv.symv_lower
    monkeypatch.setattr(tl2, "symv_lower",
                        lambda A, v: calls.append(1) or real(A, v))
    n = 20
    a, x = rng.standard_normal((n, n)), rng.standard_normal((n, 1))
    asym = np.tril(a) + np.tril(a, -1).T
    a[np.triu_indices(n, 1)] = np.nan
    out = tl2.Symv(T.LOWER, 1.0, _t(a), _t(x)).global_array()
    assert calls == [1]
    _close(out, asym @ x)


def test_trsv(jgrid, rng):
    n = 20
    t = _rand_tri(rng, n, lower=False)
    b = rng.standard_normal((n, 1))
    out = tl2.Trsv(T.UPPER, T.NORMAL, T.NON_UNIT, _t(t), _t(b))
    jref = jl2.Trsv(J.UPPER, J.NORMAL, J.NON_UNIT, _j(jgrid, t),
                    _j(jgrid, b))
    _both(out, jref, np.linalg.solve(t, b), 1e-11)


def test_trmv_trr_trr2(jgrid, rng):
    n = 10
    t = np.tril(rng.standard_normal((n, n))) + 3 * np.eye(n)
    x = rng.standard_normal((n, 1))
    for orient, op in ((J.NORMAL, t), (J.TRANSPOSE, t.T)):
        out = tl2.Trmv(T.LOWER, _tag(orient), T.NON_UNIT, _t(t), _t(x))
        jref = jl2.Trmv(J.LOWER, orient, J.NON_UNIT, _j(jgrid, t),
                        _j(jgrid, x))
        _both(out, jref, op @ x)
    a = np.tril(rng.standard_normal((n, n)))
    y = rng.standard_normal((n, 1))
    out = tl2.Trr(T.LOWER, 1.5, _t(x), _t(y), _t(a))
    jref = jl2.Trr(J.LOWER, 1.5, _j(jgrid, x), _j(jgrid, y), _j(jgrid, a))
    _both(out, jref, a + np.tril(1.5 * x @ y.T))
    X2, Y2 = rng.standard_normal((n, 2)), rng.standard_normal((n, 2))
    out = tl2.Trr2(T.LOWER, 0.7, _t(X2), _t(Y2), _t(a))
    jref = jl2.Trr2(J.LOWER, 0.7, _j(jgrid, X2), _j(jgrid, Y2),
                    _j(jgrid, a))
    _both(out, jref, a + np.tril(0.7 * X2 @ Y2.T))


def test_apply_givens_sequence(jgrid, rng):
    """All three sequence types, both sides and directions, against the
    JAX package and the rotation-by-rotation oracle of its test."""
    m = 6
    cth = np.cos(rng.standard_normal(m - 1))
    sth = np.sin(rng.standard_normal(m - 1))

    def oracle(a, left, st, fwd):
        ref = a.copy() if left else a.T.copy()
        order = range(m - 1) if fwd else range(m - 2, -1, -1)
        for k in order:
            p, q = {"variable": (k, k + 1), "top": (0, k + 1),
                    "bottom": (k, m - 1)}[st]
            rp, rq = ref[p].copy(), ref[q].copy()
            ref[p] = sth[k] * rq + cth[k] * rp
            ref[q] = cth[k] * rq - sth[k] * rp
        return ref if left else ref.T

    a, a2 = rng.standard_normal((m, 5)), rng.standard_normal((4, m))
    for st in ("variable", "top", "bottom"):
        for direction, fwd in (("forward", True), ("backward", False)):
            for side, left, mat in ((J.LEFT, True, a), (J.RIGHT, False, a2)):
                out = tl2.ApplyGivensSequence(_tag(side), st, direction, cth,
                                              sth, _t(mat))
                jref = jl2.ApplyGivensSequence(side, st, direction, cth, sth,
                                               _j(jgrid, mat))
                _both(out, jref, oracle(mat, left, st, fwd))


def test_flat_namespace_exports():
    for name in ("Herk", "Syrk", "Her2k", "Syr2k", "Trrk", "Trr2k", "Symm",
                 "Hemm", "Trmm", "Trtrmm", "Trdtrmm", "TwoSidedTrsm",
                 "TwoSidedTrmm", "HermitianFromEVD", "NormalFromEVD", "Gemv",
                 "Symv", "Hemv", "Ger", "Geru", "Her", "Syr", "Her2", "Syr2",
                 "Trmv", "Trsv", "Trr", "Trr2", "ApplyGivensSequence",
                 "MakeSymmetric", "FillDiagonal", "GetDiagonal",
                 "DiagonalSolve", "HermitianGenDefEig"):
        assert callable(getattr(Et, name)), name
