"""Port parity: QR, LQ/RQ, GQR/GRQ and the least-squares family
(``elementalx_torch/lapack/{qr,lq,gqr,euclidean_min}.py``) and the
least-squares step.

Mirrors ``tests/lapack/test_qr.py`` (its real/complex and shape
parameters), the least-squares cases of ``tests/lapack/test_solve_misc.py``,
``test_lq_rq`` of ``tests/lapack/test_props_funcs.py`` and ``test_gqr_grq``
of ``tests/lapack/test_eig_svd.py``. Each numpy input goes through the JAX
package (on the 4x2 test grid) and through the port on the CPU. In float64
both factor their panels with LAPACK's geqrf, so R, Q and the packed
factors are held entry by entry (1e-12 of the largest entry: the same
reflectors, products summed in another order). Float32 CholeskyQR2 panels
take other signs than geqrf; there the factors are compared through
Q^T Q, A - Q R and ApplyQ on the JAX factor itself, carried across by
``QRFactorization.from_reference``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import elementalx as El
import elementalx_torch as Et
from elementalx.lapack import euclidean_min as jem
from elementalx.lapack import gqr as jgqr
from elementalx.lapack import lq as jlq
from elementalx.lapack import qr as jqr
from elementalx_torch.entry import least_squares_step, make_ls_problem
from elementalx_torch.lapack import euclidean_min as tem
from elementalx_torch.lapack import gqr as tgqr
from elementalx_torch.lapack import lq as tlq
from elementalx_torch.lapack import qr as tqr

CPU = Et.Grid("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers at once: keep torch to one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both(a, grid):
    return (El.DistMatrix.from_global(jnp.asarray(a), grid=grid),
            Et.DistMatrix.from_global(a, grid=CPU))


def _arr(x):
    if isinstance(x, (El.DistMatrix, Et.DistMatrix)):
        return np.asarray(x.global_array())
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _rel(port, ref):
    port, ref = _arr(port), _arr(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def _checks(a, q, r, tol=1e-12):
    k = q.shape[1]
    orth = np.linalg.norm(np.eye(k) - q.conj().T @ q)
    recon = np.linalg.norm(a - q @ r) / np.linalg.norm(a)
    assert orth < tol, f"orthogonality {orth}"
    assert recon < tol, f"reconstruction {recon}"


def _carried_qr(fact, m, n):
    return tqr.QRFactorization.from_reference(
        np.asarray(fact.packed.data), np.asarray(fact.tau), m, n, grid=CPU)


# ---------------------------------------------------------------------------
# the mirror of tests/lapack/test_qr.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(30, 30), (40, 18), (18, 30)],
                         ids=["square", "tall", "wide"])
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "cplx"])
def test_explicit_qr(grid, rng, shape, complex_):
    """Contracts as the JAX test (1e-12), then Q and R entry by entry
    against the JAX package (1e-12)."""
    m, n = shape
    a = rng.standard_normal((m, n))
    if complex_:
        a = a + 1j * rng.standard_normal((m, n))
    Aj, At = _both(a, grid)
    Q, R = tqr.ExplicitQR(At, blocksize=8)
    q, r = Q.global_array(), R.global_array()
    assert np.allclose(r, np.triu(r))
    _checks(a, q, r)
    Qj, Rj = jqr.ExplicitQR(Aj, blocksize=8)
    assert _rel(Q, Qj) < 1e-12 and _rel(R, Rj) < 1e-12


def test_apply_q(grid, rng):
    """ApplyQ round trip (as the JAX test), and ApplyQ on the JAX factor
    carried across against the JAX ApplyQ (1e-12)."""
    m, n, nrhs = 24, 16, 5
    a = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    b = rng.standard_normal((m, nrhs)) + 1j * rng.standard_normal((m, nrhs))
    Aj, At = _both(a, grid)
    Bj, Bt = _both(b, grid)
    fact = tqr.QR(At, blocksize=4)
    QhB = tqr.ApplyQ(True, fact, Bt, blocksize=4)
    np.testing.assert_allclose(tqr.ApplyQ(False, fact, QhB,
                                          blocksize=4).global_array(),
                               b, atol=1e-12)
    jfact = jqr.QR(Aj, blocksize=4)
    carried = _carried_qr(jfact, m, n)
    assert _rel(carried.packed, fact.packed) < 1e-12
    for adj in (True, False):
        assert _rel(tqr.ApplyQ(adj, carried, Bt, blocksize=4),
                    jqr.ApplyQ(adj, jfact, Bj, blocksize=4)) < 1e-12


def test_qr_solve_least_squares(grid, rng):
    m, n = 32, 12
    a = rng.standard_normal((m, n))
    b = rng.standard_normal((m, 1))
    Q, R = tqr.ExplicitQR(Et.DistMatrix.from_global(a, grid=CPU),
                          blocksize=8)
    x = np.linalg.solve(R.global_array()[:n, :n],
                        (Q.global_array().T @ b)[:n])
    xref, *_ = np.linalg.lstsq(a, b, rcond=None)
    np.testing.assert_allclose(x, xref, atol=1e-10)


def test_cholesky_qr(grid, rng):
    m, n = 48, 8
    a = rng.standard_normal((m, n))
    Aj, At = _both(a, grid)
    Q, R = tqr.CholeskyQR(At)
    _checks(a, Q.global_array(), R.global_array()[:n, :n], tol=1e-10)
    Qj, Rj = jqr.CholeskyQR(Aj)
    assert _rel(Q, Qj) < 1e-12 and _rel(R, Rj) < 1e-12


def test_tsqr(grid, rng):
    """The port's grid has one row, so its tree is one local QR: the
    contract, and |R| against the JAX tree's (signs may differ per row)."""
    m, n = 64, 8
    a = rng.standard_normal((m, n))
    Aj, At = _both(a, grid)
    Q, R = tqr.TSQR(At)
    _checks(a, Q.global_array(), R.global_array())
    _, Rj = jqr.TSQR(Aj)
    np.testing.assert_allclose(np.abs(R.global_array()),
                               np.abs(Rj.global_array()), atol=1e-12)


def test_colpiv_qr(grid, rng):
    m, n = 20, 14
    a = rng.standard_normal((m, n))
    a[:, 3] *= 1e-8
    a[:, 7] *= 1e-5
    Aj, At = _both(a, grid)
    fact, P = tqr.ColPivQR(At)
    perm = P.perm.numpy()[:n]
    jfact, JP = jqr.ColPivQR(Aj)
    np.testing.assert_array_equal(perm, np.asarray(JP.perm)[:n])
    assert _rel(fact.packed, jfact.packed) < 1e-12
    from elementalx_torch.lapack.reflect import ExpandPackedReflectors

    k = min(m, n)
    q = ExpandPackedReflectors(fact.packed.data, fact.tau, 4, k,
                               m).numpy()[:m, :k]
    f = fact.packed.global_array()
    np.testing.assert_allclose(q @ np.triu(f)[:k, :n], a[:, perm],
                               atol=1e-10)
    d = np.abs(np.diag(np.triu(f)[:k]))
    assert np.all(d[:-1] >= d[1:] - 1e-12)


def test_qr_diag_matches_numpy(grid, rng):
    """The mirror of test_qr_under_jit (the port runs eagerly): |diag R|
    as numpy's, and the packed factor and tau as the jitted JAX QR's."""
    m, n = 16, 16
    a = rng.standard_normal((m, n))
    Aj, At = _both(a, grid)
    fact = tqr.QR(At, blocksize=8)
    _, rref = np.linalg.qr(a)
    np.testing.assert_allclose(np.abs(np.diag(fact.packed.global_array())),
                               np.abs(np.diag(rref)), atol=1e-12)
    jfact = jqr.QR(Aj, blocksize=8)
    assert _rel(fact.packed, jfact.packed) < 1e-12
    assert _rel(fact.tau[:n], np.asarray(jfact.tau)[:n]) < 1e-12


def test_panel_fallbacks_match_geqrf(rng):
    """The two-level loop panel against the geqrf panel: the same R up to
    column signs (1e-10), and the same reflectors up to those signs."""
    n = 96
    a = torch.tensor(rng.standard_normal((n, n)))
    tau0 = torch.zeros(n, dtype=a.dtype)
    loop, tl = tqr._panel_qr_loop(a.clone(), tau0.clone(), 0, 32, n)
    geq, tg = tqr._panel_qr(a.clone(), tau0.clone(), 0, 32, n)
    np.testing.assert_allclose(np.abs(np.triu(loop[:32, :32].numpy())),
                               np.abs(np.triu(geq[:32, :32].numpy())),
                               rtol=1e-10, atol=1e-10)
    same = np.sign(np.diag(loop[:32, :32].numpy())) == \
        np.sign(np.diag(geq[:32, :32].numpy()))
    np.testing.assert_allclose(tl[:32].numpy()[same], tg[:32].numpy()[same],
                               atol=1e-12)
    assert not bool(loop[:, 32:].ne(a[:, 32:]).any())


def test_cholqr_panels_f32(grid, rng, monkeypatch):
    """CholeskyQR2 panels (float32, nb >= 192) give float32-grade
    orthogonality and reconstruction, as the JAX test holds them, on a
    Gaussian, a tall and a graded matrix; the Gaussian and tall panels
    all take the fast route, the graded one sends its panel to geqrf;
    ELEMENTALX_QR_PANEL=geqrf turns the route off."""
    from elementalx_torch.lapack.qr import _use_cholqr_panels

    assert _use_cholqr_panels(torch.float32, 256)
    assert not _use_cholqr_panels(torch.float64, 256)
    assert not _use_cholqr_panels(torch.float32, 64)
    n = 1024
    eps = np.finfo(np.float32).eps
    cases = [("gauss", rng.standard_normal((n, n)), (1, 0, 3)),
             ("tall", rng.standard_normal((n + 512, 640)), (2, 0, 0)),
             ("graded", rng.standard_normal((n, n))
              * np.logspace(0, -7, n)[None, :], (0, 1, 3))]
    for tag, a, panels in cases:
        a = a.astype(np.float32)
        tqr.cholqr_panels.update(fast=0, slow=0, short=0)
        Q, R = tqr.ExplicitQR(Et.DistMatrix.from_global(a, grid=CPU),
                              blocksize=256)
        assert tuple(tqr.cholqr_panels.values()) == panels, tag
        q, r = Q.global_array(), R.global_array()
        k = q.shape[1]
        orth = np.linalg.norm(np.eye(k) - q.T @ q)
        recon = np.linalg.norm(a - q @ r) / np.linalg.norm(a)
        assert orth < 100 * eps * np.sqrt(a.shape[0] * k), (tag, orth)
        assert recon < 100 * eps * np.sqrt(a.size) ** 0.5, (tag, recon)
    monkeypatch.setenv("ELEMENTALX_QR_PANEL", "geqrf")
    assert not _use_cholqr_panels(torch.float32, 256)


def test_cholqr_factor_against_carried_jax_factor(grid, rng):
    """A float32 (1536, 512) QR with nb=256: both packages take the
    CholeskyQR2 route for both panels (the JAX package's 0-based LU
    permutation and the port's 1-based pivots both read as the identity).
    The port's factor, the JAX factor carried across and the JAX ApplyQ
    agree through Q^H B (1e-5 of max|Q^H B|: float32 products in other
    orders), and both reconstruct A to float32 precision."""
    m, n = 1536, 512
    a = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal((m, 3)).astype(np.float32)
    Aj, At = _both(a, grid)
    Bj, Bt = _both(b, grid)
    tqr.cholqr_panels.update(fast=0, slow=0, short=0)
    fact = tqr.QR(At, blocksize=256)
    assert tqr.cholqr_panels == {"fast": 2, "slow": 0, "short": 0}
    jfact = jqr.QR(Aj, blocksize=256)
    carried = _carried_qr(jfact, m, n)
    ref = jqr.ApplyQ(True, jfact, Bj)
    assert _rel(tqr.ApplyQ(True, carried, Bt), ref) < 1e-5
    assert _rel(tqr.ApplyQ(True, fact, Bt), ref) < 1e-5
    eps = np.finfo(np.float32).eps
    for f in (fact, carried):
        q = tqr.ApplyQ(False, f, Et.DistMatrix.from_global(
            np.eye(m, n, dtype=np.float32), grid=CPU)).global_array()
        r = np.triu(f.packed.global_array())[:n]
        assert np.abs(q @ r - a).max() / np.abs(a).max() < 100 * eps * n


# ---------------------------------------------------------------------------
# LQ / RQ / GQR / GRQ
# ---------------------------------------------------------------------------


def test_lq_rq(grid, rng):
    """The mirror of test_props_funcs.py's test_lq_rq, and the factors
    against the JAX package (1e-12)."""
    m, n = 10, 16
    a = rng.standard_normal((m, n))
    Aj, At = _both(a, grid)
    L, Q = tlq.ExplicitLQ(At, blocksize=4)
    ell, q = L.global_array(), Q.global_array()
    k = min(m, n)
    assert np.linalg.norm(np.eye(k) - q @ q.T) < 1e-12
    assert np.linalg.norm(ell @ q - a) / np.linalg.norm(a) < 1e-12
    assert np.allclose(ell[:, :k], np.tril(ell[:, :k]))
    Lj, Qj = jlq.ExplicitLQ(Aj, blocksize=4)
    assert _rel(L, Lj) < 1e-12 and _rel(Q, Qj) < 1e-12
    R, Q2 = tlq.ExplicitRQ(At, blocksize=4)
    r, q2 = R.global_array(), Q2.global_array()
    assert np.linalg.norm(r @ q2 - a) / np.linalg.norm(a) < 1e-12
    assert np.linalg.norm(np.eye(m) - q2 @ q2.T) < 1e-12
    assert np.allclose(r, np.triu(r))
    Rj, Q2j = jlq.ExplicitRQ(Aj, blocksize=4)
    assert _rel(R, Rj) < 1e-12 and _rel(Q2, Q2j) < 1e-12
    for full in (True,):
        Rf, Qf = tlq.ExplicitRQ(At, blocksize=4, full=full)
        Rfj, Qfj = jlq.ExplicitRQ(Aj, blocksize=4, full=full)
        assert _rel(Rf, Rfj) < 1e-12 and _rel(Qf, Qfj) < 1e-12


def test_lq_factorization_carried(grid, rng):
    """LQ's packed factor and tau against the JAX package's, and the JAX
    LQ factor carried across by LQFactorization.from_reference."""
    m, n = 9, 14
    a = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    Aj, At = _both(a, grid)
    fact = tlq.LQ(At, blocksize=4)
    jfact = jlq.LQ(Aj, blocksize=4)
    carried = tlq.LQFactorization.from_reference(
        np.asarray(jfact.packed.data), np.asarray(jfact.tau), m, n, grid=CPU)
    for f in (fact, carried):
        assert _rel(f.packed, jfact.packed) < 1e-12
        assert _rel(f.tau[:m], np.asarray(jfact.tau)[:m]) < 1e-12
    assert carried.tau.shape == (m,)


def test_gqr_grq(grid, rng):
    """The mirror of test_eig_svd.py's test_gqr_grq, and every factor
    against the JAX package (1e-12)."""
    a, b = rng.standard_normal((12, 8)), rng.standard_normal((12, 10))
    (Aj, At), (Bj, Bt) = _both(a, grid), _both(b, grid)
    Q, R, T, Z = tgqr.GQR(At, Bt)
    assert np.linalg.norm(Q.global_array() @ R.global_array() - a) < 1e-11
    assert np.linalg.norm(Q.global_array() @ T.global_array()
                          @ Z.global_array() - b) < 1e-11
    for port, ref in zip((Q, R, T, Z), jgqr.GQR(Aj, Bj)):
        assert _rel(port, ref) < 1e-12
    a2, b2 = rng.standard_normal((8, 12)), rng.standard_normal((10, 12))
    (A2j, A2t), (B2j, B2t) = _both(a2, grid), _both(b2, grid)
    R2, Q2, Z2, T2 = tgqr.GRQ(A2t, B2t)
    assert np.linalg.norm(R2.global_array() @ Q2.global_array() - a2) < 1e-11
    assert np.linalg.norm(Z2.global_array() @ T2.global_array()
                          @ Q2.global_array() - b2) < 1e-11
    for port, ref in zip((R2, Q2, Z2, T2), jgqr.GRQ(A2j, B2j)):
        assert _rel(port, ref) < 1e-12


# ---------------------------------------------------------------------------
# euclidean_min: the mirror of tests/lapack/test_solve_misc.py:27-95
# ---------------------------------------------------------------------------


def test_least_squares_overdetermined(grid, rng):
    m, n, k = 30, 10, 3
    a, b = rng.standard_normal((m, n)), rng.standard_normal((m, k))
    (Aj, At), (Bj, Bt) = _both(a, grid), _both(b, grid)
    X = tem.LeastSquares(Et.NORMAL, At, Bt)
    ref, *_ = np.linalg.lstsq(a, b, rcond=None)
    np.testing.assert_allclose(X.global_array(), ref, atol=1e-10)
    assert _rel(X, jem.LeastSquares(El.NORMAL, Aj, Bj)) < 1e-12


def test_least_squares_underdetermined(grid, rng):
    m, n = 8, 20
    a, b = rng.standard_normal((m, n)), rng.standard_normal((m, 2))
    (Aj, At), (Bj, Bt) = _both(a, grid), _both(b, grid)
    X = tem.LeastSquares(Et.NORMAL, At, Bt).global_array()
    ref, *_ = np.linalg.lstsq(a, b, rcond=None)  # min-norm solution
    np.testing.assert_allclose(a @ X, b, atol=1e-10)
    np.testing.assert_allclose(X, ref, atol=1e-9)
    assert _rel(X, jem.LeastSquares(El.NORMAL, Aj, Bj)) < 1e-12


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "cplx"])
def test_least_squares_underdetermined_transposes_once(grid, rng, monkeypatch,
                                                       complex_):
    """The minimum-norm branch factors A^H by QR and solves with R^H as a
    view: one K9 transpose (of A), where the route through LQ(A) takes
    three. Same X as the JAX package's route through LQ (1e-12)."""
    from elementalx_torch.blas import level1 as T1

    calls, transpose = [], T1.transpose

    def counted(x, conjugate=False):
        calls.append(tuple(x.shape))
        return transpose(x, conjugate)

    monkeypatch.setattr(T1, "transpose", counted)
    m, n = 8, 20
    a, b = rng.standard_normal((m, n)), rng.standard_normal((m, 3))
    if complex_:
        a = a + 1j * rng.standard_normal((m, n))
        b = b + 1j * rng.standard_normal((m, 3))
    (Aj, At), (Bj, Bt) = _both(a, grid), _both(b, grid)
    X = tem.LeastSquares(Et.NORMAL, At, Bt)
    assert calls == [tuple(At.data.shape)]
    assert _rel(X, jem.LeastSquares(El.NORMAL, Aj, Bj)) < 1e-12


@pytest.mark.parametrize("shape", [(30, 10), (8, 20)], ids=["over", "under"])
def test_least_squares_adjoint(grid, rng, shape):
    """op(A) = A^H: the solve of the conjugate-transposed system, against
    numpy and the JAX package (1e-12)."""
    m, n = shape
    a = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    b = rng.standard_normal((m, 2)) + 1j * rng.standard_normal((m, 2))
    (Aj, At), (Bj, Bt) = _both(a, grid), _both(b, grid)
    X = tem.LeastSquares(Et.ADJOINT, At, Bt)
    ref, *_ = np.linalg.lstsq(a.conj().T, b, rcond=None)
    np.testing.assert_allclose(X.global_array(), ref, atol=1e-10)
    assert _rel(X, jem.LeastSquares(El.ADJOINT, Aj, Bj)) < 1e-12


def test_least_squares_second_half_on_carried_factor(grid, rng):
    """LeastSquares' second half, X = R^{-1} Q^H B, run by the port on the
    JAX QR factor carried across, against the JAX LeastSquares (1e-12)."""
    from elementalx_torch.blas.level1 import GetSubmatrix
    from elementalx_torch.blas.trsm import Trsm

    m, n = 26, 9
    a, b = rng.standard_normal((m, n)), rng.standard_normal((m, 2))
    (Aj, At), (Bj, Bt) = _both(a, grid), _both(b, grid)
    carried = _carried_qr(jqr.QR(Aj), m, n)
    QhB = tqr.ApplyQ(True, carried, Bt)
    X = Trsm(Et.LEFT, Et.UPPER, Et.NORMAL, Et.NON_UNIT, 1.0,
             GetSubmatrix(carried.packed, slice(0, n), slice(0, n)),
             GetSubmatrix(QhB, slice(0, n), slice(0, 2)))
    assert _rel(X, jem.LeastSquares(El.NORMAL, Aj, Bj)) < 1e-12


def test_ridge_tikhonov(grid, rng):
    m, n = 20, 8
    a, b = rng.standard_normal((m, n)), rng.standard_normal((m, 1))
    gamma = 0.7
    (Aj, At), (Bj, Bt) = _both(a, grid), _both(b, grid)
    X = tem.Ridge(Et.NORMAL, At, Bt, gamma)
    ref = np.linalg.solve(a.T @ a + gamma ** 2 * np.eye(n), a.T @ b)
    np.testing.assert_allclose(X.global_array(), ref, atol=1e-10)
    assert _rel(X, jem.Ridge(El.NORMAL, Aj, Bj, gamma)) < 1e-12
    g = rng.standard_normal((n, n))
    Gj, Gt = _both(g, grid)
    Xt = tem.Tikhonov(Et.NORMAL, At, Bt, Gt)
    reft = np.linalg.solve(a.T @ a + g.T @ g, a.T @ b)
    np.testing.assert_allclose(Xt.global_array(), reft, atol=1e-9)
    assert _rel(Xt, jem.Tikhonov(El.NORMAL, Aj, Bj, Gj)) < 1e-12
    Xa = tem.Ridge(Et.ADJOINT, Et.DistMatrix.from_global(a.T.copy(),
                                                        grid=CPU), Bt, gamma)
    np.testing.assert_allclose(Xa.global_array(), ref, atol=1e-10)


def test_lse(grid, rng):
    m, n, p = 16, 8, 3
    a, b = rng.standard_normal((m, n)), rng.standard_normal((p, n))
    c, d = rng.standard_normal((m, 1)), rng.standard_normal((p, 1))
    (Aj, At), (Bj, Bt) = _both(a, grid), _both(b, grid)
    (Cj, Ct), (Dj, Dt) = _both(c, grid), _both(d, grid)
    X = tem.LSE(At, Bt, Ct, Dt).global_array()
    np.testing.assert_allclose(b @ X, d, atol=1e-9)
    r = a.T @ (a @ X - c)
    lam, *_ = np.linalg.lstsq(b.T, r, rcond=None)
    np.testing.assert_allclose(b.T @ lam, r, atol=1e-8)
    assert _rel(X, jem.LSE(Aj, Bj, Cj, Dj)) < 1e-12


def test_glm(grid, rng):
    m, n, p = 12, 5, 12
    a, b = rng.standard_normal((m, n)), rng.standard_normal((m, p))
    d = rng.standard_normal((m, 1))
    (Aj, At), (Bj, Bt), (Dj, Dt) = _both(a, grid), _both(b, grid), \
        _both(d, grid)
    X, Y = tem.GLM(At, Bt, Dt)
    np.testing.assert_allclose(a @ X.global_array() + b @ Y.global_array(),
                               d, atol=1e-8)
    Xj, Yj = jem.GLM(Aj, Bj, Dj)
    assert _rel(X, Xj) < 1e-12 and _rel(Y, Yj) < 1e-12


# ---------------------------------------------------------------------------
# the least-squares step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n", [(96, 64), (48, 80)], ids=["over", "under"])
def test_least_squares_step(m, n):
    """least_squares_step on the CPU against numpy's lstsq (1e-10 of
    max|X| in float64) and its residual norm against ||B - A X||; the
    float32 problem from the same seed solves to float32 precision."""
    a, b = make_ls_problem(m, n, 4, dtype=torch.float64, device="cpu",
                           seed=3)
    x, nrm = least_squares_step(a, b)
    ref, *_ = np.linalg.lstsq(a.numpy(), b.numpy(), rcond=None)
    assert x.shape == (n, 4)
    assert np.abs(x.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()
    assert abs(nrm.item() - np.linalg.norm(b.numpy() - a.numpy() @ ref)) \
        <= 1e-10 * np.linalg.norm(b.numpy())
    a32, b32 = make_ls_problem(m, n, 4, device="cpu", seed=3)
    x32, _ = least_squares_step(a32, b32)
    assert np.abs(x32.double().numpy() - ref).max() <= \
        1e-4 * np.abs(ref).max()
