"""Port parity: BLAS level 1 (``elementalx_torch/blas/level1.py``).

Mirrors ``tests/blas/test_level1_extra.py``, test for test (the matrix
generators and the contract variants of its last two tests belong to
modules the port does not have yet), and adds the operations that run on
K9: each numpy input goes through the JAX package (on the 4x2 test grid)
and through the port on the CPU, where K9's wrappers take their plain
versions. Tolerances: 1e-14 relative for a few roundings in float64,
exact equality where both sides only move data.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import elementalx as El
import elementalx_torch as Et
from elementalx.blas import level1 as J1
from elementalx_torch.blas import level1 as T1
from elementalx_torch.core.types import LEFT, LOWER, NORMAL, RIGHT, UPPER

CPU = Et.Grid("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers at once: keep torch to one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mk(rng, grid, m, n, dtype=np.float64):
    """(numpy array, JAX DistMatrix, port DistMatrix) of one input."""
    a = rng.standard_normal((m, n)).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal((m, n))
    return (a, El.DistMatrix.from_global(jnp.asarray(a), grid=grid),
            Et.DistMatrix.from_global(a, grid=CPU))


def _np(x):
    """A port result (DistMatrix, tensor or number) as numpy."""
    if isinstance(x, Et.DistMatrix):
        return x.global_array()
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _close(port, ref, rtol=1e-14):
    port, ref = _np(port), np.asarray(
        ref.global_array() if isinstance(ref, El.DistMatrix) else ref)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300) if ref.size else 1.0
    assert np.abs(port - ref).max(initial=0.0) <= rtol * scale


# ---------------------------------------------------------------------------
# the mirror of tests/blas/test_level1_extra.py
# ---------------------------------------------------------------------------


def test_axpy_trapezoid(rng, grid):
    x, Xj, Xt = _mk(rng, grid, 6, 6)
    y, Yj, Yt = _mk(rng, grid, 6, 6)
    out = T1.AxpyTrapezoid(UPPER, 2.0, Xt, Yt, offset=1)
    _close(out, y + 2.0 * np.triu(x, 1))
    _close(out, J1.AxpyTrapezoid(El.UPPER, 2.0, Xj, Yj, offset=1))


def test_transpose_axpy(rng, grid):
    x, Xj, Xt = _mk(rng, grid, 5, 3)
    y, Yj, Yt = _mk(rng, grid, 3, 5)
    out = T1.TransposeAxpy(0.5, Xt, Yt)
    _close(out, y + 0.5 * x.T)
    _close(out, J1.TransposeAxpy(0.5, Xj, Yj))


def test_concatenate(rng, grid):
    a, Aj, At = _mk(rng, grid, 5, 3)
    b, Bj, Bt = _mk(rng, grid, 5, 2)
    C = T1.Concatenate(At, Bt, axis=1)
    assert (C.m, C.n) == (5, 5)
    _close(C, J1.Concatenate(Aj, Bj, axis=1), 0.0)
    c, Cj, Ct = _mk(rng, grid, 2, 3)
    D = T1.Concatenate(At, Ct, axis=0)
    assert (D.m, D.n) == (7, 3)
    _close(D, np.concatenate([a, c], axis=0), 0.0)


def test_reshape_column_major(rng, grid):
    a, Aj, At = _mk(rng, grid, 4, 6)
    R = T1.Reshape(8, 3, At)
    _close(R, a.reshape(-1, order="F").reshape((8, 3), order="F"), 0.0)
    _close(R, J1.Reshape(8, 3, Aj), 0.0)


def test_conjugate_and_real_diagonal(rng, grid):
    a, Aj, At = _mk(rng, grid, 5, 5, np.complex128)
    _close(T1.ConjugateDiagonal(At), J1.ConjugateDiagonal(Aj), 0.0)
    ref = a.copy()
    np.fill_diagonal(ref, np.real(np.diag(a)))
    _close(T1.MakeDiagonalReal(At), ref, 0.0)
    _close(T1.MakeDiagonalReal(At), J1.MakeDiagonalReal(Aj), 0.0)


def test_conjugate_submatrix(rng, grid):
    a, Aj, At = _mk(rng, grid, 6, 6, np.complex128)
    out = T1.ConjugateSubmatrix(At, slice(1, 3), slice(2, 5))
    ref = a.copy()
    ref[1:3, 2:5] = np.conj(ref[1:3, 2:5])
    _close(out, ref, 0.0)
    _close(T1.MakeSubmatrixReal(At, slice(1, 3), slice(2, 5)),
           J1.MakeSubmatrixReal(Aj, slice(1, 3), slice(2, 5)), 0.0)


def test_diagonal_scale_trapezoid(rng, grid):
    a, Aj, At = _mk(rng, grid, 5, 5)
    d = rng.standard_normal(5) + 2
    Dt = Et.DistMatrix.from_global(d[:, None], grid=CPU)
    Dj = El.DistMatrix.from_global(jnp.asarray(d[:, None]), grid=grid)
    out = T1.DiagonalScaleTrapezoid(LEFT, NORMAL, UPPER, Dt, At)
    _close(out, np.where(np.triu(np.ones((5, 5), bool)), d[:, None] * a, a))
    _close(out, J1.DiagonalScaleTrapezoid(El.LEFT, El.NORMAL, El.UPPER, Dj,
                                          Aj))


def test_mapped_diagonal(rng, grid):
    a, Aj, At = _mk(rng, grid, 5, 5)
    got = T1.GetMappedDiagonal(At, lambda x: x ** 2)
    _close(_np(got)[:, 0], np.diag(a) ** 2)
    dt = Et.DistMatrix.from_global(np.ones((5, 1)), grid=CPU)
    dj = El.DistMatrix.from_global(jnp.ones((5, 1)), grid=grid)
    upd = T1.UpdateMappedDiagonal(At, dt, lambda aa, dd: aa + 10 * dd)
    _close(upd, a + 10 * np.eye(5))
    _close(upd, J1.UpdateMappedDiagonal(Aj, dj, lambda aa, dd: aa + 10 * dd))


def test_kronecker(rng, grid):
    a, Aj, At = _mk(rng, grid, 2, 3)
    b, Bj, Bt = _mk(rng, grid, 3, 2)
    K = T1.Kronecker(At, Bt)
    assert (K.m, K.n) == (6, 6)
    _close(K, J1.Kronecker(Aj, Bj))


def test_givens_rotate(rng, grid):
    c, s, rho = T1.Givens(3.0, 4.0)
    assert abs(float(c) - 0.6) < 1e-14 and abs(float(rho) - 5.0) < 1e-14
    assert abs(float(-s.conj() * 3.0 + c * 4.0)) < 1e-14
    c2, s2, r2 = T1.Givens(1 + 1j, 2 - 1j)
    jc2, js2, jr2 = J1.Givens(1 + 1j, 2 - 1j)
    for port, ref in ((c2, jc2), (s2, js2), (r2, jr2)):
        assert abs(complex(port) - complex(ref)) < 1e-14
    assert abs(complex(-s2.conj() * (1 + 1j) + c2 * (2 - 1j))) < 1e-14
    x, Xj, Xt = _mk(rng, grid, 1, 6)
    y, Yj, Yt = _mk(rng, grid, 1, 6)
    for port, ref in zip(T1.Rotate(0.6, 0.8, Xt, Yt),
                         J1.Rotate(0.6, 0.8, Xj, Yj)):
        _close(port, ref)


def test_quasi_diagonal(rng, grid):
    n = 9
    d = rng.standard_normal(n) + 3
    dSub = np.zeros(n - 1)
    dSub[0], dSub[3], dSub[6] = 0.5, -0.8, 0.2
    D = np.diag(d) + np.diag(dSub, -1) + np.diag(dSub, 1)
    x, Xj, Xt = _mk(rng, grid, n, 4)
    _close(T1.QuasiDiagonalScale(LEFT, LOWER, d, dSub, Xt), D @ x, 1e-13)
    _close(T1.QuasiDiagonalSolve(LEFT, LOWER, d, dSub, Xt),
           np.linalg.solve(D, x), 1e-13)
    dc = d.astype(complex)
    sc = dSub.astype(complex)
    sc[0] = 0.4 + 0.3j
    Dh = np.diag(dc) + np.diag(sc, -1) + np.diag(np.conj(sc), 1)
    xc, Xcj, Xct = _mk(rng, grid, 3, n, np.complex128)
    Yr = T1.QuasiDiagonalScale(RIGHT, LOWER, dc, sc, Xct, conjugated=True)
    _close(Yr, xc @ Dh, 1e-13)
    _close(Yr, J1.QuasiDiagonalScale(El.RIGHT, El.LOWER, jnp.asarray(dc),
                                     jnp.asarray(sc), Xcj, conjugated=True))
    Zr = T1.QuasiDiagonalSolve(RIGHT, LOWER, dc, sc, Xct, conjugated=True)
    _close(Zr, xc @ np.linalg.inv(Dh), 1e-13)
    _close(Zr, J1.QuasiDiagonalSolve(El.RIGHT, El.LOWER, jnp.asarray(dc),
                                     jnp.asarray(sc), Xcj, conjugated=True))


def test_swaps_and_transform2x2(grid):
    """Swap.cpp RowSwap/ColSwap/SymmetricSwap/HermitianSwap and
    Transform2x2.cpp Rows/Cols/vector-pair forms."""
    rng = np.random.default_rng(21)
    a = rng.standard_normal((9, 7))
    Aj = El.DistMatrix.from_global(a, grid=grid)
    At = Et.DistMatrix.from_global(a, grid=CPU)
    _close(T1.RowSwap(At, 1, 4), J1.RowSwap(Aj, 1, 4), 0.0)
    _close(T1.ColSwap(At, 0, 3), J1.ColSwap(Aj, 0, 3), 0.0)
    s = np.tril(a[:7, :7] + a[:7, :7].T)
    Sj = El.DistMatrix.from_global(s, grid=grid)
    St = Et.DistMatrix.from_global(s, grid=CPU)
    _close(T1.SymmetricSwap(LOWER, St, 1, 5),
           J1.SymmetricSwap(El.LOWER, Sj, 1, 5), 0.0)
    _close(T1.HermitianSwap(LOWER, St, 2, 6),
           J1.HermitianSwap(El.LOWER, Sj, 2, 6), 0.0)
    G = np.asarray([[2.0, 1.0], [0.5, -1.0]])
    _close(T1.Transform2x2Rows(G, At, 0, 2), J1.Transform2x2Rows(G, Aj, 0, 2))
    _close(T1.Transform2x2Cols(G, At, 1, 3), J1.Transform2x2Cols(G, Aj, 1, 3))
    v1t = Et.DistMatrix.from_global(a[:, :1], grid=CPU)
    v2t = Et.DistMatrix.from_global(a[:, 1:2], grid=CPU)
    n1, n2 = T1.Transform2x2(G, v1t, v2t)
    _close(_np(n1)[:, 0], G[0, 0] * a[:, 0] + G[0, 1] * a[:, 1])
    _close(_np(n2)[:, 0], G[1, 0] * a[:, 0] + G[1, 1] * a[:, 1])


def test_minabs_and_norm_vectors(grid):
    """ColumnMinAbs(.Nonzero)/RowMinAbs/RowMaxNorms/TwoNorms aliases +
    RealToComplex."""
    rng = np.random.default_rng(22)
    a = rng.standard_normal((9, 7))
    a[:, 2] = 0.0
    A = Et.DistMatrix.from_global(a, grid=CPU)
    _close(_np(T1.ColumnMinAbs(A))[:7], np.abs(a).min(axis=0), 0.0)
    expn = [np.min(np.abs(a[:, j])[a[:, j] != 0])
            if np.any(a[:, j] != 0) else 0.0 for j in range(7)]
    _close(_np(T1.ColumnMinAbsNonzero(A))[:7], np.asarray(expn), 0.0)
    _close(_np(T1.RowMinAbs(A))[:9], np.abs(a).min(axis=1), 0.0)
    nz = np.where(a != 0, np.abs(a), np.inf)
    _close(_np(T1.RowMinAbsNonzero(A))[:9], nz.min(axis=1), 0.0)
    _close(_np(T1.RowMaxNorms(A))[:9], np.abs(a).max(axis=1), 0.0)
    _close(_np(T1.ColumnTwoNorms(A))[:7], np.linalg.norm(a, axis=0), 1e-12)
    _close(_np(T1.RowTwoNorms(A))[:9], np.linalg.norm(a, axis=1), 1e-12)
    _close(_np(T1.ColumnMaxNorms(A))[:7], np.abs(a).max(axis=0), 0.0)
    assert T1.RealToComplex(A).dtype == torch.complex128


_D = np.array([3.0, 2.5, 4.0, 3.5, 2.0])
_DSUB = np.array([0.5, 0.0, -0.8, 0.0])
_VIEW_READERS = {
    # name: (op on (A, Y), the same through Transpose's copy, copies made)
    "RowNorms": (lambda A, Y: T1.RowNorms(A),
                 lambda A, Y: T1.ColumnNorms(T1.Transpose(A)), 0),
    "RowMinAbs": (lambda A, Y: T1.RowMinAbs(A),
                  lambda A, Y: T1.ColumnMinAbs(T1.Transpose(A)), 0),
    "RowMinAbsNonzero": (
        lambda A, Y: T1.RowMinAbsNonzero(A),
        lambda A, Y: T1.ColumnMinAbsNonzero(T1.Transpose(A)), 0),
    "TransposeAxpy": (lambda A, Y: T1.TransposeAxpy(0.5, A, Y),
                      lambda A, Y: T1.Axpy(0.5, T1.Transpose(A), Y), 0),
    "AdjointAxpy": (lambda A, Y: T1.AdjointAxpy(0.5, A, Y),
                    lambda A, Y: T1.Axpy(0.5, T1.Adjoint(A), Y), 0),
    # the RIGHT side writes its result with one transpose
    "QuasiDiagonalScale RIGHT": (
        lambda A, Y: T1.QuasiDiagonalScale(RIGHT, LOWER, _D, _DSUB, Y),
        lambda A, Y: T1.Transpose(T1.QuasiDiagonalScale(
            LEFT, LOWER, _D, _DSUB, T1.Transpose(Y))), 1),
    "QuasiDiagonalSolve RIGHT": (
        lambda A, Y: T1.QuasiDiagonalSolve(RIGHT, LOWER, _D, _DSUB, Y),
        lambda A, Y: T1.Transpose(T1.QuasiDiagonalSolve(
            LEFT, LOWER, _D, _DSUB, T1.Transpose(Y))), 1),
}


@pytest.mark.parametrize("name", list(_VIEW_READERS))
def test_transpose_readers_take_a_view(rng, monkeypatch, name):
    """The row reductions, Transpose/AdjointAxpy and the RIGHT quasi-diagonal
    operations read A^T through a view: they call K9's transpose (a copy of
    the whole matrix on the card) only for a result they return, and give
    what the route through Transpose's copy gives, exactly."""
    op, through_copy, copies = _VIEW_READERS[name]
    calls, transpose = [], T1.transpose

    def counted(x, conjugate=False):
        calls.append(tuple(x.shape))
        return transpose(x, conjugate)

    monkeypatch.setattr(T1, "transpose", counted)
    a = rng.standard_normal((6, 5))
    a[1, 3] = 0.0
    A = Et.DistMatrix.from_global(a, grid=CPU)
    Y = Et.DistMatrix.from_global(rng.standard_normal((5, 6)), grid=CPU)
    want = through_copy(A, Y)
    calls.clear()
    got = op(A, Y)
    assert len(calls) == copies
    assert np.array_equal(_np(got), _np(want))


def test_loc_reduction_family(rng, grid):
    """MaxLoc/MinLoc/MinAbsLoc + Symmetric/Vector variants against the
    JAX package (reference: MaxLoc.cpp / MinAbsLoc.hpp semantics)."""
    a, Aj, At = _mk(rng, grid, 7, 5)
    for tfn, jfn in ((T1.MaxLoc, J1.MaxLoc), (T1.MinLoc, J1.MinLoc),
                     (T1.MinAbsLoc, J1.MinAbsLoc),
                     (T1.MaxAbsLoc, J1.MaxAbsLoc)):
        v, i, j = tfn(At)
        jv, ji, jj = jfn(Aj)
        assert (int(i), int(j)) == (int(ji), int(jj))
        assert float(v) == float(jv)
    s, Sj, St = _mk(rng, grid, 6, 6)
    for name in ("SymmetricMaxLoc", "SymmetricMinLoc", "SymmetricMaxAbsLoc",
                 "SymmetricMinAbsLoc"):
        for tu, ju in ((LOWER, El.LOWER), (UPPER, El.UPPER)):
            v, i, j = getattr(T1, name)(tu, St)
            jv, ji, jj = getattr(J1, name)(ju, Sj)
            assert (int(i), int(j), float(v)) == (int(ji), int(jj), float(jv))
    x, Xj, Xt = _mk(rng, grid, 9, 1)
    for name in ("VectorMaxLoc", "VectorMinLoc", "VectorMinAbsLoc",
                 "VectorMaxAbsLoc"):
        assert int(getattr(T1, name)(Xt)[1]) == int(getattr(J1, name)(Xj)[1])
    xr, XRj, XRt = _mk(rng, grid, 1, 9)
    assert int(T1.VectorMaxLoc(XRt)[1]) == int(np.argmax(xr))
    c, Cj, Ct = _mk(rng, grid, 4, 4, np.complex128)
    with pytest.raises(TypeError):
        T1.MaxLoc(Ct)
    v, i, j = T1.MinAbsLoc(Ct)
    k = np.argmin(np.abs(c))
    assert (int(i), int(j)) == (k // 4, k % 4)


def test_hilbert_schmidt(rng, grid):
    a, Aj, At = _mk(rng, grid, 6, 4, np.complex128)
    b, Bj, Bt = _mk(rng, grid, 6, 4, np.complex128)
    assert abs(complex(T1.HilbertSchmidt(At, Bt)) - np.vdot(a, b)) \
        <= 1e-13 * abs(np.vdot(a, b))
    assert abs(complex(T1.Dotu(At, Bt)) - np.sum(a * b)) <= 1e-12


def test_symmetric_2x2_inv(rng, grid):
    d = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    d[1, 1] += 3.0
    d[0, 1] = d[1, 0]
    inv = T1.Symmetric2x2Inv(LOWER, d).numpy()
    _close(inv, np.array(J1.Symmetric2x2Inv(El.LOWER, jnp.asarray(d))))
    inv[0, 1] = inv[1, 0]
    np.testing.assert_allclose(inv @ d, np.eye(2), atol=1e-12)
    h = np.array([[0.5, 0], [0, -1.5]], np.complex128)
    h[1, 0] = 2.0 + 1.0j
    h[0, 1] = np.conj(h[1, 0])
    invh = T1.Symmetric2x2Inv(LOWER, h, conjugate=True).numpy()
    invh[0, 1] = np.conj(invh[1, 0])
    np.testing.assert_allclose(invh @ h, np.eye(2), atol=1e-12)
    with pytest.raises(NotImplementedError):
        T1.Symmetric2x2Inv(UPPER, h)


def test_adjoint_axpy(rng, grid):
    a, Aj, At = _mk(rng, grid, 5, 7, np.complex128)
    y, Yj, Yt = _mk(rng, grid, 7, 5, np.complex128)
    out = T1.AdjointAxpy(2.0, At, Yt)
    _close(out, y + 2.0 * np.conj(a.T))
    _close(out, J1.AdjointAxpy(2.0, Aj, Yj))


# ---------------------------------------------------------------------------
# the operations that run on K9, and the rest of the module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_k9_operations_match_jax(rng, grid, dtype):
    """Scale, SafeScale, Axpy, Axpby, Add, Subtract, Hadamard, Zero, Fill,
    Transpose and Adjoint against the JAX package. Real: equal where
    both round once the same way, else 1e-15 of the largest entry
    (SafeScale stages 1/den where JAX divides). Complex products round
    differently in the two libraries: 1e-15. Data movement is exact."""
    a, Aj, At = _mk(rng, grid, 7, 5, dtype)
    b, Bj, Bt = _mk(rng, grid, 7, 5, dtype)
    pairs = [
        (T1.Scale(-1.5, At), J1.Scale(-1.5, Aj), 0.0),
        (T1.SafeScale(3.0, 7.0, At), J1.SafeScale(3.0, 7.0, Aj), 1e-15),
        (T1.Axpy(0.5, At, Bt), J1.Axpy(0.5, Aj, Bj), 1e-15),
        (T1.Axpby(0.5, At, -2.0, Bt), J1.Axpby(0.5, Aj, -2.0, Bj), 1e-15),
        (T1.Add(At, Bt), J1.Add(Aj, Bj), 0.0),
        (T1.Subtract(At, Bt), J1.Subtract(Aj, Bj), 0.0),
        (T1.Hadamard(At, Bt), J1.Hadamard(Aj, Bj), 0.0),
        (T1.Zero(At), J1.Zero(Aj), 0.0),
        (T1.Fill(At, 2.5), J1.Fill(Aj, 2.5), 0.0),
        (T1.Transpose(At), J1.Transpose(Aj), 0.0),
        (T1.Adjoint(At), J1.Adjoint(Aj), 0.0),
    ]
    moves = 4  # the last four only move data
    for k, (port, ref, tol) in enumerate(pairs):
        assert port.data.is_contiguous()
        if dtype == np.complex128 and k < len(pairs) - moves:
            tol = 1e-15
        _close(port, ref, tol)
    T = T1.Transpose(At)
    assert (T.m, T.n, T.col_dist, T.row_dist) == (5, 7, At.row_dist,
                                                  At.col_dist)


def test_structure_and_parts_match_jax(rng, grid):
    """Fill/shift/scale of trapezoids and diagonals, the real/imaginary
    parts, maps and fills, and the diagonal setters against the JAX
    package."""
    a, Aj, At = _mk(rng, grid, 6, 5, np.complex128)
    r, Rj, Rt = _mk(rng, grid, 6, 5)
    d = rng.standard_normal((5, 1))
    Dt = Et.DistMatrix.from_global(d, grid=CPU)
    Dj = El.DistMatrix.from_global(jnp.asarray(d), grid=grid)
    cases = [
        (T1.ShiftDiagonal(At, 2.0, 1), J1.ShiftDiagonal(Aj, 2.0, 1)),
        (T1.ScaleTrapezoid(3.0, LOWER, At, -1),
         J1.ScaleTrapezoid(3.0, El.LOWER, Aj, -1)),
        (T1.FillDiagonal(At, 7.0, -2), J1.FillDiagonal(Aj, 7.0, -2)),
        (T1.MakeTrapezoidal(UPPER, At, 1), J1.MakeTrapezoidal(El.UPPER, Aj, 1)),
        (T1.MakeReal(At), J1.MakeReal(Aj)),
        (T1.Conjugate(At), J1.Conjugate(Aj)),
        (T1.RealPart(At), J1.RealPart(Aj)),
        (T1.ImagPart(At), J1.ImagPart(Aj)),
        (T1.ImagPart(Rt), J1.ImagPart(Rj)),
        (T1.Round(Rt), J1.Round(Rj)),
        (T1.EntrywiseMap(Rt, torch.exp), J1.EntrywiseMap(Rj, jnp.exp)),
        (T1.IndexDependentMap(Rt, lambda i, j, x: x * (i + 2 * j)),
         J1.IndexDependentMap(Rj, lambda i, j, x: x * (i + 2 * j))),
        (T1.IndexDependentFill(Rt, lambda i, j: 1.0 * i - j),
         J1.IndexDependentFill(Rj, lambda i, j: 1.0 * i - j)),
        (T1.EntrywiseFill(Rt, lambda shape: np.ones(shape)),
         J1.EntrywiseFill(Rj, lambda shape: jnp.ones(shape))),
        (T1.SetDiagonal(Rt, Dt), J1.SetDiagonal(Rj, Dj)),
        (T1.UpdateDiagonal(Rt, 2.0, Dt, 0), J1.UpdateDiagonal(Rj, 2.0, Dj, 0)),
        (T1.DiagonalScale(RIGHT, NORMAL, Dt, Rt),
         J1.DiagonalScale(El.RIGHT, El.NORMAL, Dj, Rj)),
        (T1.GetRealPartOfDiagonal(At), J1.GetRealPartOfDiagonal(Aj)),
        (T1.GetImagPartOfDiagonal(At), J1.GetImagPartOfDiagonal(Aj)),
        (T1.SetRealPartOfDiagonal(At, Dt), J1.SetRealPartOfDiagonal(Aj, Dj)),
        (T1.SetImagPartOfDiagonal(At, Dt), J1.SetImagPartOfDiagonal(Aj, Dj)),
        (T1.UpdateRealPartOfDiagonal(At, 2.0, Dt),
         J1.UpdateRealPartOfDiagonal(Aj, 2.0, Dj)),
        (T1.UpdateImagPartOfDiagonal(At, -1.0, Dt),
         J1.UpdateImagPartOfDiagonal(Aj, -1.0, Dj)),
    ]
    for port, ref in cases:
        _close(port, ref)
    with pytest.raises(ValueError):
        T1.SetImagPartOfDiagonal(Rt, Dt)


def test_submatrices_reductions_and_swap_match_jax(rng, grid):
    a, Aj, At = _mk(rng, grid, 7, 6)
    b, Bj, Bt = _mk(rng, grid, 3, 2)
    c, Cj, Ct = _mk(rng, grid, 7, 6)
    _close(T1.GetSubmatrix(At, slice(2, 6), slice(1, 3)),
           J1.GetSubmatrix(Aj, slice(2, 6), slice(1, 3)), 0.0)
    _close(T1.SetSubmatrix(At, 3, 2, Bt), J1.SetSubmatrix(Aj, 3, 2, Bj), 0.0)
    _close(T1.UpdateSubmatrix(At, 1, 4, 2.0, Bt),
           J1.UpdateSubmatrix(Aj, 1, 4, 2.0, Bj))
    for tfn, jfn in ((T1.Nrm2, J1.Nrm2), (T1.MaxAbs, J1.MaxAbs),
                     (T1.MinAbs, J1.MinAbs), (T1.Max, J1.Max),
                     (T1.Min, J1.Min), (T1.Trace, J1.Trace)):
        _close(tfn(At), jfn(Aj))
    _close(T1.Dot(At, Ct), J1.Dot(Aj, Cj), 1e-13)
    _close(T1.EntrywiseNorm(At, 3.0), J1.EntrywiseNorm(Aj, 3.0))
    _close(_np(T1.ColumnNorms(At))[:6], np.asarray(J1.ColumnNorms(Aj))[:6])
    _close(_np(T1.RowNorms(At))[:7], np.asarray(J1.RowNorms(Aj))[:7])
    S1, S2 = T1.Swap(At, Ct)
    _close(S1, c, 0.0)
    _close(S2, a, 0.0)
    assert T1.Broadcast(At) is At
