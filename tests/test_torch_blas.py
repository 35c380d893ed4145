"""Port parity: blas (Gemm, Trsm, trinv, level 1).

Each input is made with numpy from a seed and given to the JAX package on
a one-device grid and to its PyTorch port on the CPU. Comparisons are in
float64 unless a test says otherwise, to 1e-10 of the result's scale: the
two packages run the same blocked algorithms, but their products sum in
other orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import elementalx as El
import elementalx_torch as Et
from elementalx.core import types as J
from elementalx_torch.core import types as T

F64_TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers at once: keep torch to one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def grids():
    """(JAX one-device grid, port CPU grid)."""
    return El.Grid(devices=jax.devices()[:1]), Et.Grid("cpu")


def _both(grids, a):
    jg, tg = grids
    return (El.DistMatrix.from_global(a, grid=jg),
            Et.DistMatrix.from_global(a, grid=tg))


def _close(port, ref, tol=F64_TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(port - ref).max() / scale
    assert err < tol, f"relative error {err} >= {tol}"


def _tag(enum_value):
    """The port's tag for a JAX tag, by name."""
    return getattr(T, enum_value.name)


@pytest.mark.parametrize("oa", [J.NORMAL, J.TRANSPOSE], ids=["N", "T"])
@pytest.mark.parametrize("ob", [J.NORMAL, J.TRANSPOSE], ids=["N", "T"])
def test_gemm_orientations_with_beta(grids, oa, ob):
    rng = np.random.default_rng(20)
    m, k, n = 23, 17, 29
    a = rng.standard_normal((m, k) if oa == J.NORMAL else (k, m))
    b = rng.standard_normal((k, n) if ob == J.NORMAL else (n, k))
    c = rng.standard_normal((m, n))
    (JA, TA), (JB, TB), (JC, TC) = (_both(grids, x) for x in (a, b, c))
    ref = El.Gemm(oa, ob, 1.5, JA, JB, beta=-0.5, C=JC)
    out = Et.Gemm(_tag(oa), _tag(ob), 1.5, TA, TB, beta=-0.5, C=TC)
    assert (out.m, out.n, out.dist) == (ref.m, ref.n, (T.MC, T.MR))
    _close(out.global_array(), ref.global_array())


def test_gemm_adjoint_complex(grids):
    rng = np.random.default_rng(21)
    a = rng.standard_normal((9, 6)) + 1j * rng.standard_normal((9, 6))
    b = rng.standard_normal((9, 4)) + 1j * rng.standard_normal((9, 4))
    (JA, TA), (JB, TB) = _both(grids, a), _both(grids, b)
    ref = El.Gemm(J.ADJOINT, J.NORMAL, 2.0, JA, JB)
    out = Et.Gemm(T.ADJOINT, T.NORMAL, 2.0, TA, TB)
    _close(out.global_array(), ref.global_array())


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_gemm_low_precision(grids, dtype):
    """float32: 1e-5 (f32 sums, another order). bfloat16: the product is
    rounded to bf16 in both packages, so entries may differ by one bf16
    step (2^-7 of the largest): 1e-2."""
    rng = np.random.default_rng(22)
    a = rng.standard_normal((40, 24)).astype(np.float32)
    b = rng.standard_normal((24, 16)).astype(np.float32)
    jg, tg = grids
    if dtype == "bfloat16":
        JA = El.DistMatrix.from_global(jnp.asarray(a, jnp.bfloat16), grid=jg)
        JB = El.DistMatrix.from_global(jnp.asarray(b, jnp.bfloat16), grid=jg)
        TA = Et.DistMatrix.from_global(torch.tensor(a).bfloat16(), grid=tg)
        TB = Et.DistMatrix.from_global(torch.tensor(b).bfloat16(), grid=tg)
        tol = 1e-2
    else:
        (JA, TA), (JB, TB) = _both(grids, a), _both(grids, b)
        tol = 1e-5
    ref = El.Gemm(J.NORMAL, J.NORMAL, 1.0, JA, JB)
    out = Et.Gemm(T.NORMAL, T.NORMAL, 1.0, TA, TB)
    assert out.dtype == TA.dtype
    _close(out.global_array().astype(np.float32),
           np.asarray(ref.global_array(), np.float32), tol)


def test_gemm_explicit_summa_needs_multi_gpu(grids):
    _, TA = _both(grids, np.eye(4))
    for alg in (T.GEMM_SUMMA_A, T.GEMM_SUMMA_B, T.GEMM_SUMMA_C,
                T.GEMM_SUMMA_DOT, T.GEMM_CANNON):
        with pytest.raises(NotImplementedError, match="queue 1 item 11"):
            Et.Gemm(T.NORMAL, T.NORMAL, 1.0, TA, TA, alg=alg)


def _tri(rng, n, lower):
    t = rng.standard_normal((n, n))
    t = np.tril(t) if lower else np.triu(t)
    return t + n * np.eye(n)


@pytest.mark.parametrize("side", [J.LEFT, J.RIGHT], ids=["L", "R"])
@pytest.mark.parametrize("uplo", [J.LOWER, J.UPPER], ids=["lo", "up"])
@pytest.mark.parametrize("orient", [J.NORMAL, J.ADJOINT], ids=["N", "H"])
def test_trsm_cases(grids, side, uplo, orient):
    """n=44 with blocksize 8: six diagonal blocks, ragged against the
    recursive halving."""
    rng = np.random.default_rng(23)
    n, nrhs = 44, 7
    a = _tri(rng, n, uplo == J.LOWER)
    b = rng.standard_normal((n, nrhs) if side == J.LEFT else (nrhs, n))
    (JA, TA), (JB, TB) = _both(grids, a), _both(grids, b)
    ref = El.Trsm(side, uplo, orient, J.NON_UNIT, 0.5, JA, JB, blocksize=8)
    out = Et.Trsm(_tag(side), _tag(uplo), _tag(orient), T.NON_UNIT, 0.5,
                  TA, TB, blocksize=8)
    _close(out.global_array(), ref.global_array())


@pytest.mark.parametrize("side", [J.LEFT, J.RIGHT], ids=["L", "R"])
def test_trsm_transpose_unit(grids, side):
    rng = np.random.default_rng(24)
    n = 30
    a = _tri(rng, n, True) / n
    b = rng.standard_normal((n, 5) if side == J.LEFT else (5, n))
    (JA, TA), (JB, TB) = _both(grids, a), _both(grids, b)
    ref = El.Trsm(side, J.LOWER, J.TRANSPOSE, J.UNIT, 1.0, JA, JB,
                  blocksize=8)
    out = Et.Trsm(_tag(side), T.LOWER, T.TRANSPOSE, T.UNIT, 1.0, TA, TB,
                  blocksize=8)
    _close(out.global_array(), ref.global_array())


def test_right_solve_adjoint_lower():
    from elementalx.blas.trsm import _right_solve_adjoint_lower as jsolve
    from elementalx_torch.blas.trsm import _right_solve_adjoint_lower as tsolve

    rng = np.random.default_rng(25)
    t = _tri(rng, 48, True)
    b = rng.standard_normal((20, 48))
    ref = np.asarray(jsolve(jnp.asarray(t), jnp.asarray(b), 8))
    out = tsolve(torch.tensor(t), torch.tensor(b), 8).numpy()
    _close(out, ref)


def _trsm_left_lower(grid, t, b):
    return Et.Trsm(T.LEFT, T.LOWER, T.NORMAL, T.NON_UNIT, 1.0,
                   Et.DistMatrix.from_global(t, grid=grid),
                   Et.DistMatrix.from_global(b, grid=grid), blocksize=8)


def _trsm_right(grid, t, b):
    return Et.Trsm(T.RIGHT, T.LOWER, T.ADJOINT, T.NON_UNIT, 1.0,
                   Et.DistMatrix.from_global(t, grid=grid),
                   Et.DistMatrix.from_global(b.T, grid=grid), blocksize=8)


def _right_adjoint_lower(grid, t, b):
    from elementalx_torch.blas.trsm import _right_solve_adjoint_lower

    return _right_solve_adjoint_lower(torch.tensor(t), torch.tensor(b.T), 8)


@pytest.mark.parametrize("solve", [_trsm_left_lower, _trsm_right,
                                   _right_adjoint_lower],
                         ids=["left_lower", "right", "right_adjoint_lower"])
def test_trsm_leaves_no_cycle(solve):
    """A solve frees its triangle when it returns: with every collected
    object kept in gc.garbage, a Trsm adds no tensor there (a recursion
    through a closure that refers to itself would keep T and the diagonal
    inverses until the next collection)."""
    import gc

    rng = np.random.default_rng(29)
    t = _tri(rng, 44, True)
    b = rng.standard_normal((44, 7))
    grid = Et.Grid("cpu")
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.garbage.clear()
        out = solve(grid, t, b)
        gc.collect()
        left = [x for x in gc.garbage if isinstance(x, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert out is not None
    assert left == []


@pytest.mark.parametrize("n", [1, 16, 37, 100])
@pytest.mark.parametrize("name", ["tri_inv_upper", "tri_inv_lower",
                                  "tri_inv_lower_unit"])
def test_tri_inv(n, name):
    from elementalx.blas import trinv as jtrinv
    from elementalx_torch.blas import trinv as ttrinv

    rng = np.random.default_rng(26)
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    ref = np.asarray(getattr(jtrinv, name)(jnp.asarray(a)))
    out = getattr(ttrinv, name)(torch.tensor(a)).numpy()
    _close(out, ref)


def test_tri_inv_batched():
    """Leading dimensions are a batch (the JAX package vmaps)."""
    from elementalx.blas.trinv import tri_inv_upper as jinv
    from elementalx_torch.blas.trinv import tri_inv_upper as tinv

    rng = np.random.default_rng(27)
    a = rng.standard_normal((3, 40, 40)) + 40 * np.eye(40)
    out = tinv(torch.tensor(a)).numpy()
    for i in range(3):
        _close(out[i], np.asarray(jinv(jnp.asarray(a[i]))))


@pytest.mark.parametrize("uplo", [J.LOWER, J.UPPER], ids=["lo", "up"])
def test_level1_structure(grids, uplo):
    from elementalx.blas import level1 as jl1

    rng = np.random.default_rng(28)
    a = rng.standard_normal((11, 11))
    JA, TA = _both(grids, a)
    for off in (-2, 0, 3):
        _close(Et.MakeTrapezoidal(_tag(uplo), TA, off).global_array(),
               jl1.MakeTrapezoidal(uplo, JA, off).global_array())
    _close(Et.MakeHermitian(_tag(uplo), TA).global_array(),
           jl1.MakeHermitian(uplo, JA).global_array())


def test_level1_transpose_norms(grids):
    from elementalx.blas import level1 as jl1

    rng = np.random.default_rng(29)
    a = rng.standard_normal((7, 12)) + 1j * rng.standard_normal((7, 12))
    JA, TA = _both(grids, a)
    for jf, tf in ((jl1.Transpose, Et.Transpose), (jl1.Adjoint, Et.Adjoint)):
        r, o = jf(JA), tf(TA)
        assert (o.m, o.n, o.dist) == (r.m, r.n, (T.MR, T.MC))
        _close(o.global_array(), r.global_array())
    _close(float(Et.Nrm2(TA)), float(jl1.Nrm2(JA)))
    _close(float(Et.MaxAbs(TA)), float(jl1.MaxAbs(JA)))
    zero = Et.DistMatrix.from_global(np.zeros((3, 3)), grid=grids[1])
    assert float(Et.Nrm2(zero)) == 0.0
