"""Port parity: Permutation, LU, its solves, LUFullPiv, LUMod and the LU
step.

Each input is made with numpy from a seed and given to the JAX package
(on the 4x2 test grid, as tests/lapack/test_lu.py runs it, or on one
device) and to its PyTorch port on the CPU, where K4's wrapper takes its
plain version (LAPACK getrf, as the JAX package's CPU route). Pivots are
held to be identical; factors agree to float64 rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import elementalx as El
import elementalx_torch as Et
from elementalx.core import types as J
from elementalx.lapack import lu as jlu
from elementalx_torch.core import types as T
from elementalx_torch.entry import linear_solve_step, make_lu_problem
from elementalx_torch.lapack import lu as tlu
from elementalx_torch.lapack import perm as tperm

CPU = Et.Grid("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers at once: keep torch to one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def one_device():
    return El.Grid(devices=jax.devices()[:1])


def _t(a):
    return Et.DistMatrix.from_global(a, grid=CPU)


def _perm(P, m):
    """The port's view of a JAX Permutation's first m entries."""
    return tperm.Permutation.from_reference(np.asarray(P.perm), m,
                                            grid=CPU).perm.numpy()[:m]


def _rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / np.abs(ref).max()


def _split_lu(f, m):
    return np.tril(f, -1) + np.eye(m), np.triu(f)


# ---------------------------------------------------------------------------
# Permutation
# ---------------------------------------------------------------------------


def test_permutation_roundtrip(grid, rng):
    """The JAX test's round trip, with the JAX Permutation (padded to the
    4x2 grid's quantum) carried across by from_reference."""
    from elementalx.lapack.perm import Permutation as JPerm

    n = 12
    a = rng.standard_normal((n, n))
    A = El.DistMatrix.from_global(a, grid=grid)
    p = np.concatenate([rng.permutation(n), np.arange(n, A.data.shape[0])])
    JP = JPerm(jnp.asarray(p, jnp.int32), n)
    P = tperm.Permutation.from_reference(np.asarray(JP.perm), n, grid=CPU)
    assert P.perm.shape == (n,) and P.perm.dtype == torch.int64
    TA = _t(a)
    B = P.apply_rows(TA)
    np.testing.assert_array_equal(B.global_array(), a[p[:n], :])
    np.testing.assert_array_equal(B.global_array(),
                                  JP.apply_rows(A).global_array())
    np.testing.assert_array_equal(P.apply_rows(B, inverse=True).global_array(),
                                  a)
    C = P.apply_cols(TA)
    np.testing.assert_array_equal(C.global_array(),
                                  JP.apply_cols(A).global_array())
    np.testing.assert_array_equal(P.to_explicit().numpy(),
                                  np.asarray(JP.to_explicit())[:n, :n])
    S = P.compose_swap(0, 5)
    np.testing.assert_array_equal(S.perm.numpy(),
                                  np.asarray(JP.compose_swap(0, 5).perm)[:n])
    np.testing.assert_array_equal(
        tperm.Permutation.identity(n, n).perm.numpy(), np.arange(n))


def test_permutation_from_reference_refuses_a_non_permutation():
    with pytest.raises(ValueError):
        tperm.Permutation.from_reference(np.array([0, 0, 2]), 3, grid=CPU)


def test_perm_module_extras(grid, rng):
    """perm/: PermuteSymmetrically (+inverse), InversePermuteRows/Cols,
    PivotsToPartialPermutation, each against the JAX function."""
    from elementalx.lapack import perm as jperm

    n = 9
    a = rng.standard_normal((n, n))
    a = a + a.T
    A = El.DistMatrix.from_global(a, grid=grid)
    TA = _t(a)
    pm = rng.permutation(n)
    JP = jperm.Permutation(jnp.asarray(pm, jnp.int32), n)
    P = tperm.Permutation(torch.as_tensor(pm), n)
    for jf, tf in ((jperm.PermuteSymmetrically, tperm.PermuteSymmetrically),
                   (jperm.InversePermuteSymmetrically,
                    tperm.InversePermuteSymmetrically),
                   (jperm.InversePermuteRows, tperm.InversePermuteRows),
                   (jperm.InversePermuteCols, tperm.InversePermuteCols)):
        np.testing.assert_array_equal(tf(P, TA).global_array(),
                                      jf(JP, A).global_array())
    np.testing.assert_array_equal(tperm.PermuteRows(P, TA).global_array(),
                                  a[pm])
    np.testing.assert_array_equal(tperm.PermuteCols(P, TA).global_array(),
                                  a[:, pm])
    back = tperm.InversePermuteSymmetrically(P, tperm.PermuteSymmetrically(
        P, TA))
    np.testing.assert_array_equal(back.global_array(), a)
    piv = np.asarray([3, 1, 4, 3, 4], dtype=np.int32)
    np.testing.assert_array_equal(
        tperm.PivotsToPartialPermutation(piv, 5).perm.numpy(),
        np.asarray(jperm.PivotsToPartialPermutation(piv, 5).perm))
    np.testing.assert_array_equal(
        tperm.PivotsToPartialPermutation(torch.as_tensor(piv), 5).perm,
        tperm.PivotsToPartialPermutation(piv, 5).perm)


# ---------------------------------------------------------------------------
# LU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [24, 40])
def test_lu_factorization(grid, rng, n):
    """float64, blocksize 8: identical pivots, factor within 1e-12 of the
    JAX one, and the reference's residual and growth bounds."""
    a = rng.standard_normal((n, n))
    JF, JP = El.LU(El.DistMatrix.from_global(a, grid=grid), blocksize=8)
    F, P = Et.LU(_t(a), blocksize=8)
    np.testing.assert_array_equal(P.perm.numpy(), _perm(JP, n))
    f = F.global_array()
    assert _rel(f, JF.global_array()) < 1e-12
    ell, u = _split_lu(f, n)
    pa = a[P.perm.numpy(), :]
    assert np.linalg.norm(pa - ell @ u) / np.linalg.norm(a) < 1e-13
    assert np.max(np.abs(ell)) <= 1.0 + 1e-12


def test_lu_complex(grid, rng):
    """complex128, n=20 (padded to 24 on the JAX grid), blocksize 4."""
    n = 20
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    JF, JP = El.LU(El.DistMatrix.from_global(a, grid=grid), blocksize=4)
    F, P = Et.LU(_t(a), blocksize=4)
    np.testing.assert_array_equal(P.perm.numpy(), _perm(JP, n))
    f = F.global_array()
    assert _rel(f, JF.global_array()) < 1e-12
    ell, u = _split_lu(f, n)
    assert np.linalg.norm(a[P.perm.numpy()] - ell @ u) / np.linalg.norm(a) \
        < 1e-13


def test_lu_f32_one_device(one_device):
    """float32, n=96 with blocksize 32: the JAX package runs its products
    at bf16x3, the port in FP32. The pivots agree (the test matrix has no
    near-tie) and the factors to 1e-4 relative."""
    a = np.random.default_rng(40).standard_normal((96, 96)).astype(np.float32)
    JF, JP = El.LU(El.DistMatrix.from_global(a, grid=one_device),
                   blocksize=32)
    F, P = Et.LU(_t(a), blocksize=32)
    assert F.dtype == torch.float32
    np.testing.assert_array_equal(P.perm.numpy(), _perm(JP, 96))
    assert _rel(F.global_array(), JF.global_array()) < 1e-4


def test_lu_bf16_storage(one_device):
    """bfloat16 storage: each panel is factored in float32 and stored in
    bf16, as the JAX LU does. Tolerance: P A = L U to bf16 rounding
    (2^-8) grown over 48 columns."""
    a = np.random.default_rng(41).standard_normal((48, 48)).astype(np.float32)
    F, P = Et.LU(Et.DistMatrix.from_global(torch.tensor(a).bfloat16(),
                                           grid=CPU), blocksize=16)
    assert F.dtype == torch.bfloat16
    ell, u = _split_lu(F.global_array().astype(np.float64), 48)
    ab = torch.tensor(a).bfloat16().double().numpy()
    assert np.abs(ab[P.perm.numpy()] - ell @ u).max() / np.abs(a).max() < 5e-2


def test_lu_default_blocksize(one_device):
    """Without a blocksize (M < 2048: the blocksize stack's 128)."""
    a = np.random.default_rng(42).standard_normal((150, 150))
    JF, JP = El.LU(El.DistMatrix.from_global(a, grid=one_device))
    F, P = Et.LU(_t(a))
    np.testing.assert_array_equal(P.perm.numpy(), _perm(JP, 150))
    assert _rel(F.global_array(), JF.global_array()) < 1e-12


def test_lu_leaves_input_unchanged(rng):
    TA = _t(rng.standard_normal((30, 30)))
    before = TA.data.clone()
    Et.LU(TA, blocksize=8)
    assert torch.equal(TA.data, before)


@pytest.mark.parametrize("orient", [J.NORMAL, J.TRANSPOSE, J.ADJOINT],
                         ids=["N", "T", "A"])
def test_lu_solve(grid, rng, orient):
    """SolveAfter on a complex factor: the reference's scaled residual
    bound, and X within 1e-10 of the JAX solution."""
    n, nrhs = 32, 5
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    b = rng.standard_normal((n, nrhs)) + 1j * rng.standard_normal((n, nrhs))
    JF, JP = El.LU(El.DistMatrix.from_global(a, grid=grid), blocksize=8)
    JX = jlu.SolveAfter(orient, JF, JP, El.DistMatrix.from_global(b,
                                                                  grid=grid))
    F, P = Et.LU(_t(a), blocksize=8)
    X = tlu.SolveAfter(getattr(T, orient.name), F, P, _t(b)).global_array()
    op = {J.NORMAL: a, J.TRANSPOSE: a.T, J.ADJOINT: a.conj().T}[orient]
    eps = np.finfo(np.float64).eps
    assert np.max(np.abs(op @ X - b)) / (eps * n * np.max(np.abs(b))) < 100
    assert _rel(X, JX.global_array()) < 1e-10


def test_linear_solve(grid, rng):
    n = 28
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, 3))
    JX = El.LinearSolve(El.DistMatrix.from_global(a, grid=grid),
                        El.DistMatrix.from_global(b, grid=grid))
    X = Et.LinearSolve(_t(a), _t(b)).global_array()
    assert np.linalg.norm(a @ X - b) / np.linalg.norm(b) < 1e-11
    assert _rel(X, JX.global_array()) < 1e-10
    from elementalx_torch.lapack import solve

    assert solve.LinearSolve is Et.LinearSolve
    assert solve.HPDSolve is Et.HPDSolve


def test_lu_full_pivoting(grid, rng):
    """Identical row and column pivots; factor within 1e-12."""
    n = 16
    a = rng.standard_normal((n, n))
    JF, JP, JQ = El.LUFullPiv(El.DistMatrix.from_global(a, grid=grid))
    F, P, Q = Et.LUFullPiv(_t(a))
    np.testing.assert_array_equal(P.perm.numpy(), _perm(JP, n))
    np.testing.assert_array_equal(Q.perm.numpy(), _perm(JQ, n))
    f = F.global_array()
    assert _rel(f, JF.global_array()) < 1e-12
    ell, u = _split_lu(f, n)
    paq = a[P.perm.numpy(), :][:, Q.perm.numpy()]
    assert np.linalg.norm(paq - ell @ u) / np.linalg.norm(a) < 1e-13


@pytest.mark.parametrize("tau", [0.0, 0.5])
def test_lu_mod(grid, rng, tau):
    """Rank-one update of the JAX package's own factor, carried across:
    identical permutation, factor within 1e-12, and the reference's
    residual bound."""
    n = 24
    a = rng.standard_normal((n, n))
    u = rng.standard_normal(n)
    v = rng.standard_normal(n)
    JF, JP = El.LU(El.DistMatrix.from_global(a, grid=grid), blocksize=8)
    JF2, JP2 = jlu.LUMod(JF, JP, u, v, conjugate=True, tau=tau)
    F = Et.DistMatrix.from_reference(np.asarray(JF.data), n, n, grid=CPU)
    P = tperm.Permutation.from_reference(np.asarray(JP.perm), n, grid=CPU)
    F2, P2 = Et.LUMod(F, P, u, v, conjugate=True, tau=tau)
    np.testing.assert_array_equal(P2.perm.numpy(), _perm(JP2, n))
    f = F2.global_array()
    assert _rel(f, JF2.global_array()) < 1e-12
    ell, uu = _split_lu(f, n)
    target = a + np.outer(u, v)
    pa = target[P2.perm.numpy(), :]
    assert np.linalg.norm(pa - ell @ uu) / np.linalg.norm(target) < 1e-11


def test_lu_mod_solve(grid, rng):
    n = 16
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    u = rng.standard_normal(n)
    v = rng.standard_normal(n)
    b = rng.standard_normal((n, 2))
    F, P = Et.LU(_t(a))
    F2, P2 = Et.LUMod(F, P, u, v, tau=0.5)
    X = tlu.SolveAfter(T.NORMAL, F2, P2, _t(b)).global_array()
    target = a + np.outer(u, v)
    assert np.linalg.norm(target @ X - b) / np.linalg.norm(b) < 1e-10
    JF, JP = El.LU(El.DistMatrix.from_global(a, grid=grid))
    JF2, JP2 = jlu.LUMod(JF, JP, u, v, tau=0.5)
    JX = jlu.SolveAfter(J.NORMAL, JF2, JP2,
                        El.DistMatrix.from_global(b, grid=grid))
    assert _rel(X, JX.global_array()) < 1e-10


def test_lu_mod_refuses_tall():
    F = _t(np.zeros((5, 3)))
    with pytest.raises(ValueError):
        Et.LUMod(F, tperm.Permutation(torch.arange(5), 5), np.ones(5),
                 np.ones(3))


# ---------------------------------------------------------------------------
# Internal routes
# ---------------------------------------------------------------------------


def test_lu_panel_vs_loop(rng):
    """The getrf panel and the column-by-column loop make the same pivot
    choices and so the same factor (as tests/lapack/test_qr.py holds the
    JAX pair), and both match the JAX package's _lu_panel."""
    M, n = 40, 40
    ap = rng.standard_normal((M, n))
    ta = torch.tensor(ap)
    perm0 = torch.arange(M)
    a_loop, p_loop = tlu._lu_panel_loop(ta, perm0, 0, 32, n)
    a_pan, p_pan = tlu._lu_panel(ta, perm0, 0, 32, n)
    np.testing.assert_allclose(a_loop[:, :32].numpy(), a_pan[:, :32].numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(p_loop.numpy(), p_pan.numpy())
    ja, jp = jlu._lu_panel(jnp.asarray(ap), jnp.arange(M, dtype=jnp.int32), 0,
                           32, n)
    np.testing.assert_array_equal(p_pan.numpy(), np.asarray(jp))
    assert _rel(a_pan.numpy(), np.asarray(ja)) < 1e-12
    assert torch.equal(ta, torch.tensor(ap))  # inputs not written


def test_lu_panel_loop_vs_jax_loop(rng):
    """Second panel (k0=16) of the loop route against the JAX loop."""
    M = 48
    ap = rng.standard_normal((M, M))
    perm0 = np.arange(M)
    ta, tp = tlu._lu_panel_loop(torch.tensor(ap), torch.as_tensor(perm0), 16,
                                16, M)
    ja, jp = jlu._lu_panel_loop(jnp.asarray(ap), jnp.asarray(perm0, jnp.int32),
                                16, 16, M)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert _rel(ta.numpy(), np.asarray(ja)) < 1e-12


@pytest.mark.parametrize("shape", [(300, 32), (384, 128)])
def test_getrf_tall_vs_jax(rng, monkeypatch, shape):
    """The CALU tournament with _GETRF_CHUNK=64 in both packages:
    identical composed permutation, packed factor within 1e-12, and the
    JAX test's bounds."""
    monkeypatch.setattr(jlu, "_GETRF_CHUNK", 64)
    monkeypatch.setattr(tlu, "_GETRF_CHUNK", 64)
    M, w = shape
    a = rng.standard_normal((M, w))
    jp, jl = (np.asarray(x) for x in jlu._getrf(jnp.asarray(a)))
    packed, lperm = tlu._getrf(torch.tensor(a))
    np.testing.assert_array_equal(lperm.numpy(), jl)
    assert _rel(packed.numpy(), jp) < 1e-12
    L = np.tril(packed.numpy(), -1)[:, :w] + np.eye(M, w)
    U = np.triu(packed.numpy()[:w, :])
    assert np.abs(a[lperm.numpy()] - L @ U).max() < 1e-12
    assert np.abs(np.tril(L, -1)).max() < 3.0


def test_lu_slab_vs_jax(rng, monkeypatch):
    """The two-level slab with _SLAB_INNER=16 and _GETRF_CHUNK=64 in both
    packages (a (200, 48) slab: three sub-panels, the tournament on the
    first two)."""
    for mod in (jlu, tlu):
        monkeypatch.setattr(mod, "_SLAB_INNER", 16)
        monkeypatch.setattr(mod, "_GETRF_CHUNK", 64)
    a = rng.standard_normal((200, 48))
    jp, jl = (np.asarray(x) for x in jlu._lu_slab(jnp.asarray(a)))
    packed, lperm = tlu._lu_slab(torch.tensor(a))
    np.testing.assert_array_equal(lperm.numpy(), jl)
    assert _rel(packed.numpy(), jp) < 1e-12


def test_lu_with_slabs_vs_jax(one_device, monkeypatch):
    """The whole LU with the slab route on (_SLAB_INNER=16, nb=32):
    physical rows, uout and the final gather, against the JAX LU."""
    for mod in (jlu, tlu):
        monkeypatch.setattr(mod, "_SLAB_INNER", 16)
    a = np.random.default_rng(43).standard_normal((96, 96))
    JF, JP = jlu.LU(El.DistMatrix.from_global(a, grid=one_device),
                    blocksize=32)
    F, P = Et.LU(_t(a), blocksize=32)
    np.testing.assert_array_equal(P.perm.numpy(), _perm(JP, 96))
    assert _rel(F.global_array(), JF.global_array()) < 1e-12


@pytest.mark.parametrize("n,blocksize,rows", [
    (96, 32, 64 + 32),   # three slabs, two updates (full height: 2 * 96)
    (150, None, 75),     # the default blocksize, 75 here: one update
])
def test_lu_update_rows_counts_the_tail_rows(n, blocksize, rows):
    """The trailing updates multiply the rows not yet elected only:
    ``LU.update_rows`` sums M - (k + 1) nb over the updates."""
    a = np.random.default_rng(45).standard_normal((n, n))
    tlu.LU.update_rows = 0
    F, P = Et.LU(_t(a), blocksize=blocksize)
    assert tlu.LU.update_rows == rows
    ell, u = _split_lu(F.global_array(), n)
    assert np.linalg.norm(a[P.perm.numpy()] - ell @ u) \
        / np.linalg.norm(a) < 1e-13


def test_lu_exact_ties_vs_jax(one_device, monkeypatch):
    """Integer entries in {-2, ..., 2} tie exactly in magnitude: the
    pivots, which break ties on the row order the update keeps, equal the
    JAX LU's (slab route on: _SLAB_INNER=16, nb=32), and the factor
    agrees to 1e-12."""
    for mod in (jlu, tlu):
        monkeypatch.setattr(mod, "_SLAB_INNER", 16)
    a = np.random.default_rng(46).integers(-2, 3, (96, 96)).astype(
        np.float64)
    JF, JP = jlu.LU(El.DistMatrix.from_global(a, grid=one_device),
                    blocksize=32)
    F, P = Et.LU(_t(a), blocksize=32)
    np.testing.assert_array_equal(P.perm.numpy(), _perm(JP, 96))
    assert _rel(F.global_array(), JF.global_array()) < 1e-12


def test_lu_bf16_storage_three_slabs():
    """bfloat16 storage at n=96, nb=32 (two trailing updates on the rows
    not yet elected, in bf16): test_lu_bf16_storage's tolerance holds."""
    a = np.random.default_rng(41).standard_normal((96, 96)).astype(np.float32)
    tlu.LU.update_rows = 0
    F, P = Et.LU(Et.DistMatrix.from_global(torch.tensor(a).bfloat16(),
                                           grid=CPU), blocksize=32)
    assert F.dtype == torch.bfloat16 and tlu.LU.update_rows == 96
    ell, u = _split_lu(F.global_array().astype(np.float64), 96)
    ab = torch.tensor(a).bfloat16().double().numpy()
    assert np.abs(ab[P.perm.numpy()] - ell @ u).max() / np.abs(a).max() < 5e-2


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def test_linear_solve_step_vs_reference(one_device):
    """n=64 float64: LinearSolve, the residual Gemm and Nrm2 against the
    same three calls of the JAX package. X within 1e-10; both residual
    norms at the float64 rounding level of ||B||."""
    rng = np.random.default_rng(44)
    a = rng.standard_normal((64, 64))
    b = rng.standard_normal((64, 4))
    JA = El.DistMatrix.from_global(a, grid=one_device)
    JB = El.DistMatrix.from_global(b, grid=one_device)
    JX = El.LinearSolve(JA, JB)
    jnrm = El.Nrm2(El.Gemm(J.NORMAL, J.NORMAL, -1.0, JA, JX, beta=1.0, C=JB))
    x, nrm = linear_solve_step(torch.tensor(a), torch.tensor(b), grid=CPU)
    assert _rel(x.numpy(), JX.global_array()) < 1e-10
    bound = 1e4 * np.finfo(np.float64).eps * np.linalg.norm(b)
    assert float(nrm) < bound and float(jnrm) < bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_make_lu_problem_and_backward_error(dtype):
    """make_lu_problem draws a standard normal A and B from a seeded
    generator; the step's scaled backward error meets the bound of 100."""
    a, b = make_lu_problem(120, 5, dtype=dtype, device="cpu", seed=7)
    a2, b2 = make_lu_problem(120, 5, dtype=dtype, device="cpu", seed=7)
    assert a.shape == (120, 120) and b.shape == (120, 5) and a.dtype == dtype
    assert torch.equal(a, a2) and torch.equal(b, b2)
    x, nrm = linear_solve_step(a, b)
    ad, xd, bd = a.double(), x.double(), b.double()
    eps = torch.finfo(dtype).eps
    berr = ((bd - ad @ xd).abs().sum(1).max()
            / (eps * 120 * ad.abs().sum(1).max() * xd.abs().sum(1).max()))
    assert float(berr) < 100
    assert float(nrm) == pytest.approx(float(torch.linalg.norm(b - a @ x)),
                                       rel=1e-3, abs=1e-12)
