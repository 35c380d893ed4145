"""Port parity: Cholesky, SolveAfter, HPDSolve and the main-path entry.

Each input is made with numpy from a seed and given to the JAX package on
a one-device grid and to its PyTorch port on the CPU, where the port's
kernel wrappers take their plain versions. n=200 with nb=64 runs three
full panels and a ragged last one of width 8.
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
from elementalx_torch.entry import entry as tentry
from elementalx_torch.entry import hpd_solve_step


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


def _hpd(rng, n):
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def _both(grids, a):
    jg, tg = grids
    return (El.DistMatrix.from_global(a, grid=jg),
            Et.DistMatrix.from_global(a, grid=tg))


def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("uplo", [J.LOWER, J.UPPER], ids=["lo", "up"])
def test_cholesky_f64(grids, uplo):
    """float64: the same left-looking algorithm, products summed in other
    orders, 1e-12 relative."""
    a = _hpd(np.random.default_rng(30), 200)
    JA, TA = _both(grids, a)
    ref = El.Cholesky(uplo, JA, blocksize=64)
    out = Et.Cholesky(getattr(T, uplo.name), TA, blocksize=64)
    assert (out.m, out.n) == (ref.m, ref.n)
    assert _rel(out.global_array(), ref.global_array()) < 1e-12
    f = out.global_array()
    assert np.abs(np.triu(f, 1) if uplo == J.LOWER
                  else np.tril(f, -1)).max() == 0.0


@pytest.mark.parametrize("uplo", [J.LOWER, J.UPPER], ids=["lo", "up"])
def test_cholesky_f32(grids, uplo):
    """float32: the JAX package runs its panel products at bf16x3 and
    factors its blocks with XLA's Cholesky, the port in FP32 through K1
    and K3a's plain version; the factors agree to 1e-5 relative on a
    matrix of condition number about 6."""
    rng = np.random.default_rng(31)
    g = rng.standard_normal((200, 200))
    a = (g @ g.T / 200 + 2 * np.eye(200)).astype(np.float32)
    JA, TA = _both(grids, a)
    ref = El.Cholesky(uplo, JA, blocksize=64)
    out = Et.Cholesky(getattr(T, uplo.name), TA, blocksize=64)
    assert out.dtype == torch.float32
    assert _rel(out.global_array(), ref.global_array()) < 1e-5


def test_cholesky_bf16_storage(grids):
    """bfloat16 storage factors through f32 carriers. Both packages round
    the same f32 panels to bf16; a value near a rounding boundary can
    flip by one bf16 step (2^-8 of max|L| when it is the largest entry),
    and later panels carry it: 1e-2 of max|L|."""
    rng = np.random.default_rng(32)
    g = rng.standard_normal((160, 160))
    a = (g @ g.T / 160 + 2 * np.eye(160)).astype(np.float32)
    jg, tg = grids
    JA = El.DistMatrix.from_global(jnp.asarray(a, jnp.bfloat16), grid=jg)
    TA = Et.DistMatrix.from_global(torch.tensor(a).bfloat16(), grid=tg)
    ref = El.Cholesky(J.LOWER, JA, blocksize=64)
    out = Et.Cholesky(T.LOWER, TA, blocksize=64)
    assert out.dtype == torch.bfloat16
    assert _rel(out.global_array(), np.asarray(ref.global_array(),
                                               np.float32)) < 1e-2
    f = out.global_array().astype(np.float64)
    assert np.abs(f @ f.T - a).max() / np.abs(a).max() < 2e-2


def test_cholesky_default_blocksize_single_panel(grids):
    """Without a blocksize the n < 12288 knee gives nb=2048: one panel."""
    a = _hpd(np.random.default_rng(33), 90)
    JA, TA = _both(grids, a)
    ref = El.Cholesky(J.LOWER, JA)
    out = Et.Cholesky(T.LOWER, TA)
    assert _rel(out.global_array(), ref.global_array()) < 1e-12


@pytest.mark.parametrize("uplo", [J.LOWER, J.UPPER], ids=["lo", "up"])
def test_solve_after_and_hpd_solve(grids, uplo):
    """The reference's acceptance bound (Cholesky.cpp:41-45), and parity
    with the JAX package at 1e-10."""
    rng = np.random.default_rng(34)
    n, nrhs = 200, 9
    a = _hpd(rng, n)
    y = rng.standard_normal((n, nrhs))
    (JA, TA), (JY, TY) = _both(grids, a), _both(grids, y)
    tu = getattr(T, uplo.name)
    ref = El.HPDSolve(uplo, J.NORMAL, JA, JY, blocksize=64)
    out = Et.HPDSolve(tu, T.NORMAL, TA, TY, blocksize=64)
    x = out.global_array()
    assert _rel(x, ref.global_array()) < 1e-10
    eps = np.finfo(np.float64).eps
    assert np.max(np.abs(a @ x - y)) / (eps * n * np.max(np.abs(y))) < 100
    F = Et.Cholesky(tu, TA, blocksize=64)
    x2 = Et.SolveAfter(tu, T.NORMAL, F, TY).global_array()
    np.testing.assert_array_equal(x2, x)


@pytest.mark.parametrize("where", ["first", "last"])
def test_non_hpd_raises(grids, where):
    """A failure in the first panel or only in the ragged last one is
    reported, as the JAX package reports it."""
    from elementalx.core.environment import NonHPDMatrixException as JNonHPD

    a = _hpd(np.random.default_rng(35), 200)
    k = 0 if where == "first" else 196
    a[k, k] = -1e6
    JA, TA = _both(grids, a)
    with pytest.raises(JNonHPD):
        El.Cholesky(J.LOWER, JA, blocksize=64)
    with pytest.raises(Et.NonHPDMatrixException):
        Et.Cholesky(T.LOWER, TA, blocksize=64)


def test_cholesky_leaves_input_unchanged(grids):
    a = _hpd(np.random.default_rng(36), 70)
    _, TA = _both(grids, a)
    before = TA.data.clone()
    Et.Cholesky(T.UPPER, TA, blocksize=32)
    assert torch.equal(TA.data, before)


def test_entry_step_matches_reference():
    """The main-path step (HPDSolve, residual Gemm, Nrm2) on the JAX
    package's own entry problem (n=256, nrhs=16, float32). Tolerance: X
    to 1e-5 relative (f32, condition number about 4); both residual norms
    are at the f32 rounding level of ||B||."""
    import __graft_entry__ as graft

    jstep, (ja, jb) = graft.entry()
    jx, jnrm = jstep(ja, jb)
    a, b = np.asarray(ja), np.asarray(jb)
    tx, tnrm = hpd_solve_step(torch.tensor(a), torch.tensor(b),
                              grid=Et.Grid("cpu"))
    assert tx.dtype == torch.float32
    assert _rel(tx.numpy(), np.asarray(jx)) < 1e-5
    bnorm = np.linalg.norm(b)
    eps = np.finfo(np.float32).eps
    assert float(tnrm) < 100 * eps * bnorm
    assert float(jnrm) < 100 * eps * bnorm


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_entry_problem_and_residual(dtype):
    """entry() builds bench.py's g g^T/n + 2I problem from a seeded
    generator; the step's scaled residual meets the reference's bound."""
    step, (a, b) = tentry(n=150, nrhs=6, dtype=dtype, device="cpu", seed=3)
    assert a.shape == (150, 150) and b.shape == (150, 6)
    assert a.dtype == dtype
    step2, (a2, _) = tentry(n=150, nrhs=6, dtype=dtype, device="cpu", seed=3)
    assert torch.equal(a, a2)
    x, nrm = step(a, b)
    eps = torch.finfo(dtype).eps
    scaled = ((a.double() @ x.double() - b.double()).abs().max()
              / (eps * 150 * b.double().abs().max()))
    assert float(scaled) < 100
    assert float(nrm) == pytest.approx(
        float(torch.linalg.norm(b - a @ x)), rel=1e-3)


# ---------------------------------------------------------------------------
# the fused panel tail (ELX_PALLAS_POTRF=1): K3b's plain version here
# ---------------------------------------------------------------------------


@pytest.fixture
def fused(monkeypatch):
    """Set ELX_PALLAS_POTRF=1 and record the panel shapes K3b is given
    (the Cholesky factorization reads it at call time)."""
    from elementalx_torch.lapack import cholesky as tchol

    monkeypatch.setenv("ELX_PALLAS_POTRF", "1")
    shapes = []
    real = tchol.potrf_panel_tail

    def spy(sym, pan, low_apply=False):
        shapes.append((tuple(pan.shape), low_apply))
        return real(sym, pan, low_apply=low_apply)

    monkeypatch.setattr(tchol, "potrf_panel_tail", spy)

    def no_k3a(sym):
        raise AssertionError("the fused branch called K3a")

    monkeypatch.setattr(tchol, "potrf_block_inv", no_k3a)
    return shapes


@pytest.mark.parametrize("n", [192, 200], ids=["even", "ragged"])
def test_cholesky_fused_tail_f32(grids, fused, n):
    """float32 with the fused tail against the JAX Cholesky (whose CPU
    route never fuses): 1e-5 relative, as the default path. n=200 with
    nb=64 ends in a ragged panel of width 8."""
    rng = np.random.default_rng(37)
    g = rng.standard_normal((n, n))
    a = (g @ g.T / n + 2 * np.eye(n)).astype(np.float32)
    JA, TA = _both(grids, a)
    ref = El.Cholesky(J.LOWER, JA, blocksize=64)
    out = Et.Cholesky(T.LOWER, TA, blocksize=64)
    widths = [64] * (n // 64) + ([n % 64] if n % 64 else [])
    assert fused == [((n - 64 * k, w), False) for k, w in enumerate(widths)]
    assert _rel(out.global_array(), ref.global_array()) < 1e-5
    assert np.abs(np.triu(out.global_array(), 1)).max() == 0.0


def test_cholesky_fused_tail_bf16_storage(grids, fused):
    """bfloat16 storage takes the fused tail with low_apply (bf16 operands
    of the L21 product), as the JAX driver passes it: the tolerances of
    test_cholesky_bf16_storage."""
    rng = np.random.default_rng(32)
    g = rng.standard_normal((160, 160))
    a = (g @ g.T / 160 + 2 * np.eye(160)).astype(np.float32)
    jg, tg = grids
    JA = El.DistMatrix.from_global(jnp.asarray(a, jnp.bfloat16), grid=jg)
    TA = Et.DistMatrix.from_global(torch.tensor(a).bfloat16(), grid=tg)
    ref = El.Cholesky(J.LOWER, JA, blocksize=64)
    out = Et.Cholesky(T.LOWER, TA, blocksize=64)
    assert out.dtype == torch.bfloat16
    assert fused and all(low for _, low in fused)
    assert _rel(out.global_array(), np.asarray(ref.global_array(),
                                               np.float32)) < 1e-2
    f = out.global_array().astype(np.float64)
    assert np.abs(f @ f.T - a).max() / np.abs(a).max() < 2e-2


def test_cholesky_fused_tail_not_for_f64(grids, fused, monkeypatch):
    """float64 carriers keep the K3a path, as the JAX gate (f32 only)."""
    from elementalx_torch.kernels.potrf import potrf_block_inv
    from elementalx_torch.lapack import cholesky as tchol

    monkeypatch.setattr(tchol, "potrf_block_inv", potrf_block_inv)
    a = _hpd(np.random.default_rng(38), 100)
    JA, TA = _both(grids, a)
    out = Et.Cholesky(T.LOWER, TA, blocksize=32)
    assert fused == []
    assert _rel(out.global_array(),
                El.Cholesky(J.LOWER, JA, blocksize=32).global_array()) < 1e-12


@pytest.mark.parametrize("where", ["first", "last"])
def test_cholesky_fused_tail_non_hpd_raises(grids, fused, where):
    a = _hpd(np.random.default_rng(35), 200).astype(np.float32)
    k = 0 if where == "first" else 196
    a[k, k] = -1e6
    _, TA = _both(grids, a)
    with pytest.raises(Et.NonHPDMatrixException):
        Et.Cholesky(T.LOWER, TA, blocksize=64)


def test_hpd_solve_fused_tail_upper(grids, fused):
    """HPDSolve through the fused tail, UPPER storage, float32: the
    reference's acceptance bound and the JAX package's X to 1e-4."""
    rng = np.random.default_rng(39)
    n = 130
    g = rng.standard_normal((n, n))
    a = (g @ g.T / n + 2 * np.eye(n)).astype(np.float32)
    y = rng.standard_normal((n, 3)).astype(np.float32)
    (JA, TA), (JY, TY) = _both(grids, a), _both(grids, y)
    out = Et.HPDSolve(T.UPPER, T.NORMAL, TA, TY, blocksize=32)
    ref = El.HPDSolve(J.UPPER, J.NORMAL, JA, JY, blocksize=32)
    assert len(fused) == 5
    x = out.global_array().astype(np.float64)
    assert _rel(x, ref.global_array()) < 1e-4
    eps = np.finfo(np.float32).eps
    assert np.abs(a @ x - y).max() / (eps * n * np.abs(y).max()) < 100
