"""Port parity: the distributed GEMM algorithms, the ring SUMMA (K8) and
``dist_gemm_step``.

Mirrors tests/blas/test_gemm.py and the ring case of
tests/kernels/test_kernels.py on the port's virtual grids (every position
on the CPU, where K1 and K8 take their plain versions), held against the
JAX package on its 8-device CPU mesh with the same numpy inputs.
Tolerances: 1e-5 relative in float32 (FP32 sums in another order and
another split), 1e-12 in float64.
"""

import numpy as np
import pytest
import torch

import elementalx as El
import elementalx_torch as Et
from elementalx.blas import gemm as jgemm
from elementalx_torch.blas import gemm as tgemm
from elementalx_torch.core import types as T
from elementalx_torch.entry import dist_gemm_step, make_dist_problem
from elementalx_torch.kernels import ring_summa as tring

ALGS = ["GEMM_SUMMA_A", "GEMM_SUMMA_B", "GEMM_SUMMA_C", "GEMM_SUMMA_DOT"]
TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers at once: keep torch to one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tgrid():
    return Et.Grid(["cpu"] * 8, height=4)


@pytest.fixture(scope="module")
def tsquare():
    return Et.Grid(["cpu"] * 4, height=2)


def _rel(x, y):
    x, y = np.asarray(x, np.complex128), np.asarray(y, np.complex128)
    return np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-300)


def _both(jgrid, tgrid, *arrays):
    return ([El.DistMatrix.from_global(a, grid=jgrid) for a in arrays],
            [Et.DistMatrix.from_global(a, grid=tgrid) for a in arrays])


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("alg", ALGS + ["GEMM_CANNON"])
def test_gemm_alg_vs_jax(grid, square_grid, tgrid, tsquare, alg, dtype):
    """Reference: tests/blas/test_gemm.py:34-45, each algorithm against
    the JAX Gemm with the same alg on a grid of the same shape (Cannon on
    the square grid)."""
    rng = np.random.default_rng(40)
    m, k, n = 35, 27, 22
    a, b, c = (rng.standard_normal(s).astype(dtype)
               for s in ((m, k), (k, n), (m, n)))
    jg, tg = (square_grid, tsquare) if alg == "GEMM_CANNON" else (grid, tgrid)
    (JA, JB, JC), (TA, TB, TC) = _both(jg, tg, a, b, c)
    ref = El.Gemm(El.NORMAL, El.NORMAL, 2.0, JA, JB, beta=0.5, C=JC,
                  alg=getattr(El.core.types, alg))
    out = Et.Gemm(T.NORMAL, T.NORMAL, 2.0, TA, TB, beta=0.5, C=TC,
                  alg=getattr(T, alg))
    assert out.sharded and out.dist == (T.MC, T.MR)
    assert out.dtype == getattr(torch, np.dtype(dtype).name)
    assert _rel(out.global_array(), ref.global_array()) < TOL[dtype]
    assert _rel(out.global_array(), 2 * a.astype(np.float64) @ b
                + 0.5 * c) < TOL[dtype]


@pytest.mark.parametrize("oa", ["NORMAL", "TRANSPOSE", "ADJOINT"],
                         ids="N T A".split())
@pytest.mark.parametrize("ob", ["NORMAL", "TRANSPOSE", "ADJOINT"],
                         ids="N T A".split())
def test_gemm_orientations(grid, tgrid, oa, ob):
    """Reference: tests/blas/test_gemm.py:48-66 (complex128)."""
    rng = np.random.default_rng(41)
    m, k, n = 18, 14, 10
    a = rng.standard_normal((m, k)) + 1j * rng.standard_normal((m, k))
    b = rng.standard_normal((k, n)) + 1j * rng.standard_normal((k, n))
    sa = {"NORMAL": a, "TRANSPOSE": a.T, "ADJOINT": a.conj().T}[oa]
    sb = {"NORMAL": b, "TRANSPOSE": b.T, "ADJOINT": b.conj().T}[ob]
    (JA, JB), (TA, TB) = _both(grid, tgrid, sa, sb)
    ref = El.Gemm(getattr(El, oa), getattr(El, ob), 1.0, JA, JB)
    out = Et.Gemm(getattr(T, oa), getattr(T, ob), 1.0, TA, TB)
    assert _rel(out.global_array(), a @ b) < 1e-12
    assert _rel(out.global_array(), ref.global_array()) < 1e-12


@pytest.mark.parametrize("alg", ALGS + ["GEMM_CANNON"])
def test_gemm_associativity(tsquare, alg):
    """(alpha A B + beta C) X == alpha A (B X) + beta (C X) on the square
    grid (reference: tests/blas/test_gemm.py:69-88, Gemm.cpp
    TestAssociativity); the sum through Axpby, as Add has no distributed
    form yet."""
    rng = np.random.default_rng(42)
    m, k, n, nrhs = 24, 16, 20, 8
    A, B, C, X = (Et.DistMatrix.from_global(rng.standard_normal(s),
                                            grid=tsquare)
                  for s in ((m, k), (k, n), (m, n), (n, nrhs)))
    al = getattr(T, alg)
    alpha, beta = 3.0, -2.0
    ABC = Et.Gemm(T.NORMAL, T.NORMAL, alpha, A, B, beta=beta, C=C, alg=al)
    Y1 = Et.Gemm(T.NORMAL, T.NORMAL, 1.0, ABC, X)
    BX = Et.Gemm(T.NORMAL, T.NORMAL, 1.0, B, X, alg=al)
    ABX = Et.Gemm(T.NORMAL, T.NORMAL, alpha, A, BX, alg=al)
    CX = Et.Gemm(T.NORMAL, T.NORMAL, beta, C, X, alg=al)
    Y2 = Et.Axpby(1.0, ABX, 1.0, CX)
    assert _rel(Y1.global_array(), Y2.global_array()) < 1e-12


@pytest.mark.parametrize("alg, blocksize",
                         [(a, None) for a in ALGS + ["GEMM_DEFAULT"]]
                         + [("GEMM_SUMMA_C", 4)])
@pytest.mark.parametrize("height", [2, 3], ids=["2x3", "3x2"])
def test_gemm_alg_on_a_grid_whose_sides_do_not_divide(height, alg,
                                                      blocksize):
    """On a 2x3 or 3x2 grid (p = 6, which default_grid_height gives) K//c
    and K//r are 2t and 3t (K = 60, t = 10): SUMMA_C's panel must divide
    their gcd t (nb = 10, or 2 for a blocksize of 4), or it crosses B's
    (or A's) owner block. Held against numpy in float64: the JAX
    package's SUMMA_C takes min(K//c, K//r) there and its dynamic_slice
    clamps silently, so it is no reference on these grids."""
    rng = np.random.default_rng(46)
    m, k, n = 35, 60, 22
    a, b, c = (rng.standard_normal(s) for s in ((m, k), (k, n), (m, n)))
    g = Et.Grid(["cpu"] * 6, height=height)
    TA, TB, TC = (Et.DistMatrix.from_global(x, grid=g) for x in (a, b, c))
    out = Et.Gemm(T.NORMAL, T.NORMAL, 2.0, TA, TB, beta=0.5, C=TC,
                  alg=getattr(T, alg), blocksize=blocksize)
    assert out.sharded and out.dist == (T.MC, T.MR)
    assert _rel(out.global_array(), 2 * a @ b + 0.5 * c) < 1e-12


def test_gemm_summa_c_blocked(grid, tgrid):
    """Reference: tests/blas/test_gemm.py:106-114: a small blocksize runs
    the k-loop (nb = 8 divides K/c and K/r); and nb = 5 falls to 4."""
    rng = np.random.default_rng(43)
    a, b = rng.standard_normal((16, 64)), rng.standard_normal((64, 16))
    (JA, JB), (TA, TB) = _both(grid, tgrid, a, b)
    for nb in (8, 5):
        ref = El.Gemm(El.NORMAL, El.NORMAL, 1.0, JA, JB,
                      alg=El.core.types.GEMM_SUMMA_C, blocksize=nb)
        before = Et.kernels.matmul.launches
        out = Et.Gemm(T.NORMAL, T.NORMAL, 1.0, TA, TB, alg=T.GEMM_SUMMA_C,
                      blocksize=nb)
        assert Et.kernels.matmul.launches == before   # CPU: plain version
        assert _rel(out.global_array(), ref.global_array()) < 1e-12
        assert _rel(out.global_array(), a @ b) < 1e-12


def test_gemm_3d(grid, tgrid, tsquare):
    """Reference: tests/blas/test_gemm.py:117-127, on the 4x2 grid (an
    (2, 2, 2) mesh) and the 2x2 one ((1, 2, 2)), against the JAX Gemm3D;
    alpha scales per position."""
    rng = np.random.default_rng(44)
    a, b = rng.standard_normal((16, 24)), rng.standard_normal((24, 16))
    (JA, JB), (TA, TB) = _both(grid, tgrid, a, b)
    ref = jgemm.Gemm3D(JA, JB, depth=2)
    out = Et.Gemm3D(TA, TB, depth=2)
    assert _rel(out.global_array(), ref.global_array()) < 1e-12
    assert _rel(Et.Gemm3D(TA, TB, depth=4, alpha=-2.0).global_array(),
                -2.0 * (a @ b)) < 1e-12
    SA = Et.DistMatrix.from_global(a, grid=tsquare)
    SB = Et.DistMatrix.from_global(b, grid=tsquare)
    assert _rel(Et.Gemm3D(SA, SB, depth=2).global_array(), a @ b) < 1e-12
    with pytest.raises(ValueError):
        Et.Gemm3D(TA, TB, depth=3)
    assert tgemm._mesh3(8, 2) == (2, 2) and tgemm._mesh3(4, 2) == (1, 2)


def test_gemm_default_aspect_heuristic(grid, tgrid):
    """Reference: tests/blas/test_gemm.py:130-163. The rule matches the
    JAX package's after use_explicit_summa(True); on a grid of several
    positions the port always takes it (it has no GSPMD path), and a
    1 x 1 grid takes the one local product."""
    p = tgrid.size
    jgemm.use_explicit_summa(True)
    try:
        for mkn in ((8, 8, 1024), (8, 1024, 32), (1024, 8, 32),
                    (256, 256, 256)):
            m, n, k = mkn
            assert tgemm._choose_algorithm(m, n, k, p).name == \
                jgemm._choose_algorithm(m, n, k, p).name
    finally:
        jgemm.use_explicit_summa(False)
    Et.use_explicit_summa(True)
    assert tgemm._choose_algorithm(8, 8, 1024, p) == T.GEMM_SUMMA_DOT
    with pytest.raises(ValueError, match="partitioner"):
        Et.use_explicit_summa(False)
    assert tgemm._choose_algorithm(8, 8, 1024, 1) == T.GEMM_XLA
    rng = np.random.default_rng(45)
    for m, k, n in ((8, 64, 8), (8, 24, 64), (64, 24, 8), (24, 24, 24)):
        a, b = rng.standard_normal((m, k)), rng.standard_normal((k, n))
        TA, TB = (Et.DistMatrix.from_global(x, grid=tgrid) for x in (a, b))
        out = Et.Gemm(T.NORMAL, T.NORMAL, 1.0, TA, TB, alg=T.GEMM_DEFAULT)
        assert _rel(out.global_array(), a @ b) < 1e-12


def test_gemm_xla_and_cannon_refusals(tgrid):
    """GEMM_XLA needs XLA's partitioner (ValueError on a grid of several
    positions); Cannon needs a square grid."""
    A = Et.DistMatrix.from_global(np.eye(8), grid=tgrid)
    with pytest.raises(ValueError, match="GEMM_XLA"):
        Et.Gemm(T.NORMAL, T.NORMAL, 1.0, A, A, alg=T.GEMM_XLA)
    with pytest.raises(ValueError, match="square grid"):
        Et.Gemm(T.NORMAL, T.NORMAL, 1.0, A, A, alg=T.GEMM_CANNON)
    with pytest.raises(ValueError, match="inner dims"):
        Et.Gemm(T.NORMAL, T.NORMAL, 1.0, A,
                Et.DistMatrix.from_global(np.eye(5), grid=tgrid))


def test_gemm_result_in_the_type_and_dist_of_c(tgrid):
    """beta = 0 with a C: the product in C's type and distribution."""
    rng = np.random.default_rng(46)
    a, b = rng.standard_normal((9, 7)), rng.standard_normal((7, 5))
    A, B = (Et.DistMatrix.from_global(x, grid=tgrid) for x in (a, b))
    C = Et.DistMatrix.from_global(np.zeros((9, 5), np.float32), T.VC, T.STAR,
                                  grid=tgrid)
    out = Et.Gemm(T.NORMAL, T.NORMAL, -1.0, A, B, beta=0, C=C)
    assert out.dist == (T.VC, T.STAR) and out.dtype == torch.float32
    assert _rel(out.global_array(), -(a @ b)) < 1e-6


# ---------------------------------------------------------------------------
# K8: the ring SUMMA
# ---------------------------------------------------------------------------


def test_ring_summa_vs_pallas_interpret(grid, tgrid):
    """Reference: tests/kernels/test_kernels.py:89-102, the JAX kernel in
    the Pallas interpreter over the 8-device mesh; 1e-5 relative."""
    from elementalx.kernels.ring_summa import ring_summa as jring

    rng = np.random.default_rng(47)
    m, k, n = 32, 24, 16
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    (JA, JB), (TA, TB) = _both(grid, tgrid, a, b)
    ref = jring(JA, JB, interpret=True).global_array()
    before = tring.ring_summa_kernel.launches
    out = Et.ring_summa(TA, TB)
    assert tring.ring_summa_kernel.launches == before   # CPU: plain version
    assert out.sharded and out.dist == (T.MC, T.MR)
    assert out.dtype == torch.float32
    assert _rel(out.global_array(), ref) < 1e-5
    assert _rel(out.global_array(), a.astype(np.float64) @ b) < 1e-5


@pytest.mark.parametrize("shape", [(1000, 777, 101), (5, 3, 2)])
def test_ring_summa_ragged_f64(tsquare, shape):
    """Ragged sizes (padded to multiples of p) in float64, on the 2x2
    grid and a 1 x 1 one; the plain ring order against numpy (1e-12)."""
    m, k, n = shape
    rng = np.random.default_rng(48)
    a, b = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    for g in (tsquare, Et.Grid("cpu")):
        A, B = (Et.DistMatrix.from_global(x, grid=g) for x in (a, b))
        out = Et.ring_summa(A, B)
        assert out.shape == (m, n)
        out.check_valid()
        assert _rel(out.global_array(), a @ b) < 1e-12


def test_ring_summa_plain_walks_the_ring():
    """Rank my adds A_my[:, blk(h)] B_h for h = my, my-1, ...: with B's
    blocks the identity's, C_my is A_my itself, and the order shows in
    which holder block comes first (a bf16 sum rounded once)."""
    p, kb = 4, 3
    a = [torch.arange(12.0).view(1, 12) + 100 * r for r in range(p)]
    eye = torch.eye(p * kb)
    b = [eye[h * kb:(h + 1) * kb] for h in range(p)]
    out = tring.ring_summa_plain(a, b)
    for r in range(p):
        assert torch.equal(out[r], a[r])
    with pytest.raises(ValueError):
        tring.ring_summa_plain(a, b[:3])
    lo = [x.bfloat16() for x in a]
    assert tring.ring_summa_plain(lo, [x.bfloat16() for x in b])[0].dtype \
        == torch.bfloat16


# ---------------------------------------------------------------------------
# the slice: dist_gemm_step
# ---------------------------------------------------------------------------


def test_dist_gemm_step_vs_jax_chain(grid, tgrid):
    """The step against the JAX dry run's GEMM chain on the same inputs
    (``__graft_entry__.py:112-115``, ``:211``): R3 in float64 within
    1e-12, and Cr's norm within 1e-5 (the Pallas ring kernel accumulates
    in float32 whatever its inputs). x is not a's solution here, so R is
    not rounding noise and the chain is compared entry by entry."""
    from elementalx.kernels.ring_summa import ring_summa as jring

    rng = np.random.default_rng(49)
    n, nrhs = 24, 8
    g0 = rng.standard_normal((n, n))
    a = g0 @ g0.T / n + 2 * np.eye(n)
    b, x = rng.standard_normal((n, nrhs)), rng.standard_normal((n, nrhs))
    g = rng.standard_normal((n, n))
    (JA, JB, JX, JG), _ = _both(grid, tgrid, a, b, x, g)
    ct = El.core.types
    R = El.Gemm(El.NORMAL, El.NORMAL, -1.0, JA, JX, beta=1.0, C=JB,
                alg=ct.GEMM_SUMMA_A)
    R2 = El.Gemm(El.NORMAL, El.NORMAL, 1.0, JA, R, alg=ct.GEMM_SUMMA_B)
    R3 = El.Gemm(El.NORMAL, El.NORMAL, 1.0, JA, R2, alg=ct.GEMM_SUMMA_C)
    Cr = jring(JA, JG, interpret=True)
    nr3, ncr, blocks = dist_gemm_step(*(torch.tensor(t) for t in
                                        (a, b, x, g)), tgrid)
    assert len(blocks) == tgrid.size
    got = Et.DistMatrix(None, n, nrhs, T.MC, T.MR, tgrid,
                        blocks=tuple(blocks)).global_array()
    assert _rel(got, R3.global_array()) < 1e-12
    assert abs(nr3.item() - float(El.blas.Nrm2(R3))) <= 1e-12 * nr3.item()
    assert abs(ncr.item() - float(El.blas.Nrm2(Cr))) <= 1e-5 * ncr.item()
    assert abs(ncr.item() - np.linalg.norm(a @ g)) <= 1e-12 * ncr.item()


def test_dist_gemm_step_on_one_position_is_the_reference(tgrid, tsquare):
    """make_dist_problem on a CPU grid; the step on a 1 x 1 grid and on
    the 2x2 and 4x2 grids: x solves a x = b, so R3 is rounding noise of
    the same size on each, and A G agrees to float64 rounding."""
    a, b, x, g = make_dist_problem(40, tgrid, torch.float64, seed=3)
    assert a.shape == (40, 40) and b.shape == x.shape == (40, 8)
    assert a.device.type == "cpu"
    ref = dist_gemm_step(a, b, x, g, Et.Grid("cpu"))
    assert len(ref[2]) == 1
    for grid_ in (tsquare, tgrid):
        nr3, ncr, _ = dist_gemm_step(a, b, x, g, grid_)
        assert nr3.item() < 1e-12 * torch.linalg.norm(b).item()
        assert abs(ncr.item() - ref[1].item()) <= 1e-12 * ref[1].item()
