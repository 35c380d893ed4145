"""Port parity: the kernels K1 (local GEMM), K3a (Cholesky diagonal
block) and K4 (pivoted LU panel).

On the CPU each wrapper takes its plain PyTorch version; those are held
against the JAX package's Pallas kernels run in interpret mode, as the JAX
package's own kernel tests run them. The tests marked ``cuda`` compare the
CUDA kernels with their plain versions on the card and skip without one.
They import no JAX, so on a machine with a card and no JAX they run as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from elementalx_torch.kernels import common
from elementalx_torch.kernels.getrf import (
    getrf_panel,
    getrf_panel_plain,
    lu_plain,
    packed_getrf,
)
from elementalx_torch.kernels.matmul import matmul, matmul_plain
from elementalx_torch.kernels.potrf import (
    padded_order,
    potrf_block_inv,
    potrf_block_inv_plain,
)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers at once: keep torch to one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _spd(rng, w, dtype=np.float32):
    g = rng.standard_normal((w, w))
    return (g @ g.T / w + 2 * np.eye(w)).astype(dtype)


def _rel(x, ref):
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


# ---------------------------------------------------------------------------
# K1 on the CPU: the plain version against the JAX kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_vs_pallas_interpret(dtype):
    """Tolerance: both accumulate in float32 over K=128 (JAX at HIGHEST,
    which is full f32 on the CPU); 1e-5 relative covers the summation
    order. bf16 outputs may land on neighbouring bf16 values: 1e-2."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from elementalx.kernels.matmul import matmul_pallas

    rng = np.random.default_rng(10)
    a = rng.standard_normal((256, 128)).astype(np.float32)
    b = rng.standard_normal((128, 256)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = matmul_pallas(jnp.asarray(a, jdt), jnp.asarray(b, jdt),
                            bm=128, bn=128, bk=64)
    out = matmul(torch.tensor(a).to(tdt), torch.tensor(b).to(tdt))
    assert out.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert _rel(out.float().numpy(), np.asarray(ref, np.float32)) < tol


@pytest.mark.parametrize("shape", [(7, 5, 3), (33, 1, 65), (64, 48, 1)])
@pytest.mark.parametrize("transposed", [False, True])
def test_matmul_ragged_strided_vs_reference_dispatcher(shape, transposed):
    """Ragged shapes and transposed views, which matmul_pallas refuses,
    against the JAX dispatcher's XLA branch, in float64 (1e-12)."""
    import jax.numpy as jnp
    from elementalx.kernels.matmul import matmul as jmatmul

    M, K, N = shape
    rng = np.random.default_rng(11)
    a = rng.standard_normal((M, K))
    b = rng.standard_normal((K, N))
    ta, tb = torch.tensor(a), torch.tensor(b)
    if transposed:
        ta, tb = torch.tensor(a.T.copy()).mT, torch.tensor(b.T.copy()).mT
    ref = np.asarray(jmatmul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(matmul(ta, tb).numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_matmul_bf16_to_f32_output():
    """out_dtype=float32 keeps the f32 accumulator (the JAX drivers'
    preferred_element_type): exact products of bf16 values summed in f32."""
    rng = np.random.default_rng(12)
    a = torch.tensor(rng.standard_normal((20, 30))).to(torch.bfloat16)
    b = torch.tensor(rng.standard_normal((30, 10))).to(torch.bfloat16)
    out = matmul(a, b, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    ref = a.double() @ b.double()
    assert (out.double() - ref).abs().max() < 1e-5 * ref.abs().max()


def test_cpu_tensors_take_plain_version_and_count_nothing():
    before = (matmul.launches, potrf_block_inv.launches)
    a = torch.eye(4)
    torch.testing.assert_close(matmul(a, a), matmul_plain(a, a))
    potrf_block_inv(a)
    assert (matmul.launches, potrf_block_inv.launches) == before


def test_on_cuda_refuses_mixed_devices():
    assert common.on_cuda(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        common.on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))


# ---------------------------------------------------------------------------
# K3a on the CPU: the plain version against the JAX kernel
# ---------------------------------------------------------------------------


def test_potrf_plain_vs_pallas_interpret():
    """w=128 f32 (the TPU kernel needs w % 128 == 0). Tolerance 1e-5
    relative: both factor a block of condition number below 3 in f32."""
    import jax.numpy as jnp
    from elementalx.kernels.potrf import potrf_block_inv as jpotrf

    rng = np.random.default_rng(13)
    s = _spd(rng, 128)
    jl, jinv = (np.asarray(x) for x in jpotrf(jnp.asarray(s), interpret=True))
    tl, tinv = potrf_block_inv(torch.tensor(s))
    assert _rel(tl.numpy(), jl) < 1e-5
    assert _rel(tinv.numpy(), jinv) < 1e-5
    assert np.abs(np.triu(tl.numpy(), 1)).max() == 0.0
    assert np.abs(np.tril(tinv.numpy(), -1)).max() == 0.0


def test_potrf_non_hpd_poisons_like_pallas():
    """A block that is not positive definite poisons invLH with NaN in the
    JAX kernel; the port poisons both outputs, entirely."""
    import jax.numpy as jnp
    from elementalx.kernels.potrf import potrf_block_inv as jpotrf

    s = -_spd(np.random.default_rng(14), 128)
    _, jinv = (np.asarray(x) for x in jpotrf(jnp.asarray(s), interpret=True))
    tl, tinv = potrf_block_inv(torch.tensor(s))
    assert np.isnan(jinv).any()
    assert bool(tl.isnan().all()) and bool(tinv.isnan().all())


@pytest.mark.parametrize("w", [1, 5, 64, 130])
def test_potrf_plain_f64_contract(w):
    """Any order, float64: l11 l11^T = S and l11 invLH^T = I to 1e-12."""
    s = _spd(np.random.default_rng(15), w, np.float64)
    l11, inv_lh = potrf_block_inv(torch.tensor(s))
    l, i = l11.numpy(), inv_lh.numpy()
    assert np.abs(l @ l.T - s).max() < 1e-12 * np.abs(s).max()
    assert np.abs(l @ i.T - np.eye(w)).max() < 1e-12


def test_padded_order():
    assert [padded_order(w) for w in (1, 32, 33, 200, 512, 1056, 2048)] == \
        [32, 32, 64, 256, 512, 2048, 2048]


# ---------------------------------------------------------------------------
# K4 on the CPU: the plain version against the JAX kernel and jax's LU
# ---------------------------------------------------------------------------


def _check_marked_contract(a, out, piv):
    """(error, max|L|) of getrf_panel's contract: the w elected rows are
    distinct, and gathering them first and the rest after them (the
    marked layout read as LAPACK packed) gives P A = L U."""
    Mt, w = a.shape
    out = np.asarray(out, np.float64)
    piv = np.asarray(piv)
    assert len(set(piv.tolist())) == w
    lperm = np.concatenate([piv, np.setdiff1d(np.arange(Mt), piv)])
    packed = out[lperm]
    L = np.tril(packed, -1)[:, :w] + np.eye(Mt, w)
    U = np.triu(packed[:w, :])
    a = np.asarray(a, np.float64)
    err = np.abs(a[lperm] - L @ U).max() / max(np.abs(a).max(), 1.0)
    return err, np.abs(L).max()


def test_getrf_plain_vs_pallas_interpret():
    """(384, 256) f32, as the JAX package's own kernel test runs it:
    both contracts (rows in place with piv; LAPACK packed with lperm).
    Pivots are identical on this input; the factors agree to 1e-4 of
    max|A| (float32 eliminations in another order over 256 columns)."""
    import jax
    import jax.numpy as jnp
    from elementalx.kernels.getrf import getrf_panel as jgetrf
    from elementalx.kernels.getrf import pallas_getrf

    rng = np.random.default_rng(20)
    a = rng.standard_normal((384, 256)).astype(np.float32)
    jout, jpiv = (np.asarray(x) for x in jax.jit(
        lambda x: jgetrf(x, interpret=True))(jnp.asarray(a)))
    jpk, jlp = (np.asarray(x) for x in jax.jit(
        lambda x: pallas_getrf(x, interpret=True))(jnp.asarray(a)))
    out, piv = getrf_panel(torch.tensor(a))
    pk, lp = packed_getrf(torch.tensor(a))
    assert out.dtype == torch.float32 and piv.dtype == torch.int64
    np.testing.assert_array_equal(piv.numpy(), jpiv)
    np.testing.assert_array_equal(lp.numpy(), jlp)
    scale = np.abs(a).max()
    assert np.abs(out.numpy() - jout).max() < 1e-4 * scale
    assert np.abs(pk.numpy() - jpk).max() < 1e-4 * scale
    err, lmax = _check_marked_contract(a, out.numpy(), piv.numpy())
    assert err < 1e-5 and lmax <= 1 + 1e-6


def test_lu_plain_vs_jax_lu_f64():
    """(300, 200) f64: the plain version against jax.lax.linalg.lu, the
    JAX package's CPU route: identical lperm, packed factor within
    1e-12."""
    import jax

    rng = np.random.default_rng(21)
    a = rng.standard_normal((300, 200))
    jlu, _, jperm = (np.asarray(x) for x in jax.lax.linalg.lu(a))
    pk, lp = lu_plain(torch.tensor(a))
    np.testing.assert_array_equal(lp.numpy(), jperm)
    assert np.abs(pk.numpy() - jlu).max() < 1e-12 * np.abs(jlu).max()
    out, piv = getrf_panel_plain(torch.tensor(a))
    np.testing.assert_array_equal(piv.numpy(), jperm[:200])
    np.testing.assert_array_equal(out.numpy()[jperm], pk.numpy())


@pytest.mark.parametrize("shape", [(1000, 200), (33, 33), (70, 3), (5, 1)])
def test_getrf_plain_marked_contract(shape):
    """Ragged shapes, float64: the marked-row contract and P A = L U to
    1e-13 of max|A|; packed_getrf lists the unelected rows ascending."""
    a = np.random.default_rng(22).standard_normal(shape)
    out, piv = getrf_panel(torch.tensor(a))
    err, lmax = _check_marked_contract(a, out.numpy(), piv.numpy())
    assert err < 1e-13 and lmax <= 1 + 1e-12
    pk, lp = packed_getrf(torch.tensor(a))
    rest = lp.numpy()[shape[1]:]
    assert np.all(np.diff(rest) > 0)
    np.testing.assert_array_equal(lp.numpy()[: shape[1]], piv.numpy())


def test_getrf_plain_zero_pivot_divides_by_one():
    """A singular panel (a zero column after elimination) factors without
    NaN or error, as the JAX kernel's ``safe`` pivot does."""
    a = np.zeros((6, 3))
    a[:, 0] = [1, 2, 3, 4, 5, 6]
    a[:, 2] = [1, 0, 2, 0, 3, 0]
    a[:, 1] = 2 * a[:, 0]  # column 1 is eliminated to exact zeros
    out, piv = getrf_panel(torch.tensor(a))
    assert bool(torch.isfinite(out).all())
    err, _ = _check_marked_contract(a, out.numpy(), piv.numpy())
    assert err < 1e-14


def test_getrf_plain_complex_on_cpu():
    rng = np.random.default_rng(23)
    a = rng.standard_normal((40, 16)) + 1j * rng.standard_normal((40, 16))
    pk, lp = packed_getrf(torch.tensor(a))
    pkc = pk.numpy()
    L = np.tril(pkc, -1)[:, :16] + np.eye(40, 16)
    U = np.triu(pkc[:16])
    assert np.abs(a[lp.numpy()] - L @ U).max() < 1e-13 * np.abs(a).max()


def test_getrf_cpu_tensors_count_nothing():
    before = getrf_panel.launches
    getrf_panel(torch.eye(4))
    packed_getrf(torch.eye(4))
    assert getrf_panel.launches == before


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (M, K, N, dtype, out_dtype, transposed A, transposed B, rtol)
    (1000, 777, 1001, torch.float32, None, True, False, 1e-5),
    (129, 65, 257, torch.float32, None, False, True, 1e-5),
    (300, 50, 70, torch.float64, None, True, True, 1e-12),
    (257, 129, 65, torch.bfloat16, None, False, False, 1e-2),
    (257, 129, 65, torch.bfloat16, torch.float32, False, False, 1e-5),
    (64, 0, 16, torch.float32, None, False, False, 0.0),
])
def test_matmul_kernel_vs_plain(cuda, case):
    """Tolerances: FP32 sums in another order 1e-5 of max|C|; float64
    1e-12; bf16 outputs one bf16 step (1e-2)."""
    M, K, N, dt, out_dt, ta, tb, rtol = case
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((K, M) if ta else (M, K), generator=g, device=cuda)
    b = torch.randn((N, K) if tb else (K, N), generator=g, device=cuda)
    a, b = a.to(dt), b.to(dt)
    a, b = (a.mT if ta else a), (b.mT if tb else b)
    before = matmul.launches
    out = matmul(a, b, out_dtype=out_dt)
    ref = matmul_plain(a, b, out_dtype=out_dt)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    assert out.dtype == ref.dtype
    err = (out.double() - ref.double()).abs().max().item()
    assert err <= rtol * max(ref.double().abs().max().item(), 1.0)


@pytest.mark.cuda
def test_matmul_kernel_refuses_complex(cuda):
    a = torch.ones((4, 4), dtype=torch.complex64, device=cuda)
    with pytest.raises(NotImplementedError):
        matmul(a, a)


@pytest.mark.cuda
@pytest.mark.parametrize("w,dt", [(1, torch.float32), (33, torch.float64),
                                  (200, torch.float32), (512, torch.float32),
                                  (300, torch.float64)])
def test_potrf_kernel_vs_plain(cuda, w, dt):
    """Tolerance: 1e-5 (float32) / 1e-12 (float64) of the largest entry;
    the blocks have condition number below 3."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((w, w), generator=g, device=cuda, dtype=torch.float64)
    s = (x @ x.mT / w + 2 * torch.eye(w, device=cuda,
                                      dtype=torch.float64)).to(dt)
    before = potrf_block_inv.launches
    l11, inv_lh = potrf_block_inv(s)
    l_ref, inv_ref = potrf_block_inv_plain(s)
    torch.cuda.synchronize()
    assert potrf_block_inv.launches == before + 1
    rtol = 1e-5 if dt == torch.float32 else 1e-12
    for out, ref in ((l11, l_ref), (inv_lh, inv_ref)):
        assert (out - ref).abs().max().item() <= rtol * ref.abs().max().item()
    assert l11.triu(1).abs().max().item() == 0.0
    assert inv_lh.tril(-1).abs().max().item() == 0.0
    bad_l, bad_inv = potrf_block_inv(-s)
    assert bool(bad_l.isnan().all()) and bool(bad_inv.isnan().all())


@pytest.mark.cuda
def test_potrf_kernel_refuses_complex(cuda):
    s = torch.eye(4, dtype=torch.complex64, device=cuda)
    with pytest.raises(NotImplementedError):
        potrf_block_inv(s)


@pytest.mark.cuda
@pytest.mark.parametrize("dt,rtol", [(torch.float64, 1e-10),
                                     (torch.float32, 1e-4),
                                     (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("upper", [False, True], ids=["lo", "up"])
def test_cholesky_solve_on_card_matches_cpu(cuda, dt, rtol, upper):
    """The driver on the card (K1 and K3a on every panel, n=300 with
    nb=64: four full panels and a ragged one) against the same driver on
    the CPU (plain versions). Tolerances: float64 rounding; float32 sums
    in other orders on a matrix of condition number below 3; bf16 storage
    rounds each factor entry to 8 bits, and a flip carries into later
    panels."""
    import elementalx_torch as Et

    n = 300
    g = torch.Generator().manual_seed(5)
    x = torch.randn((n, n), generator=g, dtype=torch.float64)
    a = (x @ x.mT / n + 2 * torch.eye(n, dtype=torch.float64)).to(dt)
    b = torch.randn((n, 7), generator=g, dtype=torch.float64).to(dt)
    uplo = Et.UPPER if upper else Et.LOWER
    outs = []
    for dev in ("cpu", cuda):
        grid = Et.Grid(dev)
        A = Et.DistMatrix.from_global(a, grid=grid)
        B = Et.DistMatrix.from_global(b, grid=grid)
        before = (matmul.launches, potrf_block_inv.launches)
        L = Et.Cholesky(uplo, A, blocksize=64)
        X = Et.SolveAfter(uplo, Et.NORMAL, L, B)
        after = (matmul.launches, potrf_block_inv.launches)
        if dev != "cpu":
            assert after[1] - before[1] == 5 and after[0] > before[0]
        outs.append((L.data.double().cpu(), X.data.double().cpu()))
    for cpu_t, card_t in zip(*outs):
        assert (card_t - cpu_t).abs().max() <= rtol * cpu_t.abs().max()


@pytest.mark.cuda
def test_non_hpd_on_card_raises(cuda):
    import elementalx_torch as Et

    a = torch.eye(100, device=cuda)
    a[90, 90] = -1.0
    with pytest.raises(Et.NonHPDMatrixException):
        Et.Cholesky(Et.LOWER, Et.DistMatrix.from_global(a, grid=Et.Grid(cuda)),
                    blocksize=32)


@pytest.mark.cuda
@pytest.mark.parametrize("Mt,w,dt", [
    (1000, 200, torch.float32), (4096, 512, torch.float64),
    (16384, 512, torch.float32), (33, 33, torch.float64),
    (70, 3, torch.float64), (512, 512, torch.float32),
    # more rows than threads per CTA; a row share too big for shared memory
    (40000, 64, torch.float32), (120000, 32, torch.float64),
])
def test_getrf_kernel_vs_plain(cuda, Mt, w, dt):
    """K4 against torch.linalg.lu_factor on the card. Checked in float64:
    lperm a permutation, max|P A - L U| <= tol max|A| (float32: 1e-5,
    about 100 eps for rows of 512 Gaussian entries; float64: 1e-13) and
    |L| <= 1 + tol. float64 pivots are identical to the plain version's;
    float32 ones may differ on near-ties and are not compared."""
    g = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn((Mt, w), generator=g, device=cuda,
                    dtype=torch.float64).to(dt)
    before = getrf_panel.launches
    out, piv = getrf_panel(a)
    pk, lp = packed_getrf(a)
    torch.cuda.synchronize()
    assert getrf_panel.launches == before + 2
    tol = 1e-5 if dt == torch.float32 else 1e-13
    err, lmax = _check_marked_contract(a.cpu().numpy(), out.cpu().numpy(),
                                       piv.cpu().numpy())
    assert err <= tol and lmax <= 1 + tol
    assert sorted(lp.cpu().tolist()) == list(range(Mt))
    np.testing.assert_array_equal(lp[:w].cpu().numpy(), piv.cpu().numpy())
    if dt == torch.float64:
        _, ref_piv = getrf_panel_plain(a)
        assert torch.equal(piv, ref_piv)


@pytest.mark.cuda
def test_getrf_kernel_zero_pivot(cuda):
    """A zero column divides by 1 on the card too: no NaN, P A = L U."""
    a = torch.zeros((300, 40), dtype=torch.float64)
    a[:, 0] = torch.arange(1, 301, dtype=torch.float64)
    a[:, 5] = 3 * a[:, 0]
    a[:, 6:] = torch.randn((300, 34), dtype=torch.float64,
                           generator=torch.Generator().manual_seed(3))
    out, piv = getrf_panel(a.to(cuda))
    assert bool(torch.isfinite(out).all())
    err, _ = _check_marked_contract(a.numpy(), out.cpu().numpy(),
                                    piv.cpu().numpy())
    assert err < 1e-13


@pytest.mark.cuda
def test_getrf_kernel_refuses_complex(cuda):
    a = torch.ones((8, 4), dtype=torch.complex64, device=cuda)
    with pytest.raises(NotImplementedError):
        getrf_panel(a)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_linear_solve_on_card(cuda, dt):
    """LinearSolve at n=1024 on the card: K4 for every sub-panel (eight
    128-wide panels), K1 for the products; the scaled backward error
    ||B - A X||_inf / (eps n ||A||_inf ||X||_inf) below 100, and X within
    1e-10 (float64) of the same step on the CPU."""
    from elementalx_torch.entry import linear_solve_step, make_lu_problem
    from elementalx_torch.kernels.matmul import matmul

    n = 1024
    a, b = make_lu_problem(n, 8, dtype=dt, device=cuda, seed=4)
    k4, k1 = getrf_panel.launches, matmul.launches
    x, nrm = linear_solve_step(a, b)
    torch.cuda.synchronize()
    assert getrf_panel.launches - k4 == 8 and matmul.launches > k1
    ad, xd, bd = a.double(), x.double(), b.double()
    eps = torch.finfo(dt).eps
    berr = ((bd - ad @ xd).abs().sum(1).max()
            / (eps * n * ad.abs().sum(1).max() * xd.abs().sum(1).max()))
    assert float(berr) < 100
    if dt == torch.float64:
        x_cpu, _ = linear_solve_step(a.cpu(), b.cpu())
        assert (x.cpu() - x_cpu).abs().max() <= 1e-10 * x_cpu.abs().max()
