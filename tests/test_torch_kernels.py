"""Port parity: the kernels K1 (local GEMM), K3a (Cholesky diagonal
block), K4 (pivoted LU panel), K5 (latrd panel) and K6 (bulge chase).

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
from elementalx_torch.kernels.latrd import latrd_panel, latrd_panel_plain
from elementalx_torch.kernels.matmul import matmul, matmul_plain
from elementalx_torch.kernels.potrf import (
    padded_order,
    potrf_block_inv,
    potrf_block_inv_plain,
)
from elementalx_torch.kernels.sb2tr import sb2tr, sb2tr_plain


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
# K5 and K6 on the CPU: the plain versions against the JAX kernels
# ---------------------------------------------------------------------------


def _sym(rng, n, dtype=np.float32):
    a = rng.standard_normal((n, n))
    return ((a + a.T) / 2).astype(dtype)


def _band(rng, n, b, dtype=np.float64):
    a = _sym(rng, n, np.float64)
    i, j = np.indices((n, n))
    return np.where(np.abs(i - j) <= b, a, 0.0).astype(dtype)


@pytest.mark.parametrize("k0,w", [(0, 128), (64, 126)])
def test_latrd_plain_vs_pallas_interpret(k0, w):
    """M=256 f32 against the Pallas kernel in interpret mode (ts=128; it
    needs x64 off). Rows >= k0 (the JAX kernel leaves rows < k0 as junk):
    P, W and tau to 2e-4 of max|ref| (float32 symvs summed in other
    orders over 128 columns)."""
    import jax
    import jax.numpy as jnp
    from elementalx.kernels.latrd import latrd_panel as jlatrd

    a = _sym(np.random.default_rng(30), 256)
    with jax.enable_x64(False):
        ref = [np.asarray(x) for x in jlatrd(jnp.asarray(a), k0, w, nb=128,
                                             ts=128, interpret=True)]
    out = [x.numpy() for x in latrd_panel(torch.tensor(a), k0, w, 128)]
    for o, r in zip(out[:2], ref[:2]):
        assert np.abs(o[k0:, :w] - r[k0:, :w]).max() < 2e-4 * np.abs(
            r[k0:, :w]).max()
        assert np.all(o[:k0] == 0) and np.all(o[:, w:] == 0)
    assert np.abs(out[2][:w] - ref[2][:w]).max() < 2e-4 * np.abs(ref[2]).max()


def test_latrd_plain_vs_xla_panel_f64():
    """float64, ragged M=90, k0=7, w=20, against the JAX package's XLA
    panel (condense._tridiag_panel): 1e-12 of max|ref|."""
    import jax.numpy as jnp
    from elementalx.lapack.condense import _tridiag_panel

    M, k0, w = 90, 7, 20
    a = _sym(np.random.default_rng(31), M, np.float64)
    at, _, W, tau = (np.asarray(x) for x in _tridiag_panel(
        jnp.asarray(a), jnp.asarray(a[k0:, k0:]), jnp.zeros((M - k0, w)),
        jnp.zeros((M - k0, w)), jnp.zeros((M,)), k0, w, M - k0))
    P, Wo, t = (x.numpy() for x in latrd_panel(torch.tensor(a), k0, w, 32))
    assert P.shape == (M, 32) and t.shape == (32,)
    assert np.abs(P[k0:, :w] - at[:, :w]).max() < 1e-12 * np.abs(at).max()
    assert np.abs(Wo[k0:, :w] - W).max() < 1e-12 * np.abs(W).max()
    assert np.abs(t[:w] - tau[k0:k0 + w]).max() < 1e-12


def _q2_contract(vout, d, e, ab, b):
    """(spectrum error, orthogonality, max|Q2^T A Q2 - T|) of a chase."""
    from elementalx_torch.lapack.sbr import _apply_q2

    n = ab.shape[0]
    T = np.diag(d) + np.diag(e, -1) + np.diag(e, 1)
    ev = np.linalg.eigvalsh(ab.astype(np.float64))
    spec = np.abs(np.linalg.eigvalsh(T.astype(np.float64)) - ev).max()
    Q2 = _apply_q2(torch.tensor(vout), torch.eye(n, dtype=torch.float64),
                   n, b).numpy()
    return (spec, np.abs(Q2.T @ Q2 - np.eye(n)).max(),
            np.abs(Q2.T @ ab @ Q2 - T).max())


def test_sb2tr_plain_vs_pallas_interpret():
    """n=256, b=128 f32 against the Pallas chase in interpret mode (x64
    off; fed sbr._band_to_ds's layout). f32 rounding inside the chase
    moves single d/e entries by ~1e-3 while the spectra agree to ~1e-6,
    so the two are compared through the spectrum (each within 100 n eps
    max|w| of eigvalsh of the band) and the backtransform (each Q2
    orthogonal to 1e-5 and reducing the band to its T to 1e-4 max|w|),
    never elementwise on d/e."""
    import jax
    import jax.numpy as jnp
    from elementalx.kernels.sb2tr import sb2tr as jsb2tr
    from elementalx.lapack.sbr import _band_to_ds

    n, b = 256, 128
    ab = _band(np.random.default_rng(32), n, b, np.float32)
    with jax.enable_x64(False):
        jv, de = (np.asarray(x) for x in jsb2tr(_band_to_ds(
            jnp.asarray(ab), b), n, b, interpret=True))
    jd = np.concatenate([ab[:1, 0], de[:n - 1, 1]])
    je = de[:n - 1, 0]
    v, d, e = (x.numpy() for x in sb2tr(torch.tensor(ab), b))
    assert v.shape == jv.shape
    wmax = np.abs(np.linalg.eigvalsh(ab.astype(np.float64))).max()
    for vv, dd, ee in ((jv, jd, je), (v, d, e)):
        spec, orth, red = _q2_contract(vv.astype(np.float64), dd, ee,
                                       ab.astype(np.float64), b)
        assert spec < 100 * n * np.finfo(np.float32).eps * wmax
        assert orth < 1e-5 and red < 1e-4 * wmax


@pytest.mark.parametrize("n,b", [(64, 16), (50, 4), (7, 2), (2, 2)])
def test_sb2tr_plain_contract_f64(n, b):
    """float64, small bands including a window wider than what is left
    and the no-sweep case n=2: the spectrum and the backtransform to
    1e-12."""
    ab = _band(np.random.default_rng(33), n, b)
    v, d, e = (x.numpy() for x in sb2tr(torch.tensor(ab), b))
    spec, orth, red = _q2_contract(v, d, e, ab, b)
    scale = max(np.abs(ab).max(), 1)
    assert spec < 1e-12 * scale and orth < 1e-12 and red < 1e-12 * scale


def test_latrd_sb2tr_cpu_tensors_count_nothing():
    before = (latrd_panel.launches, sb2tr.launches)
    a = torch.eye(8, dtype=torch.float64)
    latrd_panel(a, 0, 4, 4)
    sb2tr(a, 2)
    assert (latrd_panel.launches, sb2tr.launches) == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("M,k0,w,dt", [
    (300, 0, 64, torch.float64), (1000, 37, 100, torch.float32),
    (2048, 0, 128, torch.float64), (4096, 1024, 128, torch.float32),
    (70, 60, 8, torch.float64), (5, 0, 3, torch.float64),
])
def test_latrd_kernel_vs_plain(cuda, M, k0, w, dt):
    """K5 against its plain version on the card: P, W and tau to 1e-5
    (float32) / 1e-10 (float64) of the largest entry; rows < k0 and
    columns >= w zero; the reflectors (P below the pivot, with the
    implicit 1) have |v|^2 tau = 2 unless tau = 0."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((M, M), generator=g, device=cuda, dtype=torch.float64)
    a = ((x + x.mT) / 2).to(dt)
    before = latrd_panel.launches
    out = latrd_panel(a, k0, w, 128)
    ref = latrd_panel_plain(a, k0, w, 128)
    torch.cuda.synchronize()
    assert latrd_panel.launches == before + 1
    rtol = 1e-5 if dt == torch.float32 else 1e-10
    for o, r in zip(out, ref):
        assert (o - r).abs().max().item() <= rtol * r.abs().max().item()
    P, W, tau = out
    assert P[:k0].abs().sum().item() == 0 and W[:k0].abs().sum().item() == 0
    assert P[:, w:].abs().sum().item() == 0 and W[:, w:].abs().sum().item() == 0
    for j in range(w):
        v = P[k0 + j + 2:, j].double()
        t = tau[j].item()
        if t != 0:
            assert abs((1 + v.square().sum().item()) * t - 2) < 100 * rtol


@pytest.mark.cuda
def test_hermitian_tridiag_wide_blocksize_on_card(cuda):
    """HermitianTridiag at blocksize 256 on the card: every panel is a K5
    launch at K5's widest panel (128), so d and e equal the run at
    blocksize 128 bit for bit."""
    import elementalx_torch as Et
    from elementalx_torch.entry import make_eig_problem
    from elementalx_torch.lapack.condense import HermitianTridiag

    n = 1024
    h = Et.DistMatrix.from_global(make_eig_problem(n, device=cuda, seed=10),
                                  grid=Et.Grid(cuda))
    before = latrd_panel.launches
    wide = HermitianTridiag(Et.LOWER, h, blocksize=256)
    torch.cuda.synchronize()
    assert latrd_panel.launches - before == 8
    narrow = HermitianTridiag(Et.LOWER, h, blocksize=128)
    assert torch.equal(wide.d, narrow.d) and torch.equal(wide.e, narrow.e)


@pytest.mark.cuda
def test_latrd_kernel_refuses_complex_and_bad_width(cuda):
    a = torch.eye(16, dtype=torch.complex64, device=cuda)
    with pytest.raises(NotImplementedError):
        latrd_panel(a, 0, 4, 4)
    with pytest.raises(ValueError):
        latrd_panel(torch.eye(16, device=cuda), 10, 8, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(40, 4), (300, 16), (1000, 16),
                                 (1024, 128), (513, 256)])
def test_sb2tr_kernel_vs_plain_f64(cuda, n, b):
    """K6 in float64 against the sequential plain chase: the same ops in
    the same order, so vout, d and e agree to float64 rounding (1e-9 of
    the band's largest entry)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((n, n), generator=g, device=cuda, dtype=torch.float64)
    i = torch.arange(n, device=cuda)
    ab = torch.where((i[:, None] - i[None, :]).abs() <= b, (x + x.mT) / 2,
                     torch.zeros((), dtype=torch.float64, device=cuda))
    before = sb2tr.launches
    v, d, e = sb2tr(ab, b)
    vp, dp, ep = sb2tr_plain(ab, b)
    torch.cuda.synchronize()
    assert sb2tr.launches == before + 1
    tol = 1e-9 * ab.abs().max().item()
    assert (v - vp).abs().max().item() <= tol
    assert (d - dp).abs().max().item() <= tol
    assert (e - ep).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(1000, 16), (2048, 128)])
def test_sb2tr_kernel_f32_spectrum(cuda, n, b):
    """float32: the spectrum of (d, e) within 100 n eps max|w| of
    eigvalsh of the band, and Q2 orthogonal to 100 n eps."""
    from elementalx_torch.lapack.sbr import _apply_q2

    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn((n, n), generator=g, device=cuda, dtype=torch.float64)
    i = torch.arange(n, device=cuda)
    ab = torch.where((i[:, None] - i[None, :]).abs() <= b, (x + x.mT) / 2,
                     torch.zeros((), dtype=torch.float64, device=cuda))
    v, d, e = sb2tr(ab.float(), b)
    T = torch.diag(d.double()) + torch.diag(e.double(), -1) \
        + torch.diag(e.double(), 1)
    ev = torch.linalg.eigvalsh(ab)
    eps = torch.finfo(torch.float32).eps
    assert (torch.linalg.eigvalsh(T) - ev).abs().max().item() \
        <= 100 * n * eps * ev.abs().max().item()
    Q2 = _apply_q2(v, torch.eye(n, device=cuda), n, b).double()
    assert (Q2.mT @ Q2 - torch.eye(n, device=cuda, dtype=torch.float64)
            ).abs().max().item() <= 100 * n * eps


@pytest.mark.cuda
def test_sb2tr_kernel_refuses_complex(cuda):
    with pytest.raises(NotImplementedError):
        sb2tr(torch.eye(8, dtype=torch.complex64, device=cuda), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["latrd", "sbr"])
def test_hermitian_eig_on_card(cuda, alg):
    """hermitian_eig_step at n=1024 f32 on the card: K5 on every latrd
    panel (eight of 128 columns) or K6 once for SBR, K1 for the
    products; scaled residual and orthogonality below 100."""
    import elementalx_torch as Et
    from elementalx_torch.entry import hermitian_eig_step, make_eig_problem

    n = 1024
    h = make_eig_problem(n, device=cuda, seed=9)
    before = (latrd_panel.launches, sb2tr.launches, matmul.launches)
    w, q, r = hermitian_eig_step(h, Et.HermitianEigCtrl(tridiag_alg=alg))
    torch.cuda.synchronize()
    k5, k6, k1 = (a - b for a, b in zip(
        (latrd_panel.launches, sb2tr.launches, matmul.launches), before))
    assert k1 > 0 and (k5 == 8 if alg == "latrd" else k6 == 1)
    assert float(r) < 100
    eps = torch.finfo(torch.float32).eps
    qd = q.double()
    orth = (qd.mT @ qd - torch.eye(n, device=cuda, dtype=torch.float64)
            ).abs().max().item() / (eps * n)
    assert orth < 100
