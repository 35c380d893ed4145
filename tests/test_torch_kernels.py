"""Port parity: the kernels K1 (local GEMM) and K3a (Cholesky diagonal
block).

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
