"""Port parity: the kernels K1 (local GEMM), K2 (masked rank-k update),
K3a (Cholesky diagonal block), K3b/K3c (fused panel tail), K4 (pivoted LU
panel), K5 (latrd panel), K6 (bulge chase), K7 (lower-triangle symv), K8
(the ring SUMMA; its CPU parity is in test_torch_summa.py) and K9 (the
level-1 elementwise kernels and the tiled transpose).

On the CPU each wrapper takes its plain PyTorch version; those are held
against the JAX package's Pallas kernels run in interpret mode, as the JAX
package's own kernel tests run them. The tests marked ``cuda`` compare the
CUDA kernels with their plain versions on the card and skip without one.
They import no JAX, so on a machine with a card and no JAX they run as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import importlib

import numpy as np
import pytest
import torch

from elementalx_torch.kernels import common
from elementalx_torch.kernels.elementwise import (
    axpby,
    axpby_plain,
    fill,
    fill_plain,
    hadamard,
    hadamard_plain,
    scale,
    scale_plain,
    transpose,
    transpose_plain,
)
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
    potrf_panel_tail,
    potrf_panel_tail_full,
    potrf_panel_tail_full_plain,
    potrf_panel_tail_plain,
)
from elementalx_torch.kernels.sb2tr import sb2tr, sb2tr_plain
from elementalx_torch.kernels.symv import (
    symv_lower,
    symv_lower_plain,
    symv_lower_trailing,
)
from elementalx_torch.kernels.trrk import masked_rank_k, masked_rank_k_plain


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


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("operands,core", [
    (lambda: (_bf16(64, 128), _bf16(128, 64)), "wgmma"),
    (lambda: (_bf16(128, 64).mT, _bf16(128, 64)), "wgmma"),
    (lambda: (_bf16(64, 128), _bf16(64, 128).mH), "wgmma"),
    (lambda: (_bf16(128, 64).mT, _bf16(64, 128).mT), "wgmma"),
    (lambda: (_bf16(1024, 1024)[512:, :384],
              _bf16(1024, 1024)[512:768, :384].mH), "wgmma"),
    (lambda: (_bf16(64, 0), _bf16(0, 16)), "wgmma"),
    (lambda: (_bf16(257, 129), _bf16(129, 65)), "fma"),
    (lambda: (_bf16(64, 130)[:, :128], _bf16(128, 64)), "fma"),
    (lambda: (_bf16(64, 136)[:, 1:129], _bf16(128, 64)), "fma"),
    (lambda: (_bf16(64, 128), _bf16(128, 72)[:, 3:67]), "fma"),
    (lambda: (torch.zeros(64, 128), torch.zeros(128, 64)), "fma_async"),
    (lambda: (torch.zeros(128, 64).mT, torch.zeros(64, 128).mT),
     "fma_async"),
    (lambda: (torch.zeros(1000, 777), torch.zeros(777, 1001)),
     "fma_async"),
    (lambda: (torch.zeros(777, 1000).mT, torch.zeros(1001, 777).mT),
     "fma_async"),
    (lambda: (torch.zeros(64, 128, dtype=torch.float64),
              torch.zeros(128, 64, dtype=torch.float64)), "dmma"),
    # the dist step's SUMMA_C k-panel: a column slice of an 8192-wide A
    # block times a (128 x 2) slice of B's rows (8 bytes apart)
    (lambda: (torch.empty(8192, 8192)[:, 128:256],
              torch.empty(8192, 2)[256:384]), "skinny"),
    (lambda: (torch.empty(8192, 128), torch.empty(8192, 2)[:128]),
     "skinny"),
    (lambda: (torch.zeros(128, 126), torch.zeros(2, 126).mT), "skinny"),
    (lambda: (torch.zeros(300, 50, dtype=torch.float64),
              torch.zeros(50, 16, dtype=torch.float64)), "skinny"),
    (lambda: (torch.zeros(300, 50), torch.zeros(50, 17)[:, 1:]), "skinny"),
    (lambda: (torch.zeros(64, 0), torch.zeros(0, 16)), "skinny"),
    (lambda: (torch.zeros(300, 50), torch.zeros(50, 17)), "fma_async"),
    (lambda: (_bf16(64, 128), _bf16(128, 16)), "wgmma"),
    (lambda: (torch.zeros(64, 256)[:, ::2], torch.zeros(128, 64)), "fma"),
    (lambda: (torch.zeros(64, 128), torch.zeros(128, 128)[:, ::2]), "fma"),
    (lambda: (torch.zeros(1000, 777, dtype=torch.float64),
              torch.zeros(777, 1001, dtype=torch.float64)), "dmma"),
    (lambda: (torch.zeros(777, 1000, dtype=torch.float64).mT,
              torch.zeros(1001, 777, dtype=torch.float64).mT), "dmma"),
    # the float64 Cholesky's history product: hist @ row.mH
    (lambda: (torch.zeros(1024, 1024, dtype=torch.float64)[512:, :384],
              torch.zeros(1024, 1024, dtype=torch.float64)[512:768,
                                                           :384].mH),
     "dmma"),
    (lambda: (torch.zeros(64, 0, dtype=torch.float64),
              torch.zeros(0, 17, dtype=torch.float64)), "dmma"),
    (lambda: (torch.zeros(64, 256, dtype=torch.float64)[:, ::2],
              torch.zeros(128, 64, dtype=torch.float64)), "fma"),
    (lambda: (torch.zeros(64, 128, dtype=torch.float64),
              torch.zeros(128, 128, dtype=torch.float64)[:, ::2]), "fma"),
    (lambda: (torch.zeros(64, 128, dtype=torch.float64),
              torch.zeros(16, 128, dtype=torch.float64).mT), "skinny"),
], ids=["bf16-contiguous", "bf16-A.mT", "bf16-B.mH", "bf16-both-mT",
        "bf16-history-slices", "bf16-K0", "bf16-ragged-rows",
        "bf16-odd-stride", "bf16-offset-base", "bf16-B-offset",
        "f32-contiguous", "f32-both-mT", "f32-ragged-rows",
        "f32-ragged-mT", "f64", "f32-summa-c-owner-panel",
        "f32-summa-c-broadcast-panel", "f32-latrd-B.mT", "f64-N16",
        "f32-N16-offset", "f32-K0-N16", "f32-N17", "bf16-N16",
        "f32-A-no-unit-stride", "f32-B-no-unit-stride", "f64-ragged",
        "f64-ragged-mT", "f64-history-B.mH", "f64-K0",
        "f64-A-no-unit-stride", "f64-B-no-unit-stride", "f64-N16-B.mT"])
def test_matmul_route(operands, core):
    """K1's core follows from dtype, shape and alignment alone: float32
    and float64 products of at most 16 columns take the skinny route at
    any strides; bfloat16 operands that can be read in place in 16-byte
    pieces (a 16-byte aligned base, one unit stride, the other a multiple
    of 16 bytes; any when K = 0) take the tensor cores, float32
    operands with a unit stride each the FP32 pipeline (4-byte copies
    where 16-byte ones do not fit) and float64 ones the FP64 tensor cores
    (8-byte copies where 16-byte ones do not fit); the rest, float64 with
    no unit stride included, the FMA core."""
    from elementalx_torch.kernels.matmul import route

    a, b = operands()
    assert route(a, b) == core


@pytest.mark.parametrize("operands,narrow", [
    (lambda: (torch.zeros(2048, 2048, dtype=torch.float64),
              torch.zeros(2048, 2048, dtype=torch.float64)), False),
    (lambda: (torch.zeros(1024, 1024, dtype=torch.float64)[512:, :384],
              torch.zeros(1024, 1024, dtype=torch.float64)[512:768,
                                                           :384].mH),
     False),
    (lambda: (torch.zeros(1000, 777, dtype=torch.float64),
              torch.zeros(777, 1001, dtype=torch.float64)), True),
    (lambda: (torch.zeros(777, 1000, dtype=torch.float64).mT,
              torch.zeros(1001, 777, dtype=torch.float64).mT), True),
    (lambda: (torch.zeros(64, 130, dtype=torch.float64)[:, 1:129],
              torch.zeros(128, 64, dtype=torch.float64)), True),
    (lambda: (torch.zeros(64, 128, dtype=torch.float64),
              torch.zeros(128, 66, dtype=torch.float64)[:, 1:65]), True),
    (lambda: (torch.zeros(64, 0, dtype=torch.float64),
              torch.zeros(0, 17, dtype=torch.float64)), False),
    (lambda: (torch.zeros(1000, 777), torch.zeros(777, 1001)), True),
    (lambda: (torch.zeros(1000, 780), torch.zeros(780, 1004)), False),
], ids=["f64-square", "f64-history-B.mH", "f64-ragged-rows",
        "f64-ragged-mT", "f64-A-odd-base", "f64-B-odd-base", "f64-K0",
        "f32-ragged-rows", "f32-16-byte-rows"])
def test_matmul_narrow_copies(operands, narrow):
    """The cp.async cores copy in 16-byte pieces when both operands can
    be read so (a 16-byte aligned base, the other stride a multiple of 16
    bytes) and one element at a time (4 or 8 bytes) otherwise; the flag
    follows from the layout alone, and K = 0 copies nothing."""
    from elementalx_torch.kernels.matmul import narrow_copies, route

    a, b = operands()
    assert route(a, b) in ("dmma", "fma_async")
    assert narrow_copies(a, b) is narrow


@pytest.mark.parametrize("operand,sms,plan", [
    # the SUMMA_C panel: a warp a row, 16-byte loads, 1024 blocks >= 528
    (lambda: torch.empty(8192, 8192)[:, 128:256], 132, (0, 1, 1, 128)),
    # rows of 126 floats (504 bytes): a warp a row, 4-byte loads
    (lambda: torch.zeros(128, 126), 132, (0, 0, 1, 126)),
    (lambda: torch.zeros(1, 130)[:, 1:], 132, (0, 0, 1, 129)),
    # SUMMA_A's (8192 x 8192): enough rows, no split
    (lambda: torch.empty(8192, 8192), 132, (0, 1, 1, 8192)),
    # few rows, long K: K cut into slices of a multiple of 128
    (lambda: torch.empty(64, 100000), 132, (0, 1, 66, 1536)),
    (lambda: torch.empty(64, 100000), 8, (0, 1, 4, 25088)),
    # A.mT: a thread a row
    (lambda: torch.empty(100000, 64).mT, 132, (1, 0, 157, 640)),
    (lambda: torch.empty(300, 50, dtype=torch.float64).mT, 132,
     (1, 0, 1, 300)),
    (lambda: torch.zeros(64, 0), 132, (0, 0, 1, 1)),
], ids=["summa-c", "ragged-rows", "offset-base", "summa-a", "split",
        "split-8-sms", "mT-split", "f64-mT", "K0"])
def test_skinny_plan(operand, sms, plan):
    """The skinny route's launch follows from A's strides, alignment and
    shape and the card's SM count alone; a split K covers K with slices
    of a multiple of 128 k, at least 512, so that the row blocks times
    the slices reach 4 blocks an SM."""
    from elementalx_torch.kernels.matmul import skinny_plan

    a = operand()
    got = skinny_plan(a, sms)
    assert got == plan
    cols, _, S, kslice = got
    K = a.shape[1]
    assert S * kslice >= K and (S - 1) * kslice < max(K, 1)
    if S > 1:
        assert kslice % 128 == 0 and kslice >= 512
        blocks = -(-a.shape[0] // (256 if cols else 8))
        assert blocks < 4 * sms


@pytest.mark.parametrize("dt,k,core", [
    (torch.bfloat16, 1024, "wgmma"), (torch.float32, 1024, "fma_async"),
    (torch.float64, 1024, "fma"), (torch.bfloat16, 4 * 96, "fma"),
    (torch.float32, 4 * 32, "fma"), (torch.bfloat16, 777 + 3, "fma"),
], ids=["bf16", "f32", "f64", "bf16-kb96", "f32-kb32", "bf16-ragged"])
def test_ring_summa_route(dt, k, core):
    """K8's core: bf16 / f32 row-major blocks read in 16-byte pieces with
    kb = K/p a multiple of 64 take the tensor cores / the FP32 pipeline;
    any other ring the FMA core."""
    from elementalx_torch.kernels.ring_summa import route

    p = 4
    a = [torch.zeros((100, k), dtype=dt) for _ in range(p)]
    b = [torch.zeros((k // p, 136), dtype=dt) for _ in range(p)]
    assert route(a, b) == core


def test_route_counters_start_at_zero_and_cpu_counts_nothing():
    from elementalx_torch.kernels.matmul import CORES, reset_launches
    from elementalx_torch.kernels.ring_summa import CORES as K8_CORES
    from elementalx_torch.kernels.ring_summa import ring_summa_kernel

    reset_launches()
    a = torch.ones((64, 64), dtype=torch.bfloat16)
    matmul(a, a)
    ring_summa_kernel([a] * 2, [a[:32]] * 2)
    assert matmul.launches == 0
    assert all(getattr(matmul, f"launches_{c}") == 0 for c in CORES)
    assert all(hasattr(ring_summa_kernel, f"launches_{c}") for c in K8_CORES)


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


@pytest.mark.parametrize("w,dt,rt", [
    (1, torch.float32, "cluster"), (33, torch.float32, "cluster"),
    (200, torch.float32, "cluster"), (512, torch.float32, "cluster"),
    (513, torch.float32, "blocked"), (2048, torch.float32, "blocked"),
    (1, torch.float64, "cluster"), (384, torch.float64, "cluster"),
    (385, torch.float64, "blocked"), (512, torch.float64, "blocked"),
])
def test_potrf_route(w, dt, rt):
    """K3a's and K3b's route from w and the dtype alone: the cluster route
    wherever one CTA a 32-row block holds its row of L, its column of
    inv(L), the step's panel copy and X_kk^T in 227 KB (2 nt + 2 tiles of
    32 rows, 36 floats or 34 doubles apart), at most 16 CTAs; and the
    apply role's strip and column block fit too."""
    k3 = importlib.import_module("elementalx_torch.kernels.potrf")

    assert k3.route(w, dt) == rt
    nt = -(-w // 32)
    ld, lda = (36, 68) if dt == torch.float32 else (34, 34)
    factor = (2 * nt + 2) * 32 * ld * dt.itemsize
    apply = 32 * nt * (lda + 32) * dt.itemsize
    fits = nt <= 16 and max(factor, apply) + 1024 <= 232448
    assert fits == (rt == "cluster")


@pytest.mark.parametrize("tail", [False, True], ids=["k3a", "k3b"])
def test_potrf_workspace(tail):
    """The scratch each route needs, as the C entries split it."""
    k3 = importlib.import_module("elementalx_torch.kernels.potrf")
    f32, f64 = torch.float32, torch.float64
    own = 200 * 200 if tail else 0
    x = 17 * 32 * 32  # the factor CTAs' exchange tiles
    assert k3.workspace(tail, "steps" if not tail else "grid", 200, f32) \
        == (2 * 256 * 256 + 256 * 256 // 4 + own, 1)
    assert k3.workspace(tail, "cluster", 200, f32) == (x + own, 5)
    assert k3.workspace(tail, "blocked", 200, f64) \
        == (x + own + 2 * 200 * 384, 5)
    w = 2048
    assert k3.workspace(tail, "blocked", w, f32) \
        == (x + (w * w if tail else 0) + 2 * w * 512, 5)


def test_potrf_scratch_cached_per_call_shape():
    """The scratch is allocated once per (kernel, route, device, stream,
    dtype, w), with zeroed flags, and handed back on the next call."""
    k3 = importlib.import_module("elementalx_torch.kernels.potrf")
    t = torch.zeros((3,), dtype=torch.float64)
    k3._SCRATCH.clear()
    ws, flags = k3._scratch(True, "blocked", t, 600, 0)
    assert ws.numel() == 17 * 32 * 32 + 600 * 600 + 2 * 600 * 384
    assert ws.dtype == t.dtype
    assert flags.dtype == torch.int32 and not bool(flags.any())
    again = k3._scratch(True, "blocked", t, 600, 0)
    assert again[0] is ws and again[1] is flags
    for other in (k3._scratch(False, "blocked", t, 600, 0),
                  k3._scratch(True, "cluster", t, 600, 0),
                  k3._scratch(True, "blocked", t, 601, 0),
                  k3._scratch(True, "blocked", t, 600, 7),
                  k3._scratch(True, "blocked", t.float(), 600, 0)):
        assert other[0] is not ws and other[1] is not flags
    assert len(k3._SCRATCH) == 6
    k3._SCRATCH.clear()


def test_potrf_reset_launches_and_cpu_counts_nothing():
    k3 = importlib.import_module("elementalx_torch.kernels.potrf")

    k3.reset_launches()
    s = torch.eye(4, dtype=torch.float64) * 2
    potrf_block_inv(s)
    potrf_panel_tail(s, torch.ones((6, 4), dtype=torch.float64))
    potrf_panel_tail_full(s, torch.ones((8, 4), dtype=torch.float64), 1)
    for fn, routes in ((potrf_block_inv, k3.ROUTES),
                       (potrf_panel_tail, k3.TAIL_ROUTES),
                       (potrf_panel_tail_full, k3.TAIL_ROUTES)):
        assert fn.launches == 0
        assert all(getattr(fn, f"launches_{r}") == 0 for r in routes)


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


@pytest.mark.parametrize("Mt,dt,rt,ctas", [
    # the LU path's sub-panels: about 512 rows a CTA, at most 16 CTAs
    # (16384 rows: 16 of 1024 rows, 132 KB each)
    (16384, torch.float32, "cluster", 16), (8192, torch.float32, "cluster", 16),
    (512, torch.float32, "cluster", 1), (1000, torch.float32, "cluster", 2),
    # float64: 512 rows a CTA at 4096; 16384 rows need 270 KB a CTA
    (4096, torch.float64, "cluster", 8), (16384, torch.float64, "grid", 0),
    (40000, torch.float32, "grid", 0), (120000, torch.float64, "grid", 0),
])
def test_getrf_route(Mt, dt, rt, ctas):
    """K4's route and cluster size from the shape and dtype alone: every
    CTA's rows of one group (33 words and a flag byte a row) fit in 227 KB
    of shared memory with room for the kernel's static arrays."""
    k4 = importlib.import_module("elementalx_torch.kernels.getrf")

    assert k4.route(Mt, dt) == rt and k4.cluster_ctas(Mt, dt) == ctas
    if ctas:
        rpc = -(-Mt // ctas)
        assert rpc * (33 * dt.itemsize + 1) + 12288 <= k4.SMEM_OPTIN


def test_getrf_sb2tr_reset_launches():
    k4 = importlib.import_module("elementalx_torch.kernels.getrf")
    k6 = importlib.import_module("elementalx_torch.kernels.sb2tr")

    k4.reset_launches()
    k6.reset_launches()
    getrf_panel(torch.eye(4))
    sb2tr(torch.eye(8, dtype=torch.float64), 2)
    assert getrf_panel.launches == 0 and sb2tr.launches == 0
    assert all(getattr(getrf_panel, f"launches_{r}") == 0
               for r in k4.ROUTES)
    assert all(getattr(sb2tr, f"launches_{r}") == 0 for r in k6.ROUTES)


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


def _latrd_replay(a, k0, w, nb):
    """K5's column schedule (csrc/latrd.cu) in plain torch, in K5's
    contract: each column's w formed lazily at the start of the next
    (p - coef v); acur from the row dots against W's and V's row gj, the
    last of W's taken from p(gp) - coef; the panel dots from the partials
    X^T acur below gp over the reflector's denominator plus X's row gp;
    p = tau (y - V (W^T v) - W (V^T v)) with y from the symmetric trailing
    block."""
    M = a.shape[0]
    rows = torch.arange(M)
    Vr = a.new_zeros((M, nb))
    Wr = a.new_zeros((M, nb))
    P = a.new_zeros((M, nb))
    Wout = a.new_zeros((M, nb))
    tau = a.new_zeros((nb,))
    low = torch.tril(a[k0:, k0:])
    sym = low + torch.tril(a[k0:, k0:], -1).mT
    pbuf = a.new_zeros((M,))
    vprev = a.new_zeros((M,))
    coef = a.new_zeros(())
    s_pgp = a.new_zeros(())
    for jl in range(w):
        gj, gp = k0 + jl, k0 + jl + 1
        if jl > 0:
            wprev = pbuf - coef * vprev
            Wr[k0:, jl - 1] = wprev[k0:]
            Wout[k0:, jl - 1] = wprev[k0:]
        sWg = Wr[gj, :jl].clone()
        if jl > 0:
            sWg[jl - 1] = s_pgp - coef
        sVg = Vr[gj, :jl]
        x = torch.where(rows >= gj, a[:, gj], a[gj, :])
        acur = x - (Vr[:, :jl] @ sWg + Wr[:, :jl] @ sVg)
        acur[:k0] = 0
        below = rows > gp
        sigma2 = (acur[below] ** 2).sum()
        pdW = Wr[below, :jl].mT @ acur[below]
        pdV = Vr[below, :jl].mT @ acur[below]
        alpha = acur[gp]
        norm = torch.sqrt(alpha * alpha + sigma2)
        beta0 = norm if alpha < 0 else -norm
        trivial = bool(sigma2 == 0)
        denom = a.new_ones(()) if trivial else alpha - beta0
        t = a.new_zeros(()) if trivial else (beta0 - alpha) / (
            beta0 if beta0 != 0 else 1)
        beta = alpha if trivial else beta0
        v = torch.where(below, acur / denom, a.new_zeros(()))
        v[gp] = 1
        Vr[:, jl] = v
        P[k0:, jl] = torch.where(rows > gp, v, torch.where(
            rows == gp, beta, acur))[k0:]
        dW = pdW / denom + Wr[gp, :jl]
        dV = pdV / denom + Vr[gp, :jl]
        y = a.new_zeros((M,))
        y[k0:] = sym @ v[k0:]
        p = t * (y - Vr[:, :jl] @ dW - Wr[:, :jl] @ dV)
        p[:k0] = 0
        pbuf, s_pgp = p, p[gp]
        coef = t * 0.5 * (v * p).sum()
        vprev = v
        tau[jl] = t
    Wout[k0:, w - 1] = (pbuf - coef * vprev)[k0:]
    return P, Wout, tau


@pytest.mark.parametrize("M,k0,w,nb,dtype", [
    (256, 0, 128, 128, np.float64), (256, 64, 126, 128, np.float64),
    (90, 7, 20, 32, np.float64), (131, 3, 60, 64, np.float64),
    (256, 0, 128, 128, np.float32),
], ids=["f64-256-k0", "f64-256-k64", "f64-ragged", "f64-odd", "f32-256"])
def test_latrd_replay_vs_plain(M, k0, w, nb, dtype):
    """K5's column schedule replayed in plain torch against
    latrd_panel_plain: float64 to 1e-12 of the largest entry (the
    schedule reorders sums: lazy w, panel dots over the denominator);
    float32 to 2e-4 (symvs of 256 terms in other orders over 128
    columns)."""
    a = torch.tensor(_sym(np.random.default_rng(33), M, dtype))
    out = _latrd_replay(a, k0, w, nb)
    ref = latrd_panel_plain(a, k0, w, nb)
    rtol = 1e-12 if dtype == np.float64 else 2e-4
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert (o - r).abs().max().item() <= rtol * r.abs().max().item()


@pytest.mark.parametrize("k0,w", [(0, 128), (64, 126)])
def test_latrd_replay_vs_pallas_interpret(k0, w):
    """The replayed column schedule, M=256 f32, against the Pallas kernel
    in interpret mode, as test_latrd_plain_vs_pallas_interpret holds the
    plain version: rows >= k0 to 2e-4 of max|ref|."""
    import jax
    import jax.numpy as jnp
    from elementalx.kernels.latrd import latrd_panel as jlatrd

    a = _sym(np.random.default_rng(30), 256)
    with jax.enable_x64(False):
        ref = [np.asarray(x) for x in jlatrd(jnp.asarray(a), k0, w, nb=128,
                                             ts=128, interpret=True)]
    out = [x.numpy() for x in _latrd_replay(torch.tensor(a), k0, w, 128)]
    for o, r in zip(out[:2], ref[:2]):
        assert np.abs(o[k0:, :w] - r[k0:, :w]).max() < 2e-4 * np.abs(
            r[k0:, :w]).max()
    assert np.abs(out[2][:w] - ref[2][:w]).max() < 2e-4 * np.abs(ref[2]).max()


def test_latrd_replay_vs_xla_panel_f64():
    """The replayed column schedule against the JAX package's XLA panel
    (condense._tridiag_panel), float64, M=90, k0=7, w=20: 1e-12 of
    max|ref|."""
    import jax.numpy as jnp
    from elementalx.lapack.condense import _tridiag_panel

    M, k0, w = 90, 7, 20
    a = _sym(np.random.default_rng(31), M, np.float64)
    at, _, W, tau = (np.asarray(x) for x in _tridiag_panel(
        jnp.asarray(a), jnp.asarray(a[k0:, k0:]), jnp.zeros((M - k0, w)),
        jnp.zeros((M - k0, w)), jnp.zeros((M,)), k0, w, M - k0))
    P, Wo, t = (x.numpy() for x in _latrd_replay(torch.tensor(a), k0, w, 32))
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


@pytest.mark.parametrize("b,dt,rt,ctas", [
    (256, torch.float32, "cluster", 8), (128, torch.float32, "cluster", 4),
    (16, torch.float32, "cluster", 1), (2, torch.float64, "cluster", 1),
    (256, torch.float64, "cluster", 8), (512, torch.float32, "cluster", 16),
    (512, torch.float64, "l2", 0), (1024, torch.float32, "l2", 0),
])
def test_sb2tr_route(b, dt, rt, ctas):
    """K6's route and cluster size from b and the dtype alone: about 32
    window rows a CTA, the three R x b blocks in 227 KB of shared memory
    (float64 at b=256: 8 CTAs, 204 KB each)."""
    k6 = importlib.import_module("elementalx_torch.kernels.sb2tr")

    assert k6.route(b, dt) == rt and k6.cluster_size(b, dt) == ctas
    if ctas:
        assert k6._cluster_smem(b, -(-b // ctas), dt.itemsize) \
            <= k6.SMEM_OPTIN


def test_sb2tr_chain_ops():
    """The critical path of the chase: about 2n ops at the kernel's lag of
    two, about 3n at the first design's lag of three (n=8192: 16380 and
    24314 at b=256); a single sweep is its own ops."""
    k6 = importlib.import_module("elementalx_torch.kernels.sb2tr")
    from elementalx_torch.lapack.sbr import chase_ops

    assert k6.chain_ops(8192, 256, 2) == 16380
    assert k6.chain_ops(8192, 256, 3) == 24314
    assert k6.chain_ops(3, 2) == chase_ops(3, 2, 0)
    for n, b in ((100, 3), (1000, 16)):
        two, three = k6.chain_ops(n, b, 2), k6.chain_ops(n, b, 3)
        assert 2 * (n - 3) < two < three <= 3 * n


def test_latrd_sb2tr_cpu_tensors_count_nothing():
    before = (latrd_panel.launches, sb2tr.launches)
    a = torch.eye(8, dtype=torch.float64)
    latrd_panel(a, 0, 4, 4)
    sb2tr(a, 2)
    assert (latrd_panel.launches, sb2tr.launches) == before


# ---------------------------------------------------------------------------
# K2, K3b/K3c and K7 on the CPU: the plain versions against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lower", [True, False], ids=["lo", "up"])
@pytest.mark.parametrize("shape", [(24, 9, 24), (31, 7, 18), (12, 5, 40)],
                         ids=["square", "tall", "wide"])
def test_masked_rank_k_plain_vs_jax(lower, shape):
    """The JAX kernel's CPU route (trrk.py:51-59), float64, 1e-12 of
    max|C|; entries off the triangle are C's, bit for bit."""
    import jax.numpy as jnp
    from elementalx.kernels.trrk import masked_rank_k as jtrrk

    M, K, N = shape
    rng = np.random.default_rng(16)
    a, b, c = (rng.standard_normal(s) for s in ((M, K), (K, N), (M, N)))
    ref = np.asarray(jtrrk(lower, -1.5, jnp.asarray(a), jnp.asarray(b), 0.5,
                           jnp.asarray(c)))
    out = masked_rank_k(lower, -1.5, torch.tensor(a), torch.tensor(b), 0.5,
                        torch.tensor(c)).numpy()
    assert _rel(out, ref) < 1e-12
    off = np.triu(np.ones((M, N), bool), 1) if lower \
        else np.tril(np.ones((M, N), bool), -1)
    np.testing.assert_array_equal(out[off], c[off])


def test_masked_rank_k_plain_f32_and_strided():
    """float32 through transposed views (Herk's op(A), op(A)^T), against
    the JAX route at 1e-5."""
    import jax.numpy as jnp
    from elementalx.kernels.trrk import masked_rank_k as jtrrk

    rng = np.random.default_rng(17)
    a = rng.standard_normal((40, 33)).astype(np.float32)
    c = rng.standard_normal((33, 33)).astype(np.float32)
    ta = torch.tensor(a)
    out = masked_rank_k(True, 1.0, ta.mT, ta, 1.0, torch.tensor(c))
    ref = np.asarray(jtrrk(True, 1.0, jnp.asarray(a.T), jnp.asarray(a), 1.0,
                           jnp.asarray(c)))
    assert out.dtype == torch.float32
    assert _rel(out.numpy(), ref) < 1e-5


def _tail_inputs(rng, Mt, w):
    """A history-updated panel of an SPD matrix with garbage above the
    diagonal of its (w, w) block, and the symmetrized block (as
    tests/kernels/test_kernels.py:369-394 builds them)."""
    A = rng.standard_normal((Mt, Mt)).astype(np.float32)
    S = (A @ A.T / Mt + np.eye(Mt)).astype(np.float32)
    pan = np.array(S[:, :w])
    pan[:w] += np.triu(rng.standard_normal((w, w)), 1).astype(np.float32)
    sym = np.tril(S[:w, :w]) + np.tril(S[:w, :w], -1).T
    return S, pan, sym


@pytest.mark.parametrize("low_apply", [False, True], ids=["f32", "low"])
def test_potrf_panel_tail_plain_vs_pallas_interpret(low_apply):
    """(Mt, w) = (768, 256). float32: 1e-5 relative against the JAX kernel
    and against numpy's factor. low_apply rounds both operands of the L21
    product to bfloat16 in the port; on the CPU the JAX kernel's
    DEFAULT-precision dot is full float32, so the two differ by that
    rounding, 2^-8 of an operand: 1e-2 of max|L|. That the port rounds is
    held apart: its L21 lies within 5e-4 of the same rounding applied to
    numpy's float64 factor, and more than ten times that error away from
    its own L21 without low_apply."""
    import jax.numpy as jnp
    from elementalx.kernels.potrf import potrf_panel_tail as jtail

    S, pan, sym = _tail_inputs(np.random.default_rng(18), 768, 256)
    ref = np.asarray(jtail(jnp.asarray(sym), jnp.asarray(pan),
                           interpret=True, low_apply=low_apply))
    out = potrf_panel_tail(torch.tensor(sym), torch.tensor(pan),
                           low_apply=low_apply).numpy()
    exact = np.linalg.cholesky(S.astype(np.float64))[:, :256]
    tol = 1e-2 if low_apply else 1e-5
    assert _rel(out, ref) < tol
    assert _rel(out, exact) < tol
    assert _rel(out[:256], exact[:256]) < 1e-5
    assert np.abs(np.triu(out[:256], 1)).max() == 0.0
    if low_apply:
        def bf16(x):
            return torch.tensor(x).bfloat16().double().numpy()

        linv_t = np.linalg.inv(np.linalg.cholesky(sym.astype(np.float64))).T
        rounded = bf16(pan[256:]) @ bf16(linv_t)
        unrounded = potrf_panel_tail(torch.tensor(sym),
                                     torch.tensor(pan)).numpy()
        err = _rel(out[256:], rounded)
        assert err < 5e-4
        assert _rel(out[256:], unrounded[256:]) > 10 * err


@pytest.mark.parametrize("kidx", [0, 1, 3])
def test_potrf_panel_tail_full_plain_vs_pallas_interpret(kidx):
    """K3c at (1024, 256): zeros above tile kidx, then K3b's output on the
    rows from there (1e-5 against the JAX kernel, exact against K3b's
    plain version)."""
    import jax.numpy as jnp
    from elementalx.kernels.potrf import potrf_panel_tail_full as jfull

    rng = np.random.default_rng(19)
    S, _, _ = _tail_inputs(rng, 1024, 256)
    r0 = kidx * 256
    pan = np.array(S[:, r0:r0 + 256])
    pan[:r0] = rng.standard_normal((r0, 256))  # never read
    blk = S[r0:r0 + 256, r0:r0 + 256]
    sym = np.tril(blk) + np.tril(blk, -1).T
    ref = np.asarray(jfull(jnp.asarray(sym), jnp.asarray(pan), kidx,
                           interpret=True))
    out = potrf_panel_tail_full(torch.tensor(sym), torch.tensor(pan),
                                kidx).numpy()
    assert _rel(out, ref) < 1e-5
    assert not out[:r0].any()
    tail = potrf_panel_tail(torch.tensor(sym), torch.tensor(pan[r0:]))
    np.testing.assert_array_equal(out[r0:], tail.numpy())


def test_potrf_panel_tail_non_hpd_and_shapes():
    """A block that is not positive definite: the JAX kernel poisons some
    columns, the port every row from the diagonal tile down, and K3c keeps
    its zeros above. Any (Mt, w), float64 included."""
    import jax.numpy as jnp
    from elementalx.kernels.potrf import potrf_panel_tail as jtail

    S, pan, sym = _tail_inputs(np.random.default_rng(20), 384, 128)
    jref = np.asarray(jtail(jnp.asarray(-sym), jnp.asarray(pan),
                            interpret=True))
    assert np.isnan(jref).any()
    assert np.isnan(potrf_panel_tail(torch.tensor(-sym),
                                     torch.tensor(pan)).numpy()).all()
    full = potrf_panel_tail_full(torch.tensor(-sym), torch.tensor(pan), 0)
    assert bool(full.isnan().all())
    full2 = potrf_panel_tail_full_plain(torch.tensor(-sym[:64, :64]),
                                        torch.tensor(pan[:, :64]), 2)
    assert not full2[:128].any() and bool(full2[128:].isnan().all())
    rng = np.random.default_rng(21)
    s = _spd(rng, 37, np.float64)
    p = rng.standard_normal((101, 37))
    out = potrf_panel_tail_plain(torch.tensor(s), torch.tensor(p)).numpy()
    l11 = np.linalg.cholesky(s)
    assert np.abs(out[:37] - l11).max() < 1e-12
    assert _rel(out[37:], p[37:] @ np.linalg.inv(l11).T) < 1e-12


@pytest.mark.parametrize("n", [64, 200])
def test_symv_plain_vs_jax(n):
    """Against JAX's symv_lower, whose CPU route reads a fully stored A
    (float64, 1e-12); the port's plain version gives the same y when the
    strict upper triangle holds NaN, and symv_lower_trailing reads the
    trailing block at k0 exactly."""
    import jax.numpy as jnp
    from elementalx.kernels.symv import symv_lower as jsymv
    from elementalx.kernels.symv import symv_lower_trailing as jtrail

    rng = np.random.default_rng(22)
    g = rng.standard_normal((n, n))
    A, v = g + g.T, rng.standard_normal(n)
    ref = np.asarray(jsymv(jnp.asarray(A), jnp.asarray(v)))
    assert _rel(symv_lower(torch.tensor(A), torch.tensor(v)).numpy(),
                ref) < 1e-12
    An = A.copy()
    An[np.triu_indices(n, 1)] = np.nan
    assert _rel(symv_lower(torch.tensor(An), torch.tensor(v)).numpy(),
                ref) < 1e-12
    k0 = 37
    rt = np.asarray(jtrail(jnp.asarray(A), jnp.asarray(v[k0:]), k0))
    out = symv_lower_trailing(torch.tensor(An), torch.tensor(v[k0:]), k0)
    assert _rel(out.numpy(), rt) < 1e-12
    np.testing.assert_array_equal(
        out.numpy(), symv_lower_plain(torch.tensor(An[k0:, k0:]),
                                      torch.tensor(v[k0:])).numpy())


def test_new_kernels_cpu_tensors_count_nothing():
    before = (masked_rank_k.launches, potrf_panel_tail.launches,
              potrf_panel_tail_full.launches, symv_lower.launches)
    a = torch.eye(8)
    masked_rank_k(True, 1.0, a, a, 1.0, a)
    potrf_panel_tail(a[:4, :4] + 1e-3, a[:, :4])
    potrf_panel_tail_full(a[:4, :4] + 1e-3, a[:, :4], 1)
    symv_lower(a, a[0])
    assert (masked_rank_k.launches, potrf_panel_tail.launches,
            potrf_panel_tail_full.launches, symv_lower.launches) == before


def _f32(rows, cols, dtype=torch.float32):
    return torch.zeros((rows, cols), dtype=dtype)


@pytest.mark.parametrize("matrix,core", [
    (lambda: _f32(1024, 1024), "tma"),
    (lambda: _f32(1024, 1024)[37:, 37:], "tma"),
    (lambda: _f32(1024, 1024)[1:, 1:], "tma"),
    (lambda: _f32(16384, 16384)[5000:, 5000:], "tma"),
    (lambda: _f32(1000, 1004)[:, :1000], "tma"),
    (lambda: _f32(1000, 1001)[:, :1000], "async"),
    (lambda: _f32(1000, 1002)[:, :1000], "async"),
    (lambda: _f32(1001, 1001), "async"),
    (lambda: _f32(1001, 1001)[1:, 1:], "async"),
    (lambda: _f32(1000, 1000).mT, "tma"),
    (lambda: _f32(1001, 1001).mT, "async"),
    (lambda: _f32(1000, 1002, torch.float64)[:, :1000], "tma"),
    (lambda: _f32(1001, 1001, torch.float64), "async"),
    (lambda: _f32(1000, 1000, torch.float64)[37:, 37:], "tma"),
], ids=["f32-contiguous", "f32-k0-37", "f32-k0-1", "f32-k0-5000",
        "f32-stride-1004", "f32-stride-1001", "f32-stride-1002",
        "f32-order-1001", "f32-order-1001-k0-1", "f32-mT-copy",
        "f32-mT-copy-1001", "f64-stride-1002", "f64-order-1001",
        "f64-k0-37"])
def test_symv_route(matrix, core):
    """K7's core follows from dtype and layout alone: a row stride (of A in
    place, or of its contiguous copy when A's columns are not unit-stride)
    that is a multiple of 16 bytes takes the TMA tiles at any offset
    (the tensor map starts at the 16-byte boundary before A), any other
    the same tiles filled by cp.async."""
    from elementalx_torch.kernels.symv import route

    assert route(matrix()) == core


@pytest.mark.parametrize("matrix,nbytes", [
    (lambda: _f32(1001, 1001), 4),
    (lambda: _f32(1000, 1002)[:, :1000], 8),
    (lambda: _f32(1000, 1002)[1:, 1:], 4),
    (lambda: _f32(1000, 1002)[2:, 2:], 8),
    (lambda: _f32(1001, 1001)[1:, 1:], 4),
    (lambda: _f32(16383, 16383), 4),
    (lambda: _f32(1001, 1001, torch.float64), 8),
    (lambda: _f32(1001, 1001, torch.float64)[1:, 1:], 8),
], ids=["f32-odd-rows", "f32-8-byte-rows", "f32-8-byte-rows-odd-base",
        "f32-8-byte-rows-k0-2", "f32-odd-rows-k0-1", "f32-16383",
        "f64-odd-rows", "f64-odd-rows-k0-1"])
def test_symv_async_copy_bytes(matrix, nbytes):
    """The "async" core's cp.async copies: 8 bytes where A's base is
    8-byte aligned and its rows 8-byte multiples apart (float64 always),
    else 4; from the layout alone."""
    from elementalx_torch.kernels.symv import copy_bytes, route

    A = matrix()
    assert route(A) == "async"
    assert copy_bytes(A) == nbytes


def test_symv_counters_by_core_and_cpu_counts_nothing():
    from elementalx_torch.kernels.symv import CORES, reset_launches

    reset_launches()
    a = torch.eye(8)
    symv_lower(a, a[0])
    assert symv_lower.launches == 0
    assert all(getattr(symv_lower, f"launches_{c}") == 0 for c in CORES)


# ---------------------------------------------------------------------------
# K9 on the CPU: the plain versions against the JAX Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elementwise_plain_vs_pallas_interpret(dtype, monkeypatch):
    """The five JAX kernels in interpret mode (``on_tpu`` patched to True
    for this test only) against the plain versions on (8, 128)-tileable
    inputs. scale, hadamard, fill and transpose round once on both sides:
    equal bit for bit. axpy is a product and a sum, which XLA may contract
    into one fused multiply-add (one rounding) where the plain version
    rounds twice: float32 within 1e-6 of max|y + ax|, bfloat16 (the
    kernel rounds each op to bfloat16, the plain version once) within one
    bfloat16 step, 1e-2."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    import elementalx.kernels.elementwise as jew

    monkeypatch.setattr(jew, "on_tpu", lambda: True)
    rng = np.random.default_rng(30)
    x = rng.standard_normal((16, 256)).astype(np.float32)
    y = rng.standard_normal((16, 256)).astype(np.float32)
    sq = rng.standard_normal((128, 256)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jy, jsq = (jnp.asarray(v, jdt) for v in (x, y, sq))
    tx, ty, tsq = (torch.tensor(v).to(tdt) for v in (x, y, sq))
    with pltpu.force_tpu_interpret_mode():
        refs = {"axpy": jew.axpy(0.75, jx, jy), "scale": jew.scale(-1.5, jx),
                "hadamard": jew.hadamard(jx, jy),
                "fill": jew.fill((16, 256), 2.5, jdt),
                "transpose": jew.transpose(jsq)}
    outs = {"axpy": axpby(0.75, tx, 1.0, ty), "scale": scale(-1.5, tx),
            "hadamard": hadamard(tx, ty),
            "fill": fill((16, 256), 2.5, tdt),
            "transpose": transpose(tsq)}
    for name, ref in refs.items():
        out = outs[name].float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        assert out.shape == ref.shape, name
        if name == "axpy":
            tol = 1e-6 if dtype == "float32" else 1e-2
            assert _rel(out, ref) <= tol
        else:
            np.testing.assert_array_equal(out, ref, err_msg=name)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_elementwise_plain_contract(dtype):
    """float64 and complex128 against numpy on ragged shapes and ``.mT``
    inputs (1e-15 relative: one or two roundings); every output is a new
    contiguous tensor."""
    rng = np.random.default_rng(31)

    def mk(*shape):
        a = rng.standard_normal(shape)
        if dtype == np.complex128:
            a = a + 1j * rng.standard_normal(shape)
        return a

    x, y, w = mk(7, 5), mk(7, 5), mk(5, 7)
    tx, ty, tw = torch.tensor(x), torch.tensor(y), torch.tensor(w).mT
    outs = [axpby(0.5, tx, -2.0, ty), scale(3.0, tw), hadamard(tx, tw),
            transpose(tw), transpose(tx, conjugate=True),
            fill((7, 5), 1.25, tx.dtype, extent=(4, 3))]
    refs = [-2.0 * y + 0.5 * x, 3.0 * w.T, x * w.T, w, x.conj().T,
            np.pad(np.full((4, 3), 1.25), ((0, 3), (0, 2)))]
    for out, ref in zip(outs, refs):
        assert out.is_contiguous()
        assert out.data_ptr() not in (tx.data_ptr(), ty.data_ptr(),
                                      tw.data_ptr())
        assert np.abs(out.numpy() - ref).max() <= 1e-15 * np.abs(ref).max()
    assert axpby(0.5, tx, -2.0, ty).dtype == ty.dtype
    assert fill((2, 3), 7.0, torch.float64).eq(7.0).all()


def test_elementwise_cpu_tensors_count_nothing():
    before = (axpby.launches, scale.launches, hadamard.launches,
              fill.launches, transpose.launches)
    a = torch.ones((4, 3))
    axpby(1.0, a, 1.0, a)
    scale(2.0, a)
    hadamard(a, a)
    fill((4, 3), 1.0, torch.float32, "cpu")
    transpose(a)
    assert (axpby.launches, scale.launches, hadamard.launches,
            fill.launches, transpose.launches) == before


_ROUNDING_CASES = {
    "tie-f32": 1 + 2 ** -24,          # halfway between two float32 values
    "tie-bf16": 1 + 2 ** -8,          # halfway between two bfloat16 values
    "tie-bf16-odd": 1 + 3 * 2 ** -8,  # the tie rounds up to even
    "double-rounding": 1 + 2 ** -8 + 2 ** -30,  # float32 first makes a tie
    "0.3": 0.3,
    "1/3": 1 / 3,
    "-1.7": -1.7,
    "subnormal-f32": 1e-40,
    "subnormal-tiny": 1e-45,
    "subnormal-f64": 5e-324,
    "negative-zero": -0.0,
    "max-bf16": 3.39e38,
    "rounds-to-inf-bf16": 3.4e38,
    "inf": float("inf"),
    "-inf": float("-inf"),
    "nan": float("nan"),
    "int": 3,
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("value", list(_ROUNDING_CASES.values()),
                         ids=list(_ROUNDING_CASES))
def test_k9_host_scalar_rounds_as_torch_full(dtype, value):
    """A Python-number alpha or beta goes to K9 by value, rounded on the
    host: it must equal what torch.full((), value, dtype=dtype) holds (the
    device scalar of the plain versions), bit for bit, NaN as NaN."""
    from elementalx_torch.kernels.elementwise import host_scalar

    ref = torch.full((), value, dtype=dtype)
    got = torch.tensor(host_scalar(value, dtype), dtype=torch.float64)
    got = got.to(dtype)
    if torch.isnan(ref):
        assert torch.isnan(got)
    else:
        bits = {torch.float32: torch.int32, torch.float64: torch.int64,
                torch.bfloat16: torch.int16}[dtype]
        assert got.view(bits).item() == ref.view(bits).item()


def test_k9_host_scalar_overflow_raises_as_torch_full():
    """float32 refuses a finite value beyond its range, as torch.full does;
    bfloat16 rounds it to inf, as torch.full does."""
    from elementalx_torch.kernels.elementwise import host_scalar

    with pytest.raises(RuntimeError):
        torch.full((), 1e300, dtype=torch.float32)
    with pytest.raises(RuntimeError):
        host_scalar(1e300, torch.float32)
    assert host_scalar(1e300, torch.bfloat16) == float("inf")


def test_gemm_orient_is_a_view_and_transpose_copies():
    """op(A) for Gemm and the level-3 updates is a strided view of A's
    data (K1 and K2 read it in place); level 1's Transpose and Adjoint
    write a new contiguous matrix, as Hydrogen's Transpose(A, B) does."""
    import elementalx_torch as Et
    from elementalx_torch.blas.gemm import _orient

    rng = np.random.default_rng(32)
    a = rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
    A = Et.DistMatrix.from_global(a, grid=Et.Grid("cpu"))
    for orient, ref in ((Et.TRANSPOSE, a.T), (Et.ADJOINT, a.conj().T)):
        V = _orient(A, orient)
        assert V.data.data_ptr() == A.data.data_ptr()
        assert (V.m, V.n) == (4, 6)
        np.testing.assert_array_equal(V.global_array(), ref)
    for T, ref in ((Et.Transpose(A), a.T), (Et.Adjoint(A), a.conj().T)):
        assert T.data.data_ptr() != A.data.data_ptr()
        assert T.data.is_contiguous() and (T.m, T.n) == (4, 6)
        np.testing.assert_array_equal(T.global_array(), ref)
    b = rng.standard_normal((6, 3)) + 1j * rng.standard_normal((6, 3))
    B = Et.DistMatrix.from_global(b, grid=Et.Grid("cpu"))
    P = Et.Gemm(Et.ADJOINT, Et.NORMAL, 1.0, A, B)
    np.testing.assert_allclose(P.global_array(), a.conj().T @ b,
                               rtol=1e-13)


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


def _operand(g, cuda, rows, cols, transposed, dt):
    """A rows x cols operand, row-major or the .mT view of a cols x rows
    one."""
    if transposed:
        return torch.randn((cols, rows), generator=g, device=cuda).to(dt).mT
    return torch.randn((rows, cols), generator=g, device=cuda).to(dt)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 128, 512), (1000, 1016, 1032)],
                         ids=["tiles", "ragged"])
@pytest.mark.parametrize("out_dt,rtol", [(torch.bfloat16, 1e-2),
                                         (torch.float32, 1e-4)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("ta", [False, True], ids=["A", "A.mT"])
@pytest.mark.parametrize("tb", [False, True], ids=["B", "B.mT"])
def test_matmul_wgmma_vs_plain(cuda, shape, out_dt, rtol, ta, tb):
    """K1's tensor-core core for every A/B majorness (TMA over each
    operand's own unit stride, wgmma's transpose bits for MN-major ones),
    ragged M, N and K with 16-byte rows. Tolerances, of max|C|: bf16
    output one bf16 step (1e-2); float32 output sums exact bf16 products
    in f32 in another order than cuBLAS, 1e-4 at K <= 16384."""
    from elementalx_torch.kernels.matmul import route

    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(20)
    a = _operand(g, cuda, M, K, ta, torch.bfloat16)
    b = _operand(g, cuda, K, N, tb, torch.bfloat16)
    assert route(a, b) == "wgmma"
    before = (matmul.launches, matmul.launches_wgmma)
    out = matmul(a, b, out_dtype=out_dt)
    ref = matmul_plain(a, b, out_dtype=out_dt)
    torch.cuda.synchronize()
    assert (matmul.launches, matmul.launches_wgmma) == (before[0] + 1,
                                                       before[1] + 1)
    assert out.dtype == out_dt and out.shape == (M, N)
    err = (out.double() - ref.double()).abs().max().item()
    assert err <= rtol * ref.double().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("out_dt", [torch.bfloat16, torch.float32])
def test_matmul_wgmma_k0_writes_zeros(cuda, out_dt):
    a = torch.empty((200, 0), dtype=torch.bfloat16, device=cuda)
    b = torch.empty((0, 300), dtype=torch.bfloat16, device=cuda)
    before = matmul.launches_wgmma
    out = matmul(a, b, out_dtype=out_dt)
    torch.cuda.synchronize()
    assert matmul.launches_wgmma == before + 1
    assert out.shape == (200, 300) and not out.abs().max().item()


@pytest.mark.cuda
def test_matmul_misaligned_bf16_takes_fma(cuda):
    """A bf16 operand whose rows are not 16-byte multiples (129 columns)
    or whose base is off 16 bytes cannot be read by the TMA: the FMA core
    takes it, and the answer is the same up to one bf16 step."""
    g = torch.Generator(device=cuda).manual_seed(21)
    full = torch.randn((257, 136), generator=g, device=cuda).bfloat16()
    b = torch.randn((129, 65), generator=g, device=cuda).bfloat16()
    for a in (full[:, :129].contiguous(), full[:, 1:130]):
        before = (matmul.launches_fma, matmul.launches_wgmma)
        out = matmul(a, b)
        ref = matmul_plain(a, b)
        torch.cuda.synchronize()
        assert (matmul.launches_fma, matmul.launches_wgmma) == (
            before[0] + 1, before[1])
        err = (out.double() - ref.double()).abs().max().item()
        assert err <= 1e-2 * ref.double().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8192, 768, 512), (1000, 780, 1004),
                                   (300, 36, 200), (64, 0, 24),
                                   (1000, 777, 1001), (2000, 777, 2001),
                                   (257, 129, 65)],
                         ids=["history", "ragged", "K36", "K0",
                              "misaligned", "misaligned-128-tiles",
                              "misaligned-odd"])
@pytest.mark.parametrize("ta", [False, True], ids=["A", "A.mT"])
@pytest.mark.parametrize("tb", [False, True], ids=["B", "B.mT"])
def test_matmul_fma_async_equals_fma_core(cuda, shape, ta, tb):
    """float32 on the cp.async pipeline runs the FMA core's arithmetic:
    each C entry one fma chain over k in order, so the two cores agree bit
    for bit: ragged shapes with 16-byte rows (16-byte copies), rows of 777
    or 129 floats (4-byte copies), on 64 x 128 tiles where 128 x 128 ones
    give fewer blocks than SMs and on 128 x 128 ones otherwise."""
    from elementalx_torch.kernels.matmul import _launch, route

    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(22)
    a = _operand(g, cuda, M, K, ta, torch.float32)
    b = _operand(g, cuda, K, N, tb, torch.float32)
    assert route(a, b) == "fma_async"
    before = matmul.launches_fma_async
    out = matmul(a, b)
    ref = _launch("fma", a, b, torch.float32)
    torch.cuda.synchronize()
    assert matmul.launches_fma_async == before + 1
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 512, 1024), (1000, 780, 1004),
                                   (1000, 777, 1001), (257, 129, 65),
                                   (300, 36, 200), (64, 0, 24),
                                   (3000, 129, 2001)],
                         ids=["tiles", "ragged", "rows-of-777",
                              "odd-small", "K36", "K0", "odd-128-tiles"])
@pytest.mark.parametrize("ta", [False, True], ids=["A", "A.mT"])
@pytest.mark.parametrize("tb", [False, True], ids=["B", "B.mT"])
def test_matmul_dmma_vs_plain(cuda, shape, ta, tb):
    """float64 on the FP64 tensor cores against matmul_plain: within
    1e-12 of max|C| (the tensor cores' sums over k in another order than
    cuBLAS's), ragged M, N and K, every majorness, 16-byte copies where
    the rows allow them and 8-byte ones for rows of an odd number of
    doubles, 64 x 128 tiles where 128 x 128 ones give fewer blocks than
    SMs; two runs give the same bits; K = 0 writes zeros."""
    from elementalx_torch.kernels.matmul import route

    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(24)
    a = _operand(g, cuda, M, K, ta, torch.float64)
    b = _operand(g, cuda, K, N, tb, torch.float64)
    assert route(a, b) == "dmma"
    before = (matmul.launches, matmul.launches_dmma, matmul.launches_fma)
    out = matmul(a, b)
    again = matmul(a, b)
    ref = matmul_plain(a, b)
    torch.cuda.synchronize()
    assert (matmul.launches, matmul.launches_dmma,
            matmul.launches_fma) == (before[0] + 2, before[1] + 2, before[2])
    assert out.shape == (M, N) and out.dtype == torch.float64
    assert torch.equal(out, again)
    err = (out - ref).abs().max().item()
    assert err <= 1e-12 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["history-B.mH", "odd-base-A",
                                  "odd-base-B"])
def test_matmul_dmma_views(cuda, view):
    """The float64 Cholesky's history product hist @ row.mH (rows of an
    n x n buffer, read in place), operands whose base is off 16 bytes
    (8-byte copies): within 1e-12 of max|C|, the same bits twice, one
    launch each on the FP64 tensor cores."""
    from elementalx_torch.kernels.matmul import narrow_copies, route

    g = torch.Generator(device=cuda).manual_seed(25)
    buf = torch.randn((2048, 2048), generator=g, device=cuda,
                      dtype=torch.float64)
    a, b = buf[1024:, :768], buf[1024:1536, :768].mH
    if view == "odd-base-A":
        a, b = buf[:900, 1:701], buf[1000:1700, :500]
    elif view == "odd-base-B":
        a, b = buf[:900, :700], buf[1000:1700, 3:504]
    assert route(a, b) == "dmma"
    assert narrow_copies(a, b) == view.startswith("odd")
    before = matmul.launches_dmma
    out, again = matmul(a, b), matmul(a, b)
    assert matmul.launches_dmma == before + 2
    ref = matmul_plain(a, b)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert (out - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (M, K, N, dtype, A layout), A: "rows", "mT" (A.mT), "slice" (a
    # column slice of a wider buffer), "odd" (rows of 777, an odd base)
    (8192, 128, 2, torch.float32, "slice"),
    (8192, 8192, 4, torch.float32, "rows"),
    (16384, 2048, 2, torch.float32, "rows"),
    (64, 100000, 3, torch.float32, "rows"),
    (3000, 40000, 5, torch.float32, "mT"),
    (1000, 777, 16, torch.float32, "odd"),
    (128, 126, 2, torch.float32, "odd"),
    (5, 7, 1, torch.float32, "rows"),
    (64, 0, 16, torch.float32, "rows"),
    (2048, 3000, 16, torch.float64, "rows"),
    (300, 50, 5, torch.float64, "mT"),
    (40, 70000, 7, torch.float64, "odd"),
], ids=["summa-c", "summa-a", "summa-b", "split", "mT-split", "odd-N16",
        "latrd", "tiny", "K0", "f64-N16", "f64-mT", "f64-odd-split"])
def test_matmul_skinny_vs_plain(cuda, case):
    """K1's skinny route against matmul_plain: float32 within 1e-5 of
    max|C| (FP32 sums in another order), float64 within 1e-12; B's rows
    8 bytes apart where N = 2, as in the dist step; two runs give the same
    bits (fixed sums, no atomics)."""
    from elementalx_torch.kernels.matmul import route

    M, K, N, dt, lay = case
    g = torch.Generator(device=cuda).manual_seed(23)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dt)

    if lay == "slice":
        a = rnd(M, 4 * K)[:, K:2 * K]
    elif lay == "mT":
        a = rnd(K, M).mT
    elif lay == "odd":
        a = rnd(M, K + 1)[:, 1:]
    else:
        a = rnd(M, K)
    b = rnd(3 * K, N)[K:2 * K]
    assert route(a, b) == "skinny"
    before = (matmul.launches, matmul.launches_skinny)
    out = matmul(a, b)
    again = matmul(a, b)
    ref = matmul_plain(a, b)
    torch.cuda.synchronize()
    assert (matmul.launches, matmul.launches_skinny) == (before[0] + 2,
                                                        before[1] + 2)
    assert out.shape == (M, N) and out.dtype == dt
    assert torch.equal(out, again)
    rtol = 1e-5 if dt == torch.float32 else 1e-12
    err = (out.double() - ref.double()).abs().max().item()
    assert err <= rtol * max(ref.double().abs().max().item(), 1.0)


@pytest.mark.cuda
def test_matmul_kernel_refuses_complex(cuda):
    a = torch.ones((4, 4), dtype=torch.complex64, device=cuda)
    with pytest.raises(NotImplementedError):
        matmul(a, a)


_K3_WIDTHS = [1, 33, 200, 512, 513, 2048]


def _k3_block(cuda, w, dt, seed=1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((w, w), generator=g, device=cuda, dtype=torch.float64)
    return (x @ x.mT / w + 2 * torch.eye(w, device=cuda,
                                         dtype=torch.float64)).to(dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("w", _K3_WIDTHS)
def test_potrf_kernel_vs_plain(cuda, w, dt):
    """K3a on route()'s choice. Tolerance: 1e-5 (float32) / 1e-12
    (float64) of the largest entry; the blocks have condition number
    below 3."""
    k3 = importlib.import_module("elementalx_torch.kernels.potrf")

    s = _k3_block(cuda, w, dt)
    rt = k3.route(w, dt)
    before = (potrf_block_inv.launches,
              getattr(potrf_block_inv, f"launches_{rt}"))
    l11, inv_lh = potrf_block_inv(s)
    l_ref, inv_ref = potrf_block_inv_plain(s)
    torch.cuda.synchronize()
    assert (potrf_block_inv.launches,
            getattr(potrf_block_inv, f"launches_{rt}")) == \
        (before[0] + 1, before[1] + 1)
    rtol = 1e-5 if dt == torch.float32 else 1e-12
    for out, ref in ((l11, l_ref), (inv_lh, inv_ref)):
        assert (out - ref).abs().max().item() <= rtol * ref.abs().max().item()
    assert l11.triu(1).abs().max().item() == 0.0
    assert inv_lh.tril(-1).abs().max().item() == 0.0
    bad_l, bad_inv = potrf_block_inv(-s)
    assert bool(bad_l.isnan().all()) and bool(bad_inv.isnan().all())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("w", _K3_WIDTHS)
@pytest.mark.parametrize("rt", ["cluster", "blocked", "steps"])
def test_potrf_routes_vs_plain(cuda, rt, w, dt):
    """Each K3a route against the plain version (tolerances as above):
    exact zeros outside the triangles, NaN in both outputs for a block
    that is not positive definite (also one whose trouble is in its last
    32-column step, or in its last block on the blocked route), and the
    same bits on a second run."""
    k3 = importlib.import_module("elementalx_torch.kernels.potrf")

    s = _k3_block(cuda, w, dt, seed=w)
    if rt == "cluster" and w > k3.CLUSTER_MAX_W[dt]:
        with pytest.raises(ValueError):
            k3._launch(rt, s)
        return
    l11, inv_lh = k3._launch(rt, s)
    l_ref, inv_ref = potrf_block_inv_plain(s)
    again = k3._launch(rt, s)
    torch.cuda.synchronize()
    rtol = 1e-5 if dt == torch.float32 else 1e-12
    for out, ref in ((l11, l_ref), (inv_lh, inv_ref)):
        assert (out - ref).abs().max().item() <= rtol * ref.abs().max().item()
    assert l11.triu(1).abs().max().item() == 0.0
    assert inv_lh.tril(-1).abs().max().item() == 0.0
    assert torch.equal(again[0], l11) and torch.equal(again[1], inv_lh)
    late = s.clone()
    late[-1, -1] = -1.0  # positive definite but for the last pivot
    for bad in (-s, late):
        bad_l, bad_inv = k3._launch(rt, bad)
        torch.cuda.synchronize()
        assert bool(bad_l.isnan().all()) and bool(bad_inv.isnan().all())
    # the flags are left zero: a good block after a bad one is not poisoned
    l2, _ = k3._launch(rt, s)
    torch.cuda.synchronize()
    assert torch.equal(l2, l11)


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
    (16384, 512, torch.float32), (16384, 512, torch.float64),
    (33, 33, torch.float64),
    (70, 3, torch.float64), (512, 512, torch.float32),
    # more rows than threads per CTA; a row share too big for shared memory
    (40000, 64, torch.float32), (120000, 32, torch.float64),
])
def test_getrf_kernel_vs_plain(cuda, Mt, w, dt):
    """K4 against torch.linalg.lu_factor on the card, on the route
    ``route`` gives the shape (its counter checked). Checked in float64:
    lperm a permutation, max|P A - L U| <= tol max|A| (float32: 1e-5,
    about 100 eps for rows of 512 Gaussian entries; float64: 1e-13) and
    |L| <= 1 + tol. float64 pivots are identical to the plain version's;
    float32 ones may differ on near-ties and are not compared."""
    k4 = importlib.import_module("elementalx_torch.kernels.getrf")

    g = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn((Mt, w), generator=g, device=cuda,
                    dtype=torch.float64).to(dt)
    rt = k4.route(Mt, dt)
    before = getrf_panel.launches
    on_route = getattr(getrf_panel, f"launches_{rt}")
    out, piv = getrf_panel(a)
    pk, lp = packed_getrf(a)
    torch.cuda.synchronize()
    assert getrf_panel.launches == before + 2
    assert getattr(getrf_panel, f"launches_{rt}") == on_route + 2
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
@pytest.mark.parametrize("Mt,w,dt", [
    (16384, 512, torch.float32), (4096, 512, torch.float64),
    (1000, 200, torch.float32), (70, 3, torch.float64),
])
def test_getrf_routes_agree_bit_for_bit(cuda, Mt, w, dt):
    """Both routes give every entry the same operations in the same order
    (the group's eliminations, the forward substitution, the rank-32
    update on K1's pipeline or FMA core, which agree bit for bit), so the
    cluster route's factor and pivots equal the grid route's bit for bit,
    and a cluster of another size gives the same bits too."""
    k4 = importlib.import_module("elementalx_torch.kernels.getrf")

    g = torch.Generator(device=cuda).manual_seed(4)
    a = torch.randn((Mt, w), generator=g, device=cuda,
                    dtype=torch.float64).to(dt)
    oc, pc = k4._launch("cluster", a)
    og, pg = k4._launch("grid", a)
    ctas = k4.cluster_ctas(Mt, dt)
    other = ctas * 2 if ctas < 16 and k4.cluster_ctas(Mt, dt) else ctas
    o2, p2 = k4._launch("cluster", a, other)
    torch.cuda.synchronize()
    assert torch.equal(pc, pg) and torch.equal(oc, og)
    assert torch.equal(p2, pc) and torch.equal(o2, oc)


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
@pytest.mark.parametrize("M,k0,w,dt", [
    (8192, 0, 128, torch.float32), (8192, 4096, 128, torch.float32),
    (1000, 37, 100, torch.float32), (2048, 0, 128, torch.float64),
    (1001, 3, 64, torch.float32), (999, 1, 50, torch.float64),
])
def test_latrd_on_symv_tiles_at_path_shapes(cuda, M, k0, w, dt):
    """K5 at chip_smoke's phase-7 shapes (its symv on K7's TMA tiles), and
    at orders whose rows are not 16-byte multiples apart (read from a copy
    with padded rows): P, W and tau within 1e-4 (float32: symvs over up to
    8192 terms in another order, compounded over 128 columns) / 1e-10
    (float64) of max|plain|, and the same bits on a second run."""
    g = torch.Generator(device=cuda).manual_seed(42)
    x = torch.randn((M, M), generator=g, device=cuda, dtype=torch.float64)
    a = ((x + x.mT) / 2).to(dt)
    del x
    out = latrd_panel(a, k0, w, 128)
    again = latrd_panel(a, k0, w, 128)
    ref = latrd_panel_plain(a, k0, w, 128)
    torch.cuda.synchronize()
    rtol = 1e-4 if dt == torch.float32 else 1e-10
    for o, o2, r in zip(out, again, ref):
        assert (o - r).abs().max().item() <= rtol * r.abs().max().item()
        assert torch.equal(o, o2)


@pytest.mark.cuda
@pytest.mark.parametrize("M,k0,w,nb,dt", [
    (300, 200, 98, 128, torch.float64), (258, 0, 128, 128, torch.float32),
    (130, 0, 128, 128, torch.float64), (16384, 8000, 32, 32, torch.float32),
    (777, 5, 64, 64, torch.float32), (4099, 1, 127, 128, torch.float64),
], ids=["few-rows-f64", "m0-below-grid", "whole-matrix-f64", "wide-M-nb32",
        "odd-nb64", "f64-odd-offset"])
def test_latrd_kernel_schedule_edges(cuda, M, k0, w, nb, dt):
    """K5's column schedule where it is thin: fewer trailing rows than
    blocks, panels narrower than 128, a tall trailing block, an odd k0
    that shifts the tiles: P, W and tau within 1e-4 (float32) / 1e-10
    (float64) of max|plain|, and the same bits on a second run (units
    handed out by a counter change no bit)."""
    g = torch.Generator(device=cuda).manual_seed(43)
    x = torch.randn((M, M), generator=g, device=cuda, dtype=torch.float64)
    a = ((x + x.mT) / 2).to(dt)
    del x
    out = latrd_panel(a, k0, w, nb)
    again = latrd_panel(a, k0, w, nb)
    ref = latrd_panel_plain(a, k0, w, nb)
    torch.cuda.synchronize()
    rtol = 1e-4 if dt == torch.float32 else 1e-10
    for o, o2, r in zip(out, again, ref):
        assert o.shape == r.shape
        assert (o - r).abs().max().item() <= rtol * r.abs().max().item()
        assert torch.equal(o, o2)


@pytest.mark.cuda
def test_latrd_kernel_whole_matrix_f32_near_f64(cuda):
    """K5 on a float32 panel that reduces the whole matrix (M=130, k0=0,
    w=128), where float32 loses digits to cancellation: P, W and tau each
    no farther from the float64 panel of the same input than twice the
    plain version's float32 distance from it."""
    g = torch.Generator(device=cuda).manual_seed(43)
    x = torch.randn((130, 130), generator=g, device=cuda, dtype=torch.float64)
    a = ((x + x.mT) / 2).float()
    out = latrd_panel(a, 0, 128, 128)
    plain = latrd_panel_plain(a, 0, 128, 128)
    ref = latrd_panel_plain(a.double(), 0, 128, 128)
    torch.cuda.synchronize()
    for name, o, p, r in zip(("P", "W", "tau"), out, plain, ref):
        kernel_err = (o.double() - r).abs().max().item()
        plain_err = (p.double() - r).abs().max().item()
        print(f"K5 (130, 0, 128) f32 {name}: max|kernel - f64| "
              f"{kernel_err:.3e}, max|plain - f64| {plain_err:.3e}, "
              f"max|f64| {r.abs().max().item():.3e}")
        assert kernel_err <= 2 * plain_err


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
                                 (1024, 128), (513, 256), (101, 3),
                                 (700, 512)])
def test_sb2tr_kernel_vs_plain_f64(cuda, n, b):
    """K6 in float64 against the sequential plain chase on the route
    ``route`` gives b (b=512 in float64: the l2 route; the others the
    cluster route), its counter checked: the same ops, so vout, d and e
    agree to float64 rounding (1e-9 of the band's largest entry); a
    second run gives the same bits."""
    k6 = importlib.import_module("elementalx_torch.kernels.sb2tr")

    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((n, n), generator=g, device=cuda, dtype=torch.float64)
    i = torch.arange(n, device=cuda)
    ab = torch.where((i[:, None] - i[None, :]).abs() <= b, (x + x.mT) / 2,
                     torch.zeros((), dtype=torch.float64, device=cuda))
    rt = k6.route(b, torch.float64)
    before = sb2tr.launches
    on_route = getattr(sb2tr, f"launches_{rt}")
    v, d, e = sb2tr(ab, b)
    v2, d2, e2 = sb2tr(ab, b)
    vp, dp, ep = sb2tr_plain(ab, b)
    torch.cuda.synchronize()
    assert sb2tr.launches == before + 2
    assert getattr(sb2tr, f"launches_{rt}") == on_route + 2
    tol = 1e-9 * ab.abs().max().item()
    assert (v - vp).abs().max().item() <= tol
    assert (d - dp).abs().max().item() <= tol
    assert (e - ep).abs().max().item() <= tol
    assert torch.equal(v, v2) and torch.equal(d, d2) and torch.equal(e, e2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,ctas", [(256, 16), (128, 2), (128, 8),
                                    (16, 2)])
def test_sb2tr_cluster_sizes_and_l2_route(cuda, b, ctas):
    """The cluster route at another cluster size than ``cluster_size``
    and the l2 route on the same float64 band, each within 1e-9 max|A|
    of the plain chase (the sums run in other orders)."""
    k6 = importlib.import_module("elementalx_torch.kernels.sb2tr")

    n = 600
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((n, n), generator=g, device=cuda, dtype=torch.float64)
    i = torch.arange(n, device=cuda)
    ab = torch.where((i[:, None] - i[None, :]).abs() <= b, (x + x.mT) / 2,
                     torch.zeros((), dtype=torch.float64, device=cuda))
    ref = sb2tr_plain(ab, b)
    tol = 1e-9 * ab.abs().max().item()
    for out in (k6._launch("cluster", ab, b, ctas), k6._launch("l2", ab, b)):
        torch.cuda.synchronize()
        assert max((x - y).abs().max().item()
                   for x, y in zip(out, ref)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(1000, 16), (2048, 128), (2048, 256)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (M, K, N, lower, dtype, transposed A, rtol)
    (1000, 777, 1001, True, torch.float32, False, 1e-5),
    (1000, 777, 1001, False, torch.float32, True, 1e-5),
    (700, 300, 500, True, torch.float32, True, 1e-5),
    (300, 64, 300, False, torch.float64, False, 1e-12),
    (257, 129, 257, True, torch.bfloat16, False, 1e-2),
    (1, 3, 1, True, torch.float32, False, 1e-5),
])
def test_masked_rank_k_kernel_vs_plain(cuda, case):
    """K2 against its plain version (addmm-style product + where):
    1e-5 of max|C| in float32, 1e-12 in float64, one bf16 step for
    bfloat16; entries off the triangle equal C bit for bit."""
    M, K, N, lower, dt, ta, rtol = case
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn((K, M) if ta else (M, K), generator=g, device=cuda)
    a = (a.mT if ta else a).to(dt)
    b = torch.randn((K, N), generator=g, device=cuda).to(dt)
    c = torch.randn((M, N), generator=g, device=cuda).to(dt)
    before = masked_rank_k.launches
    out = masked_rank_k(lower, -1.0, a, b, 0.5, c)
    ref = masked_rank_k_plain(lower, -1.0, a, b, 0.5, c)
    torch.cuda.synchronize()
    assert masked_rank_k.launches == before + 1
    err = (out.double() - ref.double()).abs().max().item()
    assert err <= rtol * max(ref.double().abs().max().item(), 1.0)
    i = torch.arange(M, device=cuda)[:, None]
    j = torch.arange(N, device=cuda)[None, :]
    off = (j > i) if lower else (j < i)
    assert torch.equal(out[off], c[off])


@pytest.mark.cuda
def test_masked_rank_k_kernel_nan_and_complex(cuda):
    """beta = 0 with NaN in C gives NaN on the triangle, as in JAX; a
    complex tensor raises."""
    a = torch.ones((64, 8), device=cuda)
    c = torch.full((64, 64), float("nan"), device=cuda)
    out = masked_rank_k(True, 1.0, a, a.mT, 0.0, c)
    torch.cuda.synchronize()
    assert bool(out.isnan().all())
    z = torch.ones((4, 4), dtype=torch.complex64, device=cuda)
    with pytest.raises(NotImplementedError):
        masked_rank_k(True, 1.0, z, z, 0.0, z)


@pytest.mark.cuda
@pytest.mark.parametrize("Mt,w,low,dt", [
    (300, 64, False, torch.float32), (1000, 200, False, torch.float32),
    (1024, 256, True, torch.float32), (64, 64, False, torch.float32),
    (500, 96, False, torch.float64), (40, 1, False, torch.float32),
    (4096, 512, False, torch.float32), (4096, 512, True, torch.float32),
    (3000, 513, False, torch.float32), (4096, 2048, True, torch.float32),
    (2000, 400, False, torch.float64), (1000, 384, False, torch.float64),
])
def test_potrf_panel_tail_kernel_vs_plain(cuda, Mt, w, low, dt):
    """K3b on route()'s choice against its plain version: L11 equal to
    K3a's bit for bit; L21 within 1e-5 of max|L| (float32), 1e-12
    (float64), 5e-4 with low_apply (bf16 operands rounded from two
    inverses that differ in float32 rounding), and then more than ten
    times that error away from K3b without low_apply (so the rounding is
    really done); a block that is not positive definite gives NaN
    everywhere."""
    k3 = importlib.import_module("elementalx_torch.kernels.potrf")

    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((w, w), generator=g, device=cuda, dtype=torch.float64)
    sym = (x @ x.mT / w + 2 * torch.eye(w, device=cuda,
                                        dtype=torch.float64)).to(dt)
    pan = torch.randn((Mt, w), generator=g, device=cuda).to(dt)
    pan[:w] = float("nan")  # rows of the diagonal block are never read
    rt = k3.route(w, dt)
    before = (potrf_panel_tail.launches,
              getattr(potrf_panel_tail, f"launches_{rt}"))
    out = potrf_panel_tail(sym, pan, low_apply=low)
    ref = potrf_panel_tail_plain(sym, pan, low_apply=low)
    l11, _ = potrf_block_inv(sym)
    torch.cuda.synchronize()
    assert (potrf_panel_tail.launches,
            getattr(potrf_panel_tail, f"launches_{rt}")) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(out[:w], l11)
    rtol = 5e-4 if low else (1e-12 if dt == torch.float64 else 1e-5)
    if Mt > w:
        err = (out[w:] - ref[w:]).abs().max().item()
        assert err <= rtol * ref[w:].abs().max().item()
        if low:
            unrounded = potrf_panel_tail(sym, pan)
            torch.cuda.synchronize()
            assert (out[w:] - unrounded[w:]).abs().max().item() > 10 * err
    bad = potrf_panel_tail(-sym, pan)
    torch.cuda.synchronize()
    assert bool(bad.isnan().all())


@pytest.mark.cuda
@pytest.mark.parametrize("Mt,w,dt", [
    (1000, 200, torch.float32), (2100, 512, torch.float32),
    (700, 33, torch.float64), (2000, 600, torch.float32),
    (900, 400, torch.float64)])
@pytest.mark.parametrize("rt", ["cluster", "blocked", "grid"])
def test_potrf_panel_tail_routes_vs_plain(cuda, rt, Mt, w, dt):
    """Each K3b route against the plain version (tolerances as above), with
    strided panel views, the same bits on a second run, L11 equal to K3a's
    on the same route (cluster and blocked), and NaN in every row for a
    block that is not positive definite."""
    k3 = importlib.import_module("elementalx_torch.kernels.potrf")

    g = torch.Generator(device=cuda).manual_seed(w)
    x = torch.randn((w, w), generator=g, device=cuda, dtype=torch.float64)
    sym = (x @ x.mT / w + 2 * torch.eye(w, device=cuda,
                                        dtype=torch.float64)).to(dt)
    if rt == "cluster" and w > k3.CLUSTER_MAX_W[dt]:
        with pytest.raises(ValueError):
            k3._tail_launch(rt, sym, sym, 0, False)
        return
    wide = torch.randn((Mt, w + 8), generator=g, device=cuda).to(dt)
    pan = wide[:, 3:3 + w]  # rows w + 8 apart, an odd offset
    out = k3._tail_launch(rt, sym, pan, 0, False)
    again = k3._tail_launch(rt, sym, pan, 0, False)
    ref = potrf_panel_tail_plain(sym, pan)
    torch.cuda.synchronize()
    rtol = 1e-12 if dt == torch.float64 else 1e-5
    assert (out - ref).abs().max().item() <= rtol * ref.abs().max().item()
    assert torch.equal(out, again)
    if rt != "grid":
        l11, _ = k3._launch(rt, sym)
        torch.cuda.synchronize()
        assert torch.equal(out[:w], l11)
    bad = k3._tail_launch(rt, -sym, pan, 0, False)
    torch.cuda.synchronize()
    assert bool(bad.isnan().all())


@pytest.mark.cuda
@pytest.mark.parametrize("kidx", [0, 1, 3])
def test_potrf_panel_tail_full_kernel_matches_tail(cuda, kidx):
    """K3c(pan_full, k)[k w:] equals K3b(pan_full[k w:]) bit for bit, with
    exact zeros above."""
    w, M = 128, 512
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((w, w), generator=g, device=cuda)
    sym = x @ x.mT / w + 2 * torch.eye(w, device=cuda)
    pan = torch.randn((M, w), generator=g, device=cuda)
    before = potrf_panel_tail_full.launches
    out = potrf_panel_tail_full(sym, pan, kidx)
    ref = potrf_panel_tail(sym, pan[kidx * w:])
    torch.cuda.synchronize()
    assert potrf_panel_tail_full.launches == before + 1
    assert torch.equal(out[kidx * w:], ref)
    assert not bool(out[:kidx * w].any())


@pytest.mark.cuda
@pytest.mark.parametrize("n,dt", [(1, torch.float32), (37, torch.float64),
                                  (1000, torch.float32),
                                  (2500, torch.float64)])
def test_symv_kernel_vs_plain(cuda, n, dt):
    """K7 with NaN in the strict upper triangle against the plain version
    on the clean matrix: 1e-5 (float32, sums in another order) or 1e-12
    (float64) of max|y|; the same bits on a second run; the trailing
    form at k0 = n // 3."""
    g = torch.Generator(device=cuda).manual_seed(4)
    A = torch.randn((n, n), generator=g, device=cuda).to(dt)
    v = torch.randn((n,), generator=g, device=cuda).to(dt)
    An = A.clone()
    iu = torch.triu_indices(n, n, 1, device=cuda)
    An[iu[0], iu[1]] = float("nan")
    before = symv_lower.launches
    y = symv_lower(An, v)
    y2 = symv_lower(An, v)
    ref = symv_lower_plain(A, v)
    torch.cuda.synchronize()
    assert symv_lower.launches == before + 2
    rtol = 1e-5 if dt == torch.float32 else 1e-12
    assert (y - ref).abs().max().item() <= rtol * ref.abs().max().item()
    assert torch.equal(y, y2)
    k0 = n // 3
    yt = symv_lower_trailing(An, v[k0:], k0)
    rt = symv_lower_plain(A[k0:, k0:], v[k0:])
    assert (yt - rt).abs().max().item() <= rtol * rt.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k0,pad,dt", [
    (1, 0, 0, torch.float32), (1, 0, 3, torch.float32),
    (31, 0, 0, torch.float32), (31, 0, 1, torch.float32),
    (1000, 0, 0, torch.float32), (1025, 0, 0, torch.float32),
    (1025, 37, 0, torch.float32), (16384, 0, 0, torch.float32),
    (16384, 5000, 0, torch.float32), (16384, 37, 0, torch.float32),
    (1000, 37, 4, torch.float32), (1000, 0, 1, torch.float32),
    (1025, 37, 3, torch.float32), (1025, 0, 1, torch.float64),
    (1024, 37, 0, torch.float64), (1000, 5, 1, torch.float64),
])
def test_symv_cores_vs_plain(cuda, n, k0, pad, dt):
    """K7 on the trailing block a[k0:, k0:] of an n x (n + pad) buffer with
    NaN above the diagonal, on the core route() picks (TMA tiles for a row
    stride of 16-byte multiples, the cp.async ring otherwise), against the
    plain version on the clean matrix: 1e-5 (float32, sums of n terms in
    another order) or 1e-12 (float64) of max|y|; NaN never reaches y; a
    second run gives the same bits; the launch is counted on its core."""
    from elementalx_torch.kernels.symv import route

    g = torch.Generator(device=cuda).manual_seed(40)
    buf = torch.randn((n, n + pad), generator=g, device=cuda).to(dt)
    A = buf[:, :n]
    v = torch.randn((n - k0,), generator=g, device=cuda).to(dt)
    ref = symv_lower_plain(A[k0:, k0:], v)
    iu = torch.triu_indices(n, n, 1, device=cuda)
    A[iu[0], iu[1]] = float("nan")
    del iu
    core = route(A[k0:, k0:])
    assert core == ("tma" if (n + pad) * buf.element_size() % 16 == 0
                    else "async")
    before = getattr(symv_lower, f"launches_{core}")
    y = symv_lower_trailing(A, v, k0)
    y2 = symv_lower_trailing(A, v, k0)
    torch.cuda.synchronize()
    assert getattr(symv_lower, f"launches_{core}") == before + 2
    rtol = 1e-5 if dt == torch.float32 else 1e-12
    assert bool(torch.isfinite(y).all())
    assert (y - ref).abs().max().item() <= rtol * ref.abs().max().item()
    assert torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("n,pad,dt", [
    (1, 1, torch.float32), (31, 0, torch.float32), (1000, 1, torch.float32),
    (1025, 2, torch.float32), (16383, 0, torch.float32),
    (37, 0, torch.float64), (1001, 0, torch.float64),
])
def test_symv_async_equals_tma_on_aligned_copy(cuda, n, pad, dt):
    """At k0 = 0, on a matrix whose base is 16-byte aligned and whose rows
    are not 16-byte multiples apart, the cp.async core takes the TMA
    core's tiles, walk and sums: y equals, bit for bit, the TMA core's y
    on a copy of A whose rows are 16-byte multiples apart (NaN above the
    diagonal in both, and in the copy's padding); NaN never reaches y."""
    from elementalx_torch.kernels.symv import route

    g = torch.Generator(device=cuda).manual_seed(42)
    A = torch.randn((n, n + pad), generator=g, device=cuda).to(dt)[:, :n]
    v = torch.randn((n,), generator=g, device=cuda).to(dt)
    iu = torch.triu_indices(n, n, 1, device=cuda)
    A[iu[0], iu[1]] = float("nan")
    per = 16 // A.element_size()
    copy = torch.full((n, -(-n // per) * per), float("nan"), device=cuda,
                      dtype=dt)[:, :n]
    copy.copy_(A)
    assert (route(A), route(copy)) == ("async", "tma")
    before = (symv_lower.launches_async, symv_lower.launches_tma)
    y = symv_lower(A, v)
    y_tma = symv_lower(copy, v)
    torch.cuda.synchronize()
    assert (symv_lower.launches_async, symv_lower.launches_tma) == (
        before[0] + 1, before[1] + 1)
    assert bool(torch.isfinite(y).all())
    assert torch.equal(y, y_tma)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_symv_unit_core_still_runs(cuda, dt):
    """The first design ("unit"), which no route takes any more, still
    runs through _launch: against the plain version within 1e-5 (float32)
    or 1e-12 (float64) of max|y|, NaN above the diagonal kept out of y."""
    from elementalx_torch.kernels.symv import _launch

    g = torch.Generator(device=cuda).manual_seed(43)
    A = torch.randn((1001, 1001), generator=g, device=cuda).to(dt)
    v = torch.randn((1001,), generator=g, device=cuda).to(dt)
    ref = symv_lower_plain(A, v)
    iu = torch.triu_indices(1001, 1001, 1, device=cuda)
    A[iu[0], iu[1]] = float("nan")
    y = _launch("unit", A, v)
    torch.cuda.synchronize()
    rtol = 1e-5 if dt == torch.float32 else 1e-12
    assert (y - ref).abs().max().item() <= rtol * ref.abs().max().item()


@pytest.mark.cuda
def test_symv_tma_core_equals_itself_across_calls_and_workspace(cuda):
    """The TMA core's cached partial-y workspace is reused from call to
    call: a call at a larger order and then at a smaller one again gives
    the same bits as before."""
    from elementalx_torch.kernels.symv import _launch

    g = torch.Generator(device=cuda).manual_seed(41)
    A = torch.randn((3000, 3000), generator=g, device=cuda)
    v = torch.randn((3000,), generator=g, device=cuda)
    y1 = _launch("tma", A[:1000, :1000], v[:1000])
    _launch("tma", A, v)
    y2 = _launch("tma", A[:1000, :1000], v[:1000])
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.cuda
def test_symv_kernel_refuses_complex(cuda):
    z = torch.ones((4, 4), dtype=torch.complex64, device=cuda)
    with pytest.raises(NotImplementedError):
        symv_lower(z, z[0])


@pytest.mark.cuda
def test_fused_tail_cholesky_on_card(cuda, monkeypatch):
    """Cholesky at n=1024 (blocksize 128) with ELX_PALLAS_POTRF=1: eight
    K3b launches, no K3a, and the factor the CPU's plain path gives to
    1e-5 of max|L|."""
    import elementalx_torch as Et
    from elementalx_torch.entry import make_hpd_problem

    monkeypatch.setenv("ELX_PALLAS_POTRF", "1")
    a, _ = make_hpd_problem(1024, 1, device=cuda, seed=5)
    before = (potrf_panel_tail.launches, potrf_block_inv.launches)
    L = Et.Cholesky(Et.LOWER, Et.DistMatrix.from_global(a, grid=Et.Grid(cuda)),
                    blocksize=128)
    torch.cuda.synchronize()
    assert (potrf_panel_tail.launches - before[0],
            potrf_block_inv.launches - before[1]) == (8, 0)
    ref = Et.Cholesky(Et.LOWER, Et.DistMatrix.from_global(
        a.cpu(), grid=Et.Grid("cpu")), blocksize=128)
    err = (L.data.cpu() - ref.data).abs().max().item()
    assert err <= 1e-5 * ref.data.abs().max().item()


@pytest.mark.cuda
def test_herk_and_symv_on_card_launch_k2_k7(cuda):
    """The public Herk runs on one K2 launch, Her2k on two, Symv (LOWER,
    one column) on one K7 launch; each matches the CPU to 1e-5."""
    import elementalx_torch as Et

    g = torch.Generator(device=cuda).manual_seed(6)
    a = torch.randn((700, 130), generator=g, device=cuda)
    c = torch.randn((700, 700), generator=g, device=cuda)
    x = torch.randn((700, 1), generator=g, device=cuda)
    grid, cpu = Et.Grid(cuda), Et.Grid("cpu")

    def both(t):
        return (Et.DistMatrix.from_global(t, grid=grid),
                Et.DistMatrix.from_global(t.cpu(), grid=cpu))

    (A, Ac), (C, Cc), (X, Xc) = both(a), both(c), both(x)
    k2, k7 = masked_rank_k.launches, symv_lower.launches
    H = Et.Herk(Et.LOWER, Et.NORMAL, -1.0, A, beta=1.0, C=C)
    H2 = Et.Her2k(Et.UPPER, Et.NORMAL, 0.5, A, A)
    Y = Et.Symv(Et.LOWER, 2.0, C, X)
    torch.cuda.synchronize()
    assert (masked_rank_k.launches - k2, symv_lower.launches - k7) == (3, 1)
    for out, ref in ((H, Et.Herk(Et.LOWER, Et.NORMAL, -1.0, Ac, beta=1.0,
                                 C=Cc)),
                     (H2, Et.Her2k(Et.UPPER, Et.NORMAL, 0.5, Ac, Ac)),
                     (Y, Et.Symv(Et.LOWER, 2.0, Cc, Xc))):
        err = (out.data.cpu() - ref.data).abs().max().item()
        assert err <= 1e-5 * ref.data.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,dt,strided", [
    (1000, 777, torch.float32, True), (257, 129, torch.bfloat16, False),
    (300, 70, torch.float64, True), (1, 5000, torch.float32, False),
    (5000, 1, torch.float64, True), (0, 7, torch.float32, False)],
    ids=["ragged-mT", "bf16", "f64-mT", "row", "column", "empty"])
def test_elementwise_kernels_vs_plain(cuda, m, n, dt, strided):
    """K9 against its plain versions: the same operations rounded the
    same way, so every output is equal bit for bit (alpha and beta as
    Python numbers and as 0-d tensors on the card); each entry launches
    once (none for an empty array); fill clamps its extent."""
    g = torch.Generator(device=cuda).manual_seed(33)

    def mk():
        t = torch.randn((n, m) if strided else (m, n), generator=g,
                        device=cuda).to(dt)
        return t.mT if strided else t

    x, y = mk(), mk()
    alpha = torch.tensor(0.3, device=cuda, dtype=torch.float64)
    launches = (axpby.launches, scale.launches, hadamard.launches,
                fill.launches, transpose.launches)
    pairs = [(axpby(alpha, x, -1.7, y), axpby_plain(alpha, x, -1.7, y)),
             (scale(-2.5, x), scale_plain(-2.5, x)),
             (hadamard(x, y), hadamard_plain(x, y)),
             (fill((m, n), alpha, dt, cuda, extent=(m - 1, n + 5)),
              fill_plain((m, n), alpha, dt, cuda, extent=(m - 1, n + 5))),
             (transpose(x), transpose_plain(x)),
             (transpose(y, conjugate=True), transpose_plain(y, True))]
    torch.cuda.synchronize()
    for out, ref in pairs:
        assert out.dtype == dt and out.is_contiguous()
        assert torch.equal(out, ref)
    step = 1 if m * n else 0
    assert (axpby.launches, scale.launches, hadamard.launches,
            fill.launches, transpose.launches) == tuple(
                c + k * step for c, k in zip(launches, (1, 1, 1, 1, 2)))


@pytest.mark.cuda
def test_elementwise_kernels_refuse_complex_and_mixed_types(cuda):
    z = torch.ones((4, 4), dtype=torch.complex64, device=cuda)
    f = torch.ones((4, 4), device=cuda)
    for call in (lambda: axpby(1.0, z, 1.0, z), lambda: scale(2.0, z),
                 lambda: hadamard(z, z), lambda: transpose(z, True),
                 lambda: fill((4, 4), 1.0, torch.complex64, cuda)):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(TypeError):
        axpby(1.0, f.double(), 1.0, f)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha_kind", ["number", "tensor"])
def test_elementwise_bf16_scalars_bit_for_bit(cuda, alpha_kind):
    """bfloat16 axpby, scale and fill with alpha = 0.3 (rounded to
    bfloat16 on the host, as torch.full does) or a float64 tensor alpha on
    the card (cast there), equal to their plain versions bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(43)
    x = torch.randn((257, 129), generator=g, device=cuda).bfloat16()
    y = torch.randn((257, 129), generator=g, device=cuda).bfloat16()
    alpha = 0.3 if alpha_kind == "number" else torch.tensor(
        0.3, dtype=torch.float64, device=cuda)
    pairs = [(axpby(alpha, x, -1.7, y), axpby_plain(alpha, x, -1.7, y)),
             (axpby(alpha, x, 1.0, y), axpby_plain(alpha, x, 1.0, y)),
             (scale(alpha, x), scale_plain(alpha, x)),
             (fill((257, 129), alpha, torch.bfloat16, cuda),
              fill_plain((257, 129), alpha, torch.bfloat16, cuda))]
    torch.cuda.synchronize()
    for out, ref in pairs:
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, ref)


@pytest.mark.cuda
def test_elementwise_number_scalars_launch_one_kernel(cuda):
    """With Python-number scalars each K9 call runs exactly one device
    kernel (the scalars go by value): torch.profiler sees at most one a
    call, every one the entry's own kernel."""
    import time

    from torch.profiler import ProfilerActivity, profile, schedule

    x = torch.ones((1024, 256), device=cuda)
    y = torch.ones((1024, 256), device=cuda)
    calls = (lambda: axpby(0.3, x, -1.7, y), lambda: scale(0.3, x),
             lambda: hadamard(x, y),
             lambda: fill((1024, 256), 0.3, torch.float32, cuda),
             lambda: transpose(x))
    for call, name in zip(calls, ("ew_flat_kernel",) * 4
                          + ("transpose_kernel",)):
        call()
        torch.cuda.synchronize()
        # a window that opens just before the launches may lose some or all
        # of them: the calls are recorded in the step after a warm-up step,
        # with idle host time around them; the profiler never adds a kernel
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                time.sleep(0.02)
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
                time.sleep(0.02)
                prof.step()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert 0 < len(kernels) <= 5, kernels
        assert all(name in k for k in kernels), kernels


@pytest.mark.cuda
def test_gemm_views_and_level1_on_card(cuda):
    """A transposed Gemm launches K1 on a view (no K9 transpose), its
    beta C goes through K9's axpby, and Transpose launches K9's
    transpose; each matches the CPU to 1e-5 of its largest entry."""
    import elementalx_torch as Et

    g = torch.Generator(device=cuda).manual_seed(34)
    a = torch.randn((300, 200), generator=g, device=cuda)
    b = torch.randn((300, 100), generator=g, device=cuda)
    c = torch.randn((200, 100), generator=g, device=cuda)
    grid, cpu = Et.Grid(cuda), Et.Grid("cpu")
    A, B, C = (Et.DistMatrix.from_global(t, grid=grid) for t in (a, b, c))
    Ac, Bc, Cc = (Et.DistMatrix.from_global(t.cpu(), grid=cpu)
                  for t in (a, b, c))
    k1, tr, ax = matmul.launches, transpose.launches, axpby.launches
    P = Et.Gemm(Et.TRANSPOSE, Et.NORMAL, 2.0, A, B, beta=-1.0, C=C)
    torch.cuda.synchronize()
    assert (matmul.launches - k1, transpose.launches - tr,
            axpby.launches - ax) == (1, 0, 1)
    ref = Et.Gemm(Et.TRANSPOSE, Et.NORMAL, 2.0, Ac, Bc, beta=-1.0, C=Cc)
    assert (P.data.cpu() - ref.data).abs().max().item() <= \
        1e-5 * ref.data.abs().max().item()
    T = Et.Transpose(A)
    torch.cuda.synchronize()
    assert transpose.launches - tr == 1
    assert torch.equal(T.data.cpu(), a.cpu().mT.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(900, 600), (400, 700)],
                         ids=["over", "under"])
def test_least_squares_on_card(cuda, m, n):
    """least_squares_step in float64 on the card against the CPU (1e-10
    of max|X|, and of ||B|| for the residual norm); the overdetermined
    path launches one K9 axpby (the residual), the underdetermined one
    also one K9 transpose (of A, which it factors by QR) and one fill."""
    from elementalx_torch.entry import least_squares_step, make_ls_problem

    a, b = make_ls_problem(m, n, 3, dtype=torch.float64, device=cuda, seed=7)
    before = (axpby.launches, transpose.launches, fill.launches)
    x, nrm = least_squares_step(a, b)
    torch.cuda.synchronize()
    got = tuple(c - c0 for c, c0 in zip(
        (axpby.launches, transpose.launches, fill.launches), before))
    assert got == ((1, 0, 0) if m >= n else (1, 1, 1))
    xc, nc = least_squares_step(a.cpu(), b.cpu())
    assert (x.cpu() - xc).abs().max().item() <= 1e-10 * xc.abs().max().item()
    # the wide system is solved exactly: its residual is rounding-sized
    assert abs(nrm.item() - nc.item()) <= 1e-10 * b.norm().item()


@pytest.mark.cuda
def test_qr_cholqr_fast_path_on_card(cuda):
    """QR at 2048 x 1024 float32 with nb=256 on the card takes the
    CholeskyQR2 panel for every panel at least 4 nb tall (the identity
    test reads lu_factor_ex's 1-based pivots), and Q is orthogonal and
    reproduces A to 100 eps n."""
    import elementalx_torch as Et
    from elementalx_torch.lapack import qr as tqr

    g = torch.Generator(device=cuda).manual_seed(35)
    a = torch.randn((2048, 1024), generator=g, device=cuda)
    tqr.cholqr_panels.update(fast=0, slow=0, short=0)
    Q, R = Et.ExplicitQR(Et.DistMatrix.from_global(a, grid=Et.Grid(cuda)),
                         blocksize=256)
    torch.cuda.synchronize()
    assert tqr.cholqr_panels == {"fast": 4, "slow": 0, "short": 0}
    q, r = Q.data.double(), R.data.double()
    eps, n = torch.finfo(torch.float32).eps, 2048
    orth = (q.mT @ q - torch.eye(1024, device=cuda, dtype=torch.float64))
    assert orth.abs().max().item() / (eps * n) < 100
    recon = (a.double() - q @ r).abs().max() / a.abs().max()
    assert recon.item() / (eps * n) < 100


# ---------------------------------------------------------------------------
# K8 on the card: the ring SUMMA on virtual grids (every position on the
# one card), against its plain version on the same [VC,*] blocks
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("height,p", [(2, 4), (4, 8)], ids=["2x2", "4x2"])
@pytest.mark.parametrize("dt,rtol", [(torch.float32, 1e-5),
                                     (torch.bfloat16, 1e-2),
                                     (torch.float64, 1e-12)],
                         ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("shape", [(1000, 777, 1001), (130, 67, 257)])
def test_ring_summa_kernel_vs_plain(cuda, height, p, dt, rtol, shape):
    """Tolerances, of the largest entry: FP32 sums in another order 1e-5;
    float64 1e-12; bf16 outputs one bf16 step (1e-2). One launch covers
    every rank of the virtual grid."""
    import elementalx_torch as Et
    from elementalx_torch.core.redistribute import Copy
    from elementalx_torch.core.types import STAR, VC
    from elementalx_torch.kernels.ring_summa import (
        ring_summa,
        ring_summa_kernel,
        ring_summa_plain,
    )

    m, k, n = shape
    grid = Et.Grid([cuda] * p, height=height)
    g = torch.Generator(device=cuda).manual_seed(8)
    a = torch.randn((m, k), generator=g, device=cuda).to(dt)
    b = torch.randn((k, n), generator=g, device=cuda).to(dt)
    A = Et.DistMatrix.from_global(a, grid=grid)
    B = Et.DistMatrix.from_global(b, grid=grid)
    av = [x.contiguous() for x in Copy(A, VC, STAR).blocks]
    bv = [x.contiguous() for x in Copy(B, VC, STAR).blocks]
    before = ring_summa_kernel.launches
    out = ring_summa_kernel(av, bv)
    ref = ring_summa_plain(av, bv)
    torch.cuda.synchronize()
    assert ring_summa_kernel.launches == before + 1
    scale = max(r.double().abs().max().item() for r in ref)
    for o, r in zip(out, ref):
        assert o.dtype == dt and o.shape == r.shape
        assert (o.double() - r.double()).abs().max().item() <= rtol * scale
    C = ring_summa(A, B)
    torch.cuda.synchronize()
    assert ring_summa_kernel.launches == before + 2
    want = a.double() @ b.double()
    got = torch.tensor(C.global_array(), dtype=torch.float64)
    assert (got - want.cpu()).abs().max().item() <= \
        rtol * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("height,p", [(2, 4), (4, 8)], ids=["2x2", "4x2"])
@pytest.mark.parametrize("dt,core", [(torch.bfloat16, "wgmma"),
                                     (torch.float32, "fma_async")],
                         ids=["bf16", "f32"])
def test_ring_summa_fast_cores(cuda, height, p, dt, core):
    """K8 on its fast cores (kb = K/p a multiple of 64, 16-byte rows):
    bf16 on the tensor cores against the plain version within one bf16
    step (1e-2 of max|C|), float32 on the cp.async pipeline equal bit for
    bit to the FMA core."""
    import elementalx_torch as Et
    from elementalx_torch.core.redistribute import Copy
    from elementalx_torch.core.types import STAR, VC
    from elementalx_torch.kernels.ring_summa import (
        _launch,
        ring_summa_kernel,
        ring_summa_plain,
        route,
    )

    m, k, n = 1000, 1024, 1032
    grid = Et.Grid([cuda] * p, height=height)
    g = torch.Generator(device=cuda).manual_seed(23)
    a = torch.randn((m, k), generator=g, device=cuda).to(dt)
    b = torch.randn((k, n), generator=g, device=cuda).to(dt)
    av = [x.contiguous() for x in Copy(Et.DistMatrix.from_global(
        a, grid=grid), VC, STAR).blocks]
    bv = [x.contiguous() for x in Copy(Et.DistMatrix.from_global(
        b, grid=grid), VC, STAR).blocks]
    assert route(av, bv) == core
    before = getattr(ring_summa_kernel, f"launches_{core}")
    out = ring_summa_kernel(av, bv)
    torch.cuda.synchronize()
    assert getattr(ring_summa_kernel, f"launches_{core}") == before + 1
    if core == "wgmma":
        ref = ring_summa_plain(av, bv)
        scale = max(r.double().abs().max().item() for r in ref)
        for o, r in zip(out, ref):
            assert (o.double() - r.double()).abs().max().item() <= \
                1e-2 * scale
    else:
        ref = _launch("fma", av, bv)
        torch.cuda.synchronize()
        assert all(torch.equal(o, r) for o, r in zip(out, ref))


@pytest.mark.cuda
def test_ring_summa_kernel_refusals(cuda):
    from elementalx_torch.kernels.ring_summa import ring_summa_kernel

    a = [torch.ones((4, 8), device=cuda) for _ in range(2)]
    b = [torch.ones((4, 4), device=cuda) for _ in range(2)]
    with pytest.raises(NotImplementedError):
        ring_summa_kernel([x.to(torch.complex64) for x in a],
                          [x.to(torch.complex64) for x in b])
    with pytest.raises(ValueError, match="contiguous"):
        ring_summa_kernel([torch.ones((8, 4), device=cuda).mT] * 2, b)
    with pytest.raises(TypeError):
        ring_summa_kernel(a, [x.double() for x in b])
    with pytest.raises(ValueError):
        ring_summa_kernel(a, b[:1])
