"""The LU and triangular-solve paths never make the host wait for the card.

A store of a Python number through advanced indexing (``x[idx] = 1``)
copies the number from pageable host memory, which waits for the stream
to drain; the port writes such constants on the device instead
(``index_fill_``, ``fill_`` on a view of the diagonal). On the CPU the
device-side writes give the same tensors as the indexed stores. On the
card every stage of the LU and Trsm paths runs under
``torch.cuda.set_sync_debug_mode("error")``, which raises at the first
synchronizing call, and gives the same bits as with the mode off.

The ``cuda``-marked test imports no JAX and runs on the card with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_sync.py``.
"""

import pytest
import torch

import elementalx_torch as Et
from elementalx_torch.blas.trinv import tri_inv_lower_unit, tri_inv_upper
from elementalx_torch.kernels.getrf import packed_getrf
from elementalx_torch.lapack.cholesky import _set_pad_diag
from elementalx_torch.lapack.lu import LU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sync debug mode watches CUDA "
                    "streams only")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape,m", [((8, 8), 5), ((8, 8), 8), ((8, 8), 0),
                                     ((9, 6), 4), ((6, 9), 2)])
@pytest.mark.parametrize("val", [1, 0])
def test_pad_diag_through_a_view_equals_an_indexed_store(shape, m, val):
    d = torch.randn(shape, generator=torch.Generator().manual_seed(15),
                    dtype=torch.float64)
    want = d.clone()
    idx = torch.arange(m, min(shape))
    want[idx, idx] = val
    got = _set_pad_diag(d, m, val)
    assert got is d and torch.equal(got, want)


def _problem(device, dtype, n=2048, nrhs=64):
    g = torch.Generator(device="cpu").manual_seed(15)
    a = torch.randn(n, n, generator=g, dtype=dtype)
    b = torch.randn(n, nrhs, generator=g, dtype=dtype)
    return a.to(device), b.to(device)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, Et.DistMatrix):
        return [x.replicated()]
    if isinstance(x, Et.Permutation):
        return [x.perm]
    return [t for y in x for t in _tensors(y)]


def _case(name, dev):
    """A call of one stage on the card, its inputs made beforehand."""
    if name == "getrf":
        a = torch.randn(2048, 512, device=dev)
        return lambda: packed_getrf(a)
    if name == "trinv_lower_unit":
        lo = torch.randn(512, 512, device=dev) / 512
        return lambda: tri_inv_lower_unit(lo)
    if name.startswith("trinv"):
        n = {"trinv_padded": 200, "trinv_pow2": 512}[name]
        u = torch.randn(3, n, n, device=dev) + 4 * n * torch.eye(n, device=dev)
        return lambda: tri_inv_upper(u)
    kind, dt = name.split("_")
    a, b = _problem(dev, {"f32": torch.float32, "f64": torch.float64}[dt])
    grid = Et.Grid(dev)
    if kind == "lu":
        A = Et.DistMatrix.from_global(a, grid=grid)
        return lambda: LU(A)
    if kind == "solve":
        return lambda: Et.LinearSolve(Et.DistMatrix.from_global(a, grid=grid),
                                      Et.DistMatrix.from_global(b, grid=grid))
    F, _ = LU(Et.DistMatrix.from_global(a, grid=grid))
    B = Et.DistMatrix.from_global(b, grid=grid)
    if kind == "trsmLU":
        return lambda: Et.Trsm(Et.LEFT, Et.LOWER, Et.NORMAL, Et.UNIT, 1.0,
                               F, B)
    return lambda: Et.Trsm(Et.LEFT, Et.UPPER, Et.NORMAL, Et.NON_UNIT, 1.0,
                           F, B)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "getrf", "trinv_padded", "trinv_pow2", "trinv_lower_unit",
    # n = 2048 takes nb = 1024: two 512-wide sub-panels a slab, one update
    "lu_f32", "lu_f64", "solve_f32", "solve_f64",
    "trsmLU_f32", "trsmUN_f32", "trsmLU_f64", "trsmUN_f64"])
def test_on_the_card_no_stage_waits_for_the_device(cuda, name):
    call = _case(name, cuda)
    want = _tensors(call())  # builds the kernels, warms the allocator
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _tensors(call())
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
