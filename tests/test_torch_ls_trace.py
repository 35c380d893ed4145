"""The least-squares solve's spans (``elementalx_torch.trace``): one
``LeastSquares(NORMAL, A, B)`` under a profiler records
``lapack.LeastSquares`` as its outermost span, ``lapack.QR`` with a
``lapack.qr.panel`` a panel, a ``lapack.qr.geqrf`` a panel geqrf factors
and a ``lapack.qr.predicate`` a CholeskyQR2 panel, its trailing updates,
``lapack.ApplyQ`` and the closing ``blas.Trsm``; without a profiler
nothing; the same bits either way.

The ``cuda``-marked test imports no JAX and runs on the card with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_ls_trace.py``.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import elementalx_torch as Et
from elementalx_torch import trace
from elementalx_torch.lapack import qr as tqr

# (dtype, n, blocksize): the CholeskyQR2 route (float32, nb = 256: one
# "fast" panel, then three "short" ones sent to geqrf) and the geqrf route
# (float64: every panel to geqrf)
CASES = {"cholqr": (torch.float32, 1024, 256),
         "geqrf": (torch.float64, 256, 64)}
NRHS = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: device-timed spans run only there")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _fresh_record():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    tqr.cholqr_panels.update(fast=0, slow=0, short=0)
    yield
    trace.reset()
    torch.set_num_threads(prev)


def _problem(dtype, n, device="cpu", graded=False):
    g = torch.Generator(device="cpu").manual_seed(16)
    a = torch.randn(n, n, generator=g, dtype=torch.float64) / n ** 0.5
    if graded:  # columns from 1 down to 1e-7: the CholeskyQR2 predicate fails
        a = a * torch.logspace(0, -7, n, dtype=torch.float64)[None, :]
    b = torch.randn(n, NRHS, generator=g, dtype=torch.float64)
    return a.to(device, dtype), b.to(device, dtype)


def _solve(a, b, blocksize):
    grid = Et.Grid(a.device)
    Et.PushBlocksizeStack(blocksize)
    try:
        X = Et.LeastSquares(Et.NORMAL, Et.DistMatrix.from_global(a, grid=grid),
                            Et.DistMatrix.from_global(b, grid=grid))
    finally:
        Et.PopBlocksizeStack()
    return X.replicated()[:X.m, :X.n]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_without_a_profiler_nothing_is_recorded():
    dtype, n, nb = CASES["cholqr"]
    _solve(*_problem(dtype, n), nb)
    assert trace.records() == []
    assert trace.summary() == {"solves": 0, "spans": {}}


@pytest.mark.parametrize("route", sorted(CASES))
def test_a_least_squares_solve_records_its_stages(route):
    dtype, n, nb = CASES[route]
    a, b = _problem(dtype, n)
    with _cpu_profile():
        _solve(a, b, nb)
    recs = trace.records()
    s = trace.summary()
    assert s["solves"] == 1
    roots = [r for r in recs if r.parent < 0 and r.name.startswith("lapack.")]
    assert [r.name for r in roots] == ["lapack.LeastSquares"]
    sp = s["spans"]
    panels = n // nb
    assert sp["lapack.QR"]["count"] == sp["lapack.ApplyQ"]["count"] == 1
    assert sp["lapack.qr.panel"]["count"] == panels
    assert sp["lapack.qr.update"]["count"] == panels - 1
    geqrf = tqr.cholqr_panels["slow"] + tqr.cholqr_panels["short"]
    if route == "cholqr":
        assert tuple(tqr.cholqr_panels.values()) == (1, 0, 3)
        assert sp["lapack.qr.geqrf"]["count"] == geqrf
        assert sp["lapack.qr.predicate"]["count"] == (
            tqr.cholqr_panels["fast"] + tqr.cholqr_panels["slow"])
    else:
        assert geqrf == 0
        assert sp["lapack.qr.geqrf"]["count"] == panels
        assert "lapack.qr.predicate" not in sp
    assert sp["blas.Trsm"]["count"] == 1
    by_name = {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r)
    root = recs.index(roots[0])
    for name in ("lapack.QR", "lapack.ApplyQ", "blas.Trsm"):
        (r,) = by_name[name]
        assert r.root == root and recs[r.parent].name == "lapack.LeastSquares"
    for name in ("lapack.qr.panel", "lapack.qr.update"):
        assert {recs[r.parent].name for r in by_name[name]} == {"lapack.QR"}
    assert {recs[r.parent].name for r in by_name["lapack.qr.geqrf"]} == {
        "lapack.qr.panel"}
    for r in by_name.get("lapack.qr.predicate", []):
        assert recs[r.parent].name == "lapack.qr.panel"
    for v in sp.values():
        assert 0 <= v["self_ms"] <= v["host_ms"]
        assert v["device_ms"] is None  # no CUDA device on the CPU


def test_panels_whose_predicate_fails_count_as_geqrf_panels():
    """A graded A fails the CholeskyQR2 predicate: each such "slow" panel
    opens a geqrf span, as each "short" one does."""
    a, b = _problem(torch.float32, 1024, graded=True)
    with _cpu_profile():
        _solve(a, b, 256)
    panels = dict(tqr.cholqr_panels)
    assert panels["slow"] >= 1
    sp = trace.summary()["spans"]
    assert sp["lapack.qr.geqrf"]["count"] == panels["slow"] + panels["short"]
    assert sp["lapack.qr.predicate"]["count"] == (panels["fast"]
                                                  + panels["slow"])


@pytest.mark.parametrize("route", sorted(CASES))
def test_the_answer_is_the_same_bits_with_the_spans_on(route):
    dtype, n, nb = CASES[route]
    a, b = _problem(dtype, n)
    off = _solve(a, b, nb)
    with _cpu_profile():
        on = _solve(a, b, nb)
    assert torch.equal(off, on)


def test_the_adjoint_solve_is_one_solve():
    """LeastSquares(ADJOINT, ...) calls itself on A^H: the inner span nests
    in the outer, so the record counts one solve."""
    dtype, n, nb = CASES["geqrf"]
    a, b = _problem(dtype, n)
    with _cpu_profile():
        grid = Et.Grid("cpu")
        Et.LeastSquares(Et.ADJOINT, Et.DistMatrix.from_global(a, grid=grid),
                        Et.DistMatrix.from_global(b, grid=grid))
    s = trace.summary()
    assert s["solves"] == 1
    assert s["spans"]["lapack.LeastSquares"]["count"] == 2


@pytest.mark.cuda
def test_on_the_card_qr_and_applyq_take_device_time(cuda):
    a, b = _problem(torch.float32, 2048, device=cuda)
    _solve(a, b, 512)  # builds the kernels
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        e0.record()
        _solve(a, b, 512)
        e1.record()
        torch.cuda.synchronize()
    call_ms = e0.elapsed_time(e1)
    s = trace.summary()
    assert s["solves"] == 1
    timed = ("lapack.QR", "lapack.ApplyQ", "blas.Trsm")
    for name in timed:
        assert 0 < s["spans"][name]["device_ms"] <= call_ms
    assert sum(s["spans"][n]["device_ms"] for n in timed) <= call_ms
    assert s["spans"]["lapack.qr.predicate"]["host_ms"] > 0
