"""The port's spans (``elementalx_torch.trace``): nothing recorded without
a profiler, every stage of the HPD and LU solves recorded under one, the
spans nested as the calls are, the same answer either way, a record per
profiler session, and ``summary``'s arithmetic. The solves run at
n=256 with blocksize 64, so there are four panels.

The ``cuda``-marked test imports no JAX and runs on the card with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_trace.py``.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

import elementalx_torch as Et
from elementalx_torch import trace

N, NB = 256, 64

COMMON = {"lapack.SolveAfter", "blas.Trsm", "blas.trsm.prep",
          "blas.trsm.diag_inv", "blas.trinv", "blas.local_gemm",
          "core.from_global", "core.replicated"}
NAMES = {
    "hpd": COMMON | {"lapack.HPDSolve", "lapack.Cholesky",
                     "lapack.cholesky.panel", "lapack.cholesky.nan_check"},
    "lu": COMMON | {"lapack.LinearSolve", "lapack.LU", "lapack.lu.slab",
                    "lapack.lu.update", "lapack.lu.gather",
                    "lapack.perm.apply_rows"},
}
#: spans a solve at N, NB opens more than once
COUNTS = {"hpd": {"lapack.cholesky.panel": 4, "blas.Trsm": 2},
          "lu": {"lapack.lu.slab": 4, "lapack.lu.update": 3, "blas.Trsm": 2}}


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
    yield
    trace.reset()
    torch.set_num_threads(prev)


def _problem(kind, device, dtype=torch.float64, n=N):
    g = torch.Generator(device="cpu").manual_seed(14)
    G = torch.randn(n, n, generator=g, dtype=dtype)
    B = torch.randn(n, 8, generator=g, dtype=dtype)
    A = G @ G.T / n + 2 * torch.eye(n, dtype=dtype) if kind == "hpd" else G
    return A.to(device), B.to(device)


def _solve(kind, a, b, blocksize=NB):
    """X of a solve as the benchmark's caller runs it: from_global of A
    and B, the public solve, replicated."""
    grid = Et.Grid(a.device)
    A = Et.DistMatrix.from_global(a, grid=grid)
    B = Et.DistMatrix.from_global(b, grid=grid)
    if kind == "hpd":
        X = Et.HPDSolve(Et.LOWER, Et.NORMAL, A, B, blocksize=blocksize)
    else:
        X = Et.LinearSolve(A, B, blocksize=blocksize)
    return X.replicated()[:X.m, :X.n]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_without_a_profiler_nothing_is_recorded():
    a, b = _problem("hpd", "cpu")
    _solve("hpd", a, b)
    assert trace.records() == []
    assert trace.summary() == {"solves": 0, "spans": {}}
    assert trace.span("lapack.HPDSolve") is trace.span("blas.Trsm",
                                                       torch.device("cpu"))


@pytest.mark.parametrize("kind", ["hpd", "lu"])
def test_a_solve_records_every_stage_nested(kind):
    a, b = _problem(kind, "cpu")
    with _cpu_profile():
        _solve(kind, a, b)
    recs = trace.records()
    assert {r.name for r in recs} == NAMES[kind]
    for r in recs:
        assert r.t0 <= r.t1
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.t0 <= r.t0 and r.t1 <= p.t1
            assert r.root == p.root
        else:
            assert r.root == recs.index(r)
    solve = [i for i, r in enumerate(recs) if r.name.startswith("lapack.")
             and r.parent < 0]
    assert len(solve) == 1
    inside = [r for r in recs if r.root == solve[0]]
    assert {r.name for r in inside} == NAMES[kind] - {"core.from_global",
                                                      "core.replicated"}
    s = trace.summary()
    assert s["solves"] == 1
    for name, count in COUNTS[kind].items():
        assert s["spans"][name]["count"] == count
    for v in s["spans"].values():
        assert 0 <= v["self_ms"] <= v["host_ms"]
        assert v["device_ms"] is None  # no CUDA device on the CPU


@pytest.mark.parametrize("kind", ["hpd", "lu"])
def test_the_profiler_holds_each_span_on_the_calling_thread(kind):
    a, b = _problem(kind, "cpu")
    with _cpu_profile() as prof:
        torch.ones(1)  # an op of the calling thread
        _solve(kind, a, b)
    events = prof.events()
    caller = {ev.thread for ev in events if ev.name == "aten::ones"}
    elx = [ev for ev in events if ev.name.startswith(trace.PREFIX)]
    assert {ev.thread for ev in elx} == caller
    got = sorted(ev.name for ev in elx)
    assert got == sorted(trace.PREFIX + r.name for r in trace.records())


@pytest.mark.parametrize("kind", ["hpd", "lu"])
def test_the_answer_is_the_same_with_the_spans_on(kind):
    a, b = _problem(kind, "cpu")
    off = _solve(kind, a, b)
    with _cpu_profile():
        on = _solve(kind, a, b)
    assert torch.equal(off, on)


def test_a_new_profiler_session_starts_the_record_afresh():
    a, b = _problem("lu", "cpu")
    with _cpu_profile():
        _solve("lu", a, b)
        _solve("lu", a, b)
    assert trace.summary()["solves"] == 2
    a, b = _problem("hpd", "cpu")
    _solve("hpd", a, b)  # spans that find no profiler leave it as it was
    assert trace.summary()["solves"] == 2
    with _cpu_profile():
        _solve("hpd", a, b)
    s = trace.summary()
    assert s["solves"] == 1
    assert "lapack.LU" not in s["spans"] and "lapack.Cholesky" in s["spans"]


def test_a_scheduled_window_records_its_recorded_step_alone():
    a, b = _problem("hpd", "cpu")
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for calls in (1, 2):
            for _ in range(calls):
                _solve("hpd", a, b)
            prof.step()
    assert trace.summary()["solves"] == 2


def _rec(name, parent, root, t0, t1):
    r = trace._Record(name, parent, root)
    r.t0, r.t1 = t0, t1
    return r


def test_summary_takes_self_time_from_the_direct_children():
    ms = 1_000_000
    recs = [
        _rec("lapack.HPDSolve", -1, 0, 0, 100 * ms),
        _rec("lapack.Cholesky", 0, 0, 5 * ms, 60 * ms),
        _rec("blas.local_gemm", 1, 0, 10 * ms, 20 * ms),
        _rec("blas.local_gemm", 1, 0, 30 * ms, 45 * ms),
        _rec("blas.Trsm", 0, 0, 65 * ms, 95 * ms),
        _rec("core.replicated", -1, 5, 101 * ms, 102 * ms),
        _rec("lapack.HPDSolve", -1, 6, 110 * ms, 130 * ms),
        _rec("blas.Trsm", 6, 6, 111 * ms, None),  # still open: left out
    ]
    s = trace.summary(recs)
    assert s["solves"] == 2
    sp = s["spans"]
    assert sp["lapack.HPDSolve"]["count"] == 2
    assert sp["lapack.HPDSolve"]["host_ms"] == pytest.approx(120.0)
    # 100 - 55 - 30, then 20 with its open child left out
    assert sp["lapack.HPDSolve"]["self_ms"] == pytest.approx(35.0)
    assert sp["lapack.Cholesky"]["self_ms"] == pytest.approx(30.0)
    assert sp["blas.local_gemm"] == {"count": 2, "host_ms": pytest.approx(25.0),
                                     "self_ms": pytest.approx(25.0),
                                     "device_ms": None}
    assert sp["blas.Trsm"]["count"] == 1
    assert sp["core.replicated"]["self_ms"] == pytest.approx(1.0)


def test_launch_counters_count_by_key_and_reset():
    def wrapper():
        pass

    trace.reset_counts(wrapper, ("a", "b"))
    trace.count(wrapper, "a")
    trace.count(wrapper, "a")
    trace.count(wrapper)
    assert (wrapper.launches, wrapper.launches_a, wrapper.launches_b) == (
        3, 2, 0)
    trace.reset_counts(wrapper, ("a", "b"))
    assert (wrapper.launches, wrapper.launches_a, wrapper.launches_b) == (
        0, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hpd", "lu"])
def test_on_the_card_spans_stay_off_the_device_timeline(cuda, kind):
    a, b = _problem(kind, cuda, torch.float32, n=2048)
    _solve(kind, a, b, blocksize=None)  # builds the kernels
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        e0.record()
        _solve(kind, a, b, blocksize=None)
        e1.record()
        torch.cuda.synchronize()
    call_ms = e0.elapsed_time(e1)
    dev = torch.autograd.DeviceType.CUDA
    events = prof.events()
    assert any(ev.device_type == dev for ev in events)
    assert not [ev.name for ev in events if ev.device_type == dev
                and ev.name.startswith(trace.PREFIX)]
    s = trace.summary()
    assert s["solves"] == 1
    timed = {"hpd": ("lapack.Cholesky", "blas.Trsm"),
             "lu": ("lapack.LU", "blas.Trsm")}[kind]
    for name in timed:
        assert 0 < s["spans"][name]["device_ms"] <= call_ms
    assert sum(s["spans"][n]["device_ms"] for n in timed) <= call_ms
