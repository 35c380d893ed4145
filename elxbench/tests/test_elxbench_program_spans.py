"""The readers of the program's spans (``lapack.factor_ms``,
``blas.trsm_ms``, ``lapack.host_self_ms``, ``blas.host_self_ms``): nothing
to read without the port's span module, without calls or without a solve
recorded; otherwise their arithmetic on the program's summary."""

import sys

import pytest

import elementalx_torch.trace as program_trace
from elxbench import cells

NAMES = ("lapack.factor_ms", "blas.trsm_ms", "lapack.host_self_ms",
         "blas.host_self_ms")
CTX = {"calls": 4, "window_s": 2.0, "busy_s": 1.5, "kernels": 100}


def _span(count, host, self_ms, device=None):
    return {"count": count, "host_ms": host, "self_ms": self_ms,
            "device_ms": device}


SUMMARY = {"solves": 4, "spans": {
    "lapack.HPDSolve": _span(4, 400.0, 2.0),
    "lapack.Cholesky": _span(4, 300.0, 8.0, 320.0),
    "lapack.cholesky.panel": _span(128, 250.0, 30.0),
    "lapack.cholesky.nan_check": _span(4, 20.0, 20.0),
    "blas.Trsm": _span(8, 90.0, 6.0, 60.0),
    "blas.trinv": _span(8, 12.0, 12.0),
    "blas.local_gemm": _span(600, 40.0, 40.0),
    "core.from_global": _span(8, 1.0, 1.0),
}}


@pytest.fixture
def readers():
    found = cells.readers()
    return {n: found[n] for n in NAMES}


def test_they_read_nothing_without_the_programs_spans(readers, monkeypatch):
    monkeypatch.setattr(program_trace, "summary", lambda: SUMMARY)
    monkeypatch.delitem(sys.modules, "elementalx_torch.trace")
    assert all(r.read(CTX) is None for r in readers.values())


def test_they_read_nothing_without_calls(readers, monkeypatch):
    monkeypatch.setattr(program_trace, "summary", lambda: SUMMARY)
    empty = {"calls": 0, "window_s": 0.0, "busy_s": 0.0, "kernels": 0}
    assert all(r.read(empty) is None for r in readers.values())


def test_they_read_nothing_without_a_solve(readers, monkeypatch):
    """Nor blas's host time, where no blas span was recorded either."""
    spans = {n: v for n, v in SUMMARY["spans"].items()
             if not n.startswith("blas.")}
    monkeypatch.setattr(program_trace, "summary",
                        lambda: {"solves": 0, "spans": spans})
    assert all(r.read(CTX) is None for r in readers.values())


def test_blas_host_time_of_a_call_that_is_no_solve(readers, monkeypatch):
    """A Gemm records blas spans and no lapack solve: blas's host time is
    taken over the traced calls, and the lapack readers read nothing."""
    spans = {"blas.local_gemm": _span(4, 40.0, 36.0),
             "core.from_global": _span(8, 1.0, 1.0)}
    monkeypatch.setattr(program_trace, "summary",
                        lambda: {"solves": 0, "spans": spans})
    got = {n: r.read(CTX) for n, r in readers.items()}
    assert got == {"lapack.factor_ms": None, "blas.trsm_ms": None,
                   "lapack.host_self_ms": None,
                   "blas.host_self_ms": pytest.approx(36.0 / 4)}


def test_they_read_a_value_a_solve(readers, monkeypatch):
    monkeypatch.setattr(program_trace, "summary", lambda: SUMMARY)
    got = {n: r.read(CTX) for n, r in readers.items()}
    assert got == {
        "lapack.factor_ms": pytest.approx(80.0),
        "blas.trsm_ms": pytest.approx(15.0),
        # the host's wait in the NaN check left out
        "lapack.host_self_ms": pytest.approx((2.0 + 8.0 + 30.0) / 4),
        "blas.host_self_ms": pytest.approx((6.0 + 12.0 + 40.0) / 4),
    }


def test_the_factor_time_sums_cholesky_and_lu(readers, monkeypatch):
    spans = dict(SUMMARY["spans"], **{"lapack.LU": _span(2, 50.0, 1.0, 40.0)})
    monkeypatch.setattr(program_trace, "summary",
                        lambda: {"solves": 4, "spans": spans})
    assert readers["lapack.factor_ms"].read(CTX) == pytest.approx(90.0)


def test_device_times_read_nothing_where_no_span_took_one(readers,
                                                          monkeypatch):
    spans = {n: dict(v, device_ms=None) for n, v in SUMMARY["spans"].items()}
    monkeypatch.setattr(program_trace, "summary",
                        lambda: {"solves": 4, "spans": spans})
    assert readers["lapack.factor_ms"].read(CTX) is None
    assert readers["blas.trsm_ms"].read(CTX) is None
    assert readers["lapack.host_self_ms"].read(CTX) == pytest.approx(10.0)
