"""The cell ``ls.f32.n16384`` end to end on the CPU at a tiny size: the
port is correct, the control and a broken timed path are not, a traced run
reads the QR's spans; the four readers of those spans read their
arithmetic or nothing; the work count is LAPACK's."""

import sys

import pytest
import torch

import elementalx_torch as Et
import elementalx_torch.trace as program_trace
from elxbench import cells, run

CELL = "ls.f32.n16384"
CPU = torch.device("cpu")
N = 96
#: the resid limit at n=96, nrhs=4 (the harness's tiny runs use it too):
#: over 3 seeds the port reads resid at most 0.0036 there and the control
#: (TF32 products) at least 2.97
TINY_RESID = 0.3
NAMES = ("lapack.qr_ms", "lapack.applyq_ms", "lapack.qr_wait_ms",
         "lapack.qr_geqrf_panels")


def tiny():
    cell = cells.load_cell(CELL)
    return cell._replace(traffic=dict(cell.traffic, n=N, nrhs=4),
                         limits={"resid": TINY_RESID})


def go(cell, solver=None, traced=False, seed=2 ** 31 + 16):
    return run.run(cell, seed, 0.2, traced, CPU, solver=solver, t0=0.0,
                   log=lambda s: None)


def test_the_cell_compares_resid_and_runs_least_squares():
    cell = cells.load_cell(CELL)
    assert set(cell.limits) == {"resid"}
    assert 0 < cell.limits["resid"] < cell.config["accuracy"]["resid"]
    assert cell.config["call"] == ["LeastSquares", "NORMAL", "A", "B"]
    assert (cell.traffic["dtype"], cell.traffic["n"]) == ("float32", 16384)


def test_the_port_is_correct():
    res = go(tiny())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == {"resid", "failed_calls"}


def test_the_control_is_not_correct():
    cell = tiny()
    res = go(cell, solver=run.control_solver(cell))
    assert not res["correct"], res["checks"]
    assert res["checks"]["resid"]["value"] > TINY_RESID


def _faults(cell):
    solve = run.port_solver(cell.config, Et.Grid(CPU))

    def unchanged(a, b, span=run.no_span):
        return b.clone()

    def half_batch(a, b, span=run.no_span):
        h = max(1, b.shape[1] // 2)
        x = solve(a, b[:, :h])
        return torch.cat([x, x.mean(dim=1, keepdim=True).expand(
            -1, b.shape[1] - h)], dim=1)

    def altered(a, b, span=run.no_span):
        x = solve(a, b).clone()
        x[a.shape[0] // 2, 0] += x.abs().max()
        return x

    seen = [0]

    def raises(a, b, span=run.no_span):
        seen[0] += 1
        if seen[0] > 4:
            raise RuntimeError("a failed call")
        return solve(a, b)

    def non_finite(a, b, span=run.no_span):
        x = solve(a, b).clone()
        x[0, 0] = float("nan")
        return x

    def no_q(a, b, span=run.no_span):  # R X = B: Q^T B left out
        A = Et.DistMatrix.from_global(a, grid=Et.Grid(CPU))
        r = Et.QR(A).packed.replicated()[:a.shape[0], :a.shape[0]].triu()
        return torch.linalg.solve_triangular(r, b, upper=True)

    return {"unchanged": unchanged, "half_batch": half_batch,
            "altered": altered, "raises": raises, "non_finite": non_finite,
            "no_q": no_q}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "raises", "non_finite", "no_q"])
def test_a_broken_timed_path_is_not_correct(fault):
    cell = tiny()
    res = go(cell, solver=_faults(cell)[fault])
    assert not res["correct"], res["checks"]
    if fault in ("raises", "non_finite"):
        assert res["failed"] == res["attempted"] >= 1


def test_a_traced_run_reads_the_qr_spans():
    """On the CPU no span takes a device time, so the two device-timed
    readers read nothing; the wait and the geqrf panels are read (the
    float32 QR at n=96 takes the geqrf route: one panel of Blocksize()
    columns, no CholeskyQR2 predicate)."""
    res = go(tiny(), traced=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert "lapack.qr_ms" not in m and "lapack.applyq_ms" not in m
    assert m["lapack.qr_geqrf_panels"] == {"value": 1.0, "unit": "count"}
    assert m["lapack.qr_wait_ms"] == {"value": 0.0, "unit": "ms"}


def _span(count, host, self_ms, device=None):
    return {"count": count, "host_ms": host, "self_ms": self_ms,
            "device_ms": device}


CTX = {"calls": 4, "window_s": 2.0, "busy_s": 1.5, "kernels": 100}
SUMMARY = {"solves": 4, "spans": {
    "lapack.LeastSquares": _span(4, 5000.0, 4.0),
    "lapack.QR": _span(4, 3600.0, 8.0, 3200.0),
    "lapack.qr.panel": _span(128, 2000.0, 40.0),
    "lapack.qr.predicate": _span(116, 900.0, 900.0),
    "lapack.qr.geqrf": _span(12, 60.0, 60.0),
    "lapack.qr.update": _span(124, 500.0, 20.0),
    "lapack.ApplyQ": _span(4, 800.0, 12.0, 720.0),
    "blas.Trsm": _span(4, 90.0, 6.0, 60.0),
}}


@pytest.fixture
def readers():
    found = cells.readers()
    return {n: found[n] for n in NAMES}


def test_the_readers_read_their_arithmetic(readers, monkeypatch):
    monkeypatch.setattr(program_trace, "summary", lambda: SUMMARY)
    got = {n: r.read(CTX) for n, r in readers.items()}
    assert got == {"lapack.qr_ms": pytest.approx(800.0),
                   "lapack.applyq_ms": pytest.approx(180.0),
                   "lapack.qr_wait_ms": pytest.approx(225.0),
                   "lapack.qr_geqrf_panels": pytest.approx(3.0)}


def test_a_qr_with_no_wait_and_no_geqrf_panel_reads_zero(readers,
                                                        monkeypatch):
    spans = {k: v for k, v in SUMMARY["spans"].items()
             if k not in ("lapack.qr.predicate", "lapack.qr.geqrf")}
    monkeypatch.setattr(program_trace, "summary",
                        lambda: {"solves": 4, "spans": spans})
    assert readers["lapack.qr_wait_ms"].read(CTX) == 0.0
    assert readers["lapack.qr_geqrf_panels"].read(CTX) == 0


@pytest.mark.parametrize("summary", [
    {"solves": 0, "spans": SUMMARY["spans"]},
    # another cell's solve: no QR span
    {"solves": 4, "spans": {"lapack.LU": _span(4, 900.0, 40.0, 880.0),
                            "blas.Trsm": _span(8, 90.0, 6.0, 60.0)}},
    # no span took a device time
    {"solves": 4, "spans": {k: dict(v, device_ms=None)
                            for k, v in SUMMARY["spans"].items()
                            if k.startswith(("lapack.QR", "lapack.ApplyQ"))}},
], ids=["no_solve", "no_qr", "no_device_time"])
def test_the_readers_read_nothing_without_their_spans(readers, monkeypatch,
                                                      summary):
    monkeypatch.setattr(program_trace, "summary", lambda: summary)
    assert all(r.read(CTX) is None for r in readers.values())


def test_the_readers_read_nothing_without_the_programs_spans(readers,
                                                            monkeypatch):
    monkeypatch.setattr(program_trace, "summary", lambda: SUMMARY)
    monkeypatch.delitem(sys.modules, "elementalx_torch.trace")
    assert all(r.read(CTX) is None for r in readers.values())
    empty = {"calls": 0, "window_s": 0.0, "busy_s": 0.0, "kernels": 0}
    monkeypatch.setitem(sys.modules, "elementalx_torch.trace", program_trace)
    assert all(r.read(empty) is None for r in readers.values())


def _geqrf_lawn41(m, n):
    """xGEQRF's multiplications and additions for m >= n (LAPACK Working
    Note 41), written as LAPACK's dopla.f writes them."""
    mults = n * ((23 / 6 + m + n / 2) + n * (m - n / 3))
    adds = n * (5 / 6 + n * (1 / 2 + (m - n / 3)))
    return mults + adds


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
@pytest.mark.parametrize("nrhs", [1, 5])
def test_ls_solve_flops_are_lapacks_counts(n, nrhs):
    work = cells.load_cell(CELL).work
    # xORMQR, SIDE = 'L', on an n x nrhs C with k = n reflectors
    ormqr = (2 * nrhs * n * n - nrhs * n * n + 2 * nrhs * n) + (
        2 * nrhs * n * n - nrhs * n * n + nrhs * n)
    trsm = nrhs * n * (n + 1) / 2 + nrhs * n * (n - 1) / 2
    assert work.flops(n, nrhs) == pytest.approx(
        _geqrf_lawn41(n, n) + ormqr + trsm, abs=1e-9)
    assert work.nbytes(n, nrhs, 4) == (n * n + 2 * n * nrhs) * 4


def test_ls_solve_nominal_work_at_the_cells_size():
    work = cells.load_cell(CELL).work
    n, nrhs = 16384, 256
    assert work.flops(n, nrhs) == pytest.approx(
        4 * n ** 3 / 3 + 3 * n * n * nrhs, rel=1e-4)
    # 90.6 ms of the H100's 67 TFLOP/s FP32
    assert work.flops(n, nrhs) / 67e12 == pytest.approx(0.0906, rel=1e-3)
