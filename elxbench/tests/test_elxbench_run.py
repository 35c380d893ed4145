"""A run end to end on the CPU at a tiny size: what it prints, what it
refuses, what it imports, and that `correct` comes out false for the
control and for a broken timed path."""

import io
import json
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

import elementalx_torch as Et
from elxbench import cells, run, trace

ROOT = cells.HERE.parent
CPU = torch.device("cpu")
#: each cell at a size the CPU runs in a fraction of a second
TINY = {"hpd.f64.n16384": 96, "hpd.f32.n16384": 96, "lu.f32.n16384": 96}
#: the limits at these sizes, for the numbers each cell's file compares
#: (over 8 seeds at n=96, nrhs=4): the port reads gap at most 0.009, fwd
#: 5.5 and resid 0.018 there, the control at least gap 0.32, fwd 146 and
#: resid 10.3 (TF32 products), gap 2.2e6 and fwd 1.4e9 (float32 for
#: float64). The scaled numbers are not the same at every size: at the
#: cells' own sizes each cell's file holds the limits its readings set.
TINY_LIMITS = {"gap": 0.05, "fwd": 40.0, "resid": 0.3}


def tiny(name):
    cell = cells.load_cell(name)
    traffic = dict(cell.traffic, n=TINY[name], nrhs=min(4, cell.traffic["nrhs"]))
    return cell._replace(traffic=traffic,
                         limits={k: TINY_LIMITS[k] for k in cell.limits})


def go(cell, solver=None, traced=False, seed=2 ** 31 + 11):
    return run.run(cell, seed, 0.2, traced, CPU, solver=solver, t0=0.0,
                   log=lambda s: None)


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_port_is_correct_under_each_cells_limits(name):
    res = go(tiny(name))
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"solve_ms", "solve_ms_p90", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_control_is_not_correct(name):
    """The reference one precision below the cell's, in the program's
    place: float32 for float64, TF32 products for float32."""
    cell = tiny(name)
    res = go(cell, solver=run.control_solver(cell))
    assert not res["correct"], res["checks"]


def _faults(cell):
    solve = run.port_solver(cell.config, Et.Grid(CPU))

    def unchanged(a, b, span=run.no_span):  # returns its input as it came
        return b.clone()

    def half_batch(a, b, span=run.no_span):  # solves half the right-hand
        h = max(1, b.shape[1] // 2)          # sides, the rest their mean
        x = solve(a, b[:, :h])
        return torch.cat([x, x.mean(dim=1, keepdim=True).expand(
            -1, b.shape[1] - h)], dim=1)

    def altered(a, b, span=run.no_span):  # one answer altered where made
        x = solve(a, b).clone()
        x[a.shape[0] // 2, 0] += x.abs().max()
        return x

    seen = [0]

    def raises(a, b, span=run.no_span):  # fails once set-up is done
        seen[0] += 1
        if seen[0] > 4:
            raise RuntimeError("a failed call")
        return solve(a, b)

    def non_finite(a, b, span=run.no_span):
        x = solve(a, b).clone()
        x[0, 0] = float("nan")
        return x

    return {"unchanged": unchanged, "half_batch": half_batch,
            "altered": altered, "raises": raises, "non_finite": non_finite}


@pytest.mark.parametrize("name", sorted(TINY))
def test_every_limit_of_a_cell_is_compared(name):
    """A limit in the cell's file is a check: a forward gap limit under
    what the port reads makes the run not correct."""
    cell = tiny(name)
    res = go(cell)
    assert set(cell.limits) <= set(res["checks"])
    assert res["correct"], res["checks"]
    res = go(cell._replace(limits=dict(cell.limits, fwd=0.0)))
    assert res["checks"]["fwd"]["value"] > 0
    assert not res["correct"], res["checks"]


def test_a_cell_limit_never_loosens_the_configurations_accuracy():
    cell = tiny("lu.f32.n16384")
    res = go(cell._replace(limits={"resid": 1e9}))
    assert res["checks"]["resid"]["limit"] == cell.config["accuracy"]["resid"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "raises", "non_finite"])
@pytest.mark.parametrize("name", ["hpd.f64.n16384", "lu.f32.n16384"])
def test_a_broken_timed_path_is_not_correct(name, fault):
    """The faults a solve on one chip can have (there is no exchange
    between chips to leave out)."""
    cell = tiny(name)
    res = go(cell, solver=_faults(cell)[fault])
    assert not res["correct"], res["checks"]
    if fault in ("raises", "non_finite"):
        assert res["failed"] == res["attempted"] >= 1
        assert res["checks"]["failed_calls"]["value"] == res["failed"]


def test_the_traced_run_reads_every_per_layer_metric_it_can():
    res = go(tiny("hpd.f64.n16384"), traced=True)
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    # no device here: nothing runs on it, so no roofline share, and no
    # device memory for a collection to free
    assert res["metrics"]["device.idle_pct"]["value"] == 100.0
    assert "kernels.roofline_pct" not in res["metrics"]
    assert "blas.cycle_garbage_mib" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_result_is_the_last_line_and_checks_its_last_key(capsys):
    res = go(tiny("hpd.f64.n16384"))
    run.emit(res)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check failed_calls 0 ")


def test_a_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "elxbench" / "run.py"), "--workload",
         "hpd.f64.n16384", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA" in proc.stderr


def test_nothing_the_run_imports_is_jax_and_the_reference_not_the_port():
    """In fresh interpreters: run.py with all it imports loads no module
    whose top-level name is jax or elementalx; the references load nothing
    of elementalx_torch either."""
    probe = """
import importlib.util, json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
def load(path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
if sys.argv[2] == "run":
    load(root / "elxbench" / "run.py")
    from elxbench import calibrate, sets
for p in sorted((root / "elxbench" / "reference").glob("*.py")):
    load(p)
for p in sorted((root / "elxbench" / "work").glob("*.py")):
    load(p)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    for what, banned in (("run", {"jax", "jaxlib", "flax", "elementalx"}),
                         ("reference", {"jax", "jaxlib", "flax", "elementalx",
                                        "elementalx_torch"})):
        proc = subprocess.run([sys.executable, "-c", probe, str(ROOT), what],
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
        assert not top & banned, (what, top & banned)
        if what == "run":
            assert "elementalx_torch" in top


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    assert run.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "elementalx_torchvision", None)
    assert run.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", None)
    assert run.foreign_modules() == ["jax"]


def test_trace_summary_of_known_spans():
    cpu = [(trace.CALL, 0.0, 100.0), ("aten::solve", 10.0, 40.0),
           ("cudaLaunchKernel", 20.0, 22.0), (trace.CALL, 200.0, 300.0),
           ("aten::item", 250.0, 290.0), ("ProfilerStep#1", 0.0, 400.0)]
    dev = [("k1", 5.0, 15.0), ("k2", 12.0, 30.0), ("Memcpy DtoH", 40.0, 41.0),
           ("k1", 210.0, 260.0), ("k_outside", 350.0, 360.0)]
    dev.append(("elxbench.solve", 0.0, 100.0))  # a mirrored annotation
    s = trace.summarize(dev, cpu)
    assert s["calls"] == 2 and s["kernels"] == 3
    assert s["window_s"] == pytest.approx(200e-6)  # the calls' own time
    assert s["busy_s"] == pytest.approx((25 + 1 + 50) * 1e-6)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops == pytest.approx({"k1": 60e-6, "k2": 18e-6, "Memcpy DtoH": 1e-6})
    idle = dict(s["breakdown"]["idle_gaps"])
    # idle: 0-5 and 41-100 (the first call's own Python), 30-40 (in
    # aten::solve), 200-210 (the second call's) and 260-300 (in aten::item)
    assert idle[trace.CALL] == pytest.approx(74e-6)
    assert idle["aten::solve"] == pytest.approx(10e-6)
    assert idle["aten::item"] == pytest.approx(40e-6)
    assert sum(idle.values()) == pytest.approx(200e-6 - s["busy_s"])


def test_readers_read_their_arithmetic_or_nothing():
    r = cells.readers()
    ctx = {"calls": 4, "window_s": 2.0, "busy_s": 1.5, "kernels": 100,
           "flops_per_call": 67e12 * 0.1, "bytes_per_call": 1.0,
           "peak_flops_per_s": 67e12, "peak_bytes_per_s": 3.35e12}
    assert r["device.idle_pct"].read(ctx) == pytest.approx(25.0)
    assert r["kernels.roofline_pct"].read(ctx) == pytest.approx(
        100 * 0.4 / 1.5)
    assert r["lapack.kernels_per_solve"].read(ctx) == 25.0
    assert r["blas.cycle_garbage_mib"].read(
        dict(ctx, cycle_bytes_per_call=3 * 2 ** 29)) == 1536.0
    assert r["blas.cycle_garbage_mib"].read(
        dict(ctx, cycle_bytes_per_call=0)) == 0.0
    empty = {"calls": 0, "window_s": 0.0, "busy_s": 0.0, "kernels": 0}
    assert all(m.read(empty) is None for m in r.values())


@pytest.mark.cuda
def test_a_short_traced_run_on_the_card(cuda):
    cell = tiny("hpd.f64.n16384")
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = run.run(cell, 3, 0.5, True, cuda, t0=0.0)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert 0 < m["kernels.roofline_pct"]["value"] <= 100
    assert 0 <= m["device.idle_pct"]["value"] < 100
    assert m["lapack.kernels_per_solve"]["value"] > 0
    assert m["blas.cycle_garbage_mib"]["value"] >= 0
    assert res["device"]["platform"] == "gpu"
