"""Cells, configurations and per-layer metrics are found by name, and a new
one is files alone."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from elxbench import cells, run

BENCH = cells.HERE
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def _digest(root: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_of_the_benchmark_has_its_files(w):
    cell = cells.load_cell(w["name"])
    assert (cell.config_name, cell.traffic_name, cell.chips) == (
        w["config"], w["traffic"], w["chips"])
    assert cell.config["name"] == w["config"]
    assert set(cell.traffic) == {"dtype", "n", "nrhs", "problems"}
    assert callable(cell.reference.make_problem)
    assert callable(cell.reference.solve)
    assert cell.work.flops(8, 2) > 0


def test_configs_and_metrics_of_the_benchmark_have_their_files():
    for c in SPEC["configs"]:
        cfg = json.loads((BENCH.parent / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] in cfg["precisions"].values()
    found = cells.readers()
    assert set(found) == {m["name"] for m in SPEC["per_layer"]}
    for m in SPEC["per_layer"]:
        assert found[m["name"]].UNIT == m["unit"]
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    assert {e["name"]: e["unit"] for e in SPEC["end_to_end"]} == {
        "solve_ms": "ms", "solve_ms_p90": "ms", "setup_s": "s"}


def test_a_cell_in_a_precision_its_configuration_does_not_state_is_refused(
        tmp_path):
    root = tmp_path / "bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (root / "traffic" / "bf16.n48.rhs3.p2.json").write_text(json.dumps(
        {"dtype": "bfloat16", "n": 48, "nrhs": 3, "problems": 2}))
    (root / "workloads" / "hpd.bf16.n48.json").write_text(json.dumps(
        {"config": "hpd_solve", "traffic": "bf16.n48.rhs3.p2", "chips": 1,
         "limits": {"gap": 1.0}}))
    with pytest.raises(ValueError, match="bfloat16"):
        cells.load_cell("hpd.bf16.n48", root)


def test_unknown_or_malformed_names_are_refused():
    with pytest.raises(FileNotFoundError):
        cells.load_cell("no.such.cell")
    with pytest.raises(ValueError):
        cells.load_cell("../configs/hpd_solve")


def test_a_new_cell_configuration_and_metric_are_files_alone(tmp_path):
    """A later change copies nothing and edits nothing: it adds a
    configuration (its file, reference and work count), a traffic mix, a
    cell and a per-layer metric's reader, and the harness finds them by
    name and runs the cell; a configuration's call may carry a number (a
    Gemm's alpha)."""
    before = _digest(BENCH)
    root = tmp_path / "bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = json.loads((root / "configs" / "hpd_solve.json").read_text())
    cfg.update(name="hpd_solve_upper",
               call=["HPDSolve", "UPPER", "NORMAL", "A", "B"])
    (root / "configs" / "hpd_solve_upper.json").write_text(json.dumps(cfg))
    shutil.copy(root / "reference" / "hpd_solve.py",
                root / "reference" / "hpd_solve_upper.py")
    shutil.copy(root / "work" / "hpd_solve.py",
                root / "work" / "hpd_solve_upper.py")
    (root / "traffic" / "f64.n48.rhs3.p2.json").write_text(json.dumps(
        {"dtype": "float64", "n": 48, "nrhs": 3, "problems": 2}))
    (root / "workloads" / "hpd_upper.f64.n48.json").write_text(json.dumps(
        {"config": "hpd_solve_upper", "traffic": "f64.n48.rhs3.p2",
         "chips": 1, "limits": {"gap": 1.0}}))
    (root / "metrics" / "lapack.calls_traced.py").write_text(
        'UNIT = "count"\n\n\ndef read(t):\n    return t.get("calls")\n')

    cfg = json.loads((root / "configs" / "gemm.json").read_text())
    cfg.update(name="gemm_half",
               call=["Gemm", "NORMAL", "NORMAL", 0.5, "A", "B"])
    (root / "configs" / "gemm_half.json").write_text(json.dumps(cfg))
    (root / "reference" / "gemm_half.py").write_text(
        "from elxbench.reference.gemm import make_problem, solve as _solve\n"
        "\n\ndef solve(a, b, precision):\n"
        "    return 0.5 * _solve(a, b, precision)\n")
    shutil.copy(root / "work" / "gemm.py", root / "work" / "gemm_half.py")
    (root / "traffic" / "bf16.n48.rhs40.p2.json").write_text(json.dumps(
        {"dtype": "bfloat16", "n": 48, "nrhs": 40, "problems": 2}))
    (root / "workloads" / "gemm_half.bf16.n48.json").write_text(json.dumps(
        {"config": "gemm_half", "traffic": "bf16.n48.rhs40.p2",
         "chips": 1, "limits": {"fwd": 1.0}}))

    cell = cells.load_cell("hpd_upper.f64.n48", root)
    assert cell.config["call"][1] == "UPPER"
    assert "lapack.calls_traced" in cells.readers(root)
    assert set(cells.readers()) < set(cells.readers(root))
    half = cells.load_cell("gemm_half.bf16.n48", root)
    assert half.config["call"][3] == 0.5
    for c in (cell, half):
        res = run.run(c, 5, 0.2, False, torch.device("cpu"),
                      t0=0.0, log=lambda s: None)
        assert res["correct"], (c.name, res["checks"])
    assert _digest(BENCH) == before
