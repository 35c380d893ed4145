"""The port's bf16 product (``Gemm(NORMAL, NORMAL, 1.0, A, B)``, the cell
``gemm.bf16.n16384``) against the cell's plain reference
(``reference/gemm.py``) on the CPU, in the benchmark's own numbers
(judge.py); the reference's controls failing the same limit; and a
configuration's ``call`` carrying a number."""

import json
import shutil

import pytest
import torch

import elementalx_torch as Et
from elxbench import cells, run
from elxbench.judge import numbers

CELL = cells.load_cell("gemm.bf16.n16384")
REF = CELL.reference
CPU = Et.Grid("cpu")
EPS = torch.finfo(torch.bfloat16).eps
#: the configuration's limit on fwd: the bf16 result's rounding reaches at
#: most 0.5 of it
FWD = CELL.config["accuracy"]["fwd"]


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def _fwd(a, b, x):
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    return numbers(a64, b64, x, REF.solve(a64, b64, "float64"), EPS)["fwd"]


@pytest.mark.parametrize("n,nrhs", [(64, 64), (96, 96), (200, 72)])
def test_the_ports_gemm_rounds_its_result_once(n, nrhs):
    """The cell's own call, and Gemm called by hand, give the same bf16 X,
    within half a unit of bf16 of the float64 product at its largest
    entry's scale (a float32 sum, then one rounding)."""
    a, b = REF.make_problem(n, nrhs, torch.bfloat16, _gen(2 ** 31 + n))
    x = run.port_solver(CELL.config, CPU)(a, b)
    X = Et.Gemm(Et.NORMAL, Et.NORMAL, 1.0,
                Et.DistMatrix.from_global(a, grid=CPU),
                Et.DistMatrix.from_global(b, grid=CPU))
    assert x.dtype == torch.bfloat16 and tuple(x.shape) == (n, nrhs)
    assert torch.equal(x, X.replicated()[:n, :nrhs])
    assert _fwd(a, b, x) <= 0.5 + 1e-3


@pytest.mark.parametrize("precision,n,nrhs", [
    ("fp8", 96, 4), ("fp8", 512, 64),
    # K spans 16 slabs of 256: the bf16 accumulator rounds 16 times
    ("bf16_sum", 4096, 32)])
def test_the_references_controls_fail_the_fwd_limit(precision, n, nrhs):
    a, b = REF.make_problem(n, nrhs, torch.bfloat16, _gen(n))
    x = REF.solve(a, b, precision).to(torch.bfloat16)
    assert _fwd(a, b, x) > FWD


def test_the_references_float32_product_is_within_the_limit():
    a, b = REF.make_problem(200, 72, torch.bfloat16, _gen(7))
    x = REF.solve(a, b, "float32")
    assert x.dtype == torch.float32
    assert _fwd(a, b, x.to(torch.bfloat16)) <= 0.5 + 1e-3
    with pytest.raises(ValueError):
        REF.solve(a, b, "tf32")


def test_problems_repeat_for_a_seed_and_differ_across_seeds():
    a1, b1 = REF.make_problem(24, 5, torch.bfloat16, _gen(2 ** 31 + 7))
    a2, b2 = REF.make_problem(24, 5, torch.bfloat16, _gen(2 ** 31 + 7))
    a3, _ = REF.make_problem(24, 5, torch.bfloat16, _gen(2 ** 31 + 8))
    assert a1.dtype == b1.dtype == torch.bfloat16
    assert (tuple(a1.shape), tuple(b1.shape)) == ((24, 24), (24, 5))
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert not torch.equal(a1, a3)


def test_the_work_of_a_product():
    assert CELL.work.flops(16384, 16384) == 2 * 16384 ** 3
    assert CELL.work.nbytes(4, 3, 2) == (16 + 24) * 2


@pytest.mark.parametrize("alpha", [1.0, 2, 0.5])
def test_a_number_in_the_call_is_passed_as_it_is(alpha):
    entry, args = run.resolve_call(["Gemm", "NORMAL", "NORMAL", alpha, "A",
                                    "B"])
    assert entry is Et.Gemm
    assert args == [Et.NORMAL, Et.NORMAL, alpha, "A", "B"]
    assert type(args[2]) is type(alpha)
    a, b = REF.make_problem(48, 40, torch.bfloat16, _gen(3))
    cfg = dict(CELL.config, call=["Gemm", "NORMAL", "NORMAL", alpha, "A",
                                  "B"])
    one = run.port_solver(CELL.config, CPU)(a, b)
    # a power of two scales bf16 exactly
    assert torch.equal(run.port_solver(cfg, CPU)(a, b), one * alpha)


@pytest.mark.parametrize("config,want", [
    ("hpd_solve", ("HPDSolve", ["LOWER", "NORMAL", "A", "B"])),
    ("lu_solve", ("LinearSolve", ["A", "B"])),
    ("ls_solve", ("LeastSquares", ["NORMAL", "A", "B"]))])
def test_the_standing_configurations_resolve_as_before(config, want):
    """Strings keep their meaning: the inputs stay names, every other
    string is the package's constant, as before numbers were allowed."""
    call = cells.load_json(cells.HERE / "configs" / f"{config}.json")["call"]
    assert call == [want[0], *want[1]]
    entry, args = run.resolve_call(cells.check_call(call))
    assert entry is getattr(Et, want[0])
    former = [s if s in ("A", "B") else getattr(Et, s) for s in want[1]]
    assert args == former
    assert [type(x) for x in args] == [type(x) for x in former]


@pytest.mark.parametrize("call", [
    ["Gemm", "NORMAL", "NORMAL", True, "A", "B"],
    ["Gemm", "NORMAL", "NORMAL", {"alpha": 1.0}, "A", "B"],
    ["Gemm", "NORMAL", "NORMAL", None, "A", "B"],
    ["Gemm", "NORMAL", "NORMAL", [1.0], "A", "B"],
    ["Gemm", "NORMAL", "NORMAL", float("nan"), "A", "B"],
    [1.0, "A", "B"], [], "Gemm"])
def test_a_malformed_call_is_refused_when_the_cell_is_loaded(tmp_path, call):
    root = tmp_path / "bench"
    shutil.copytree(cells.HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = dict(CELL.config, call=call)
    (root / "configs" / "gemm.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="call"):
        cells.load_cell(CELL.name, root)
