"""The port's full symmetric eigendecomposition (``HermitianEig(LOWER, A)``,
the cell ``eig.f32.n4096``) through the harness on the CPU at tiny sizes,
judged by the configuration's own numbers (``reference/hermitian_eig.py``):
correct under the cell's limits, the control and each fault not correct;
a call that names no B builds none; a tuple answer; and the standing
configurations' calls, answers and traced call counts as before."""

import math

import pytest
import torch

import elementalx_torch as Et
from elxbench import cells, run

CELL = cells.load_cell("eig.f32.n4096")
REF = CELL.reference
CPU = torch.device("cpu")
GRID = Et.Grid("cpu")
EPS = torch.finfo(torch.float32).eps
#: the cell's limits at these sizes, from 8 seeds each at n = 64 and 96
#: (CPU): the port reads resid 0.022-0.051, orth 0.035-0.077 and fwd
#: 0.83-1.71 there, the TF32 control resid 3.70-8.59 and fwd 344-548
#: (orth 0.087-0.18: a rounded A keeps Q orthogonal); each limit
#: lower^(1/3) upper^(2/3), rounded down
TINY_LIMITS = {"fwd": 50.0, "resid": 0.8}


def tiny(n):
    return CELL._replace(traffic=dict(CELL.traffic, n=n),
                         limits={k: TINY_LIMITS[k] for k in CELL.limits})


def go(cell, solver=None, traced=False, seed=2 ** 31 + 21):
    read = {}
    res = run.run(cell, seed, 0.2, traced, CPU, solver=solver, t0=0.0,
                  log=lambda s: None, readings=read)
    return res, read


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


@pytest.mark.parametrize("n", [64, 96])
def test_the_ports_eig_is_correct_under_the_cells_limits(n):
    res, read = go(tiny(n))
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == {"resid", "orth", "fwd", "failed_calls"}
    assert res["checks"]["orth"]["limit"] == CELL.config["accuracy"]["orth"]
    assert set(res["metrics"]) == {"solve_ms", "solve_ms_p90", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("n", [64, 96])
def test_the_tf32_control_is_not_correct(n):
    cell = tiny(n)
    res, read = go(cell, solver=run.control_solver(cell))
    assert not res["correct"], res["checks"]
    assert read["resid"] > TINY_LIMITS["resid"]
    assert read["fwd"] > TINY_LIMITS["fwd"]


def _faults(cell):
    solve = run.port_solver(cell.config, GRID)
    shift = 2 * TINY_LIMITS["fwd"] * EPS

    def unchanged(a, b, span=run.no_span):  # A's diagonal, no rotation
        return a.diagonal().sort().values, torch.eye(a.shape[0])

    def half_batch(a, b, span=run.no_span):  # half the pairs, the rest
        w, q = solve(a, b)                    # their mean
        h = a.shape[0] // 2
        w, q = w.clone(), q.clone()
        w[h:] = w[:h].mean()
        q[:, h:] = q[:, :h].mean(dim=1, keepdim=True)
        return w, q

    def w_shifted(a, b, span=run.no_span):  # w off by twice fwd's limit
        w, q = solve(a, b)
        return w + shift * w.abs().max(), q

    def column_altered(a, b, span=run.no_span):  # one vector altered
        w, q = solve(a, b)
        q = q.clone()
        q[0, a.shape[0] // 2] += 0.5
        return w, q

    def permuted(a, b, span=run.no_span):  # vectors out of w's order
        w, q = solve(a, b)
        return w, q.roll(1, dims=1)

    seen = [0]

    def raises(a, b, span=run.no_span):  # fails once set-up is done
        seen[0] += 1
        if seen[0] > 4:
            raise RuntimeError("a failed call")
        return solve(a, b)

    def non_finite(a, b, span=run.no_span):  # in w alone
        w, q = solve(a, b)
        w = w.clone()
        w[0] = float("nan")
        return w, q

    return {"unchanged": unchanged, "half_batch": half_batch,
            "w_shifted": w_shifted, "column_altered": column_altered,
            "permuted": permuted, "raises": raises, "non_finite": non_finite}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "w_shifted",
                                   "column_altered", "permuted", "raises",
                                   "non_finite"])
def test_a_broken_eigensolver_is_not_correct(fault):
    cell = tiny(64)
    res, read = go(cell, solver=_faults(cell)[fault])
    assert not res["correct"], res["checks"]
    if fault in ("raises", "non_finite"):
        assert res["failed"] == res["attempted"] >= 1
        assert res["checks"]["failed_calls"]["value"] == res["failed"]
    if fault == "w_shifted":  # only the eigenvalues' error sees it
        assert read["fwd"] > TINY_LIMITS["fwd"]
        assert read["resid"] <= TINY_LIMITS["resid"]
    if fault == "permuted":  # orthogonal vectors of the wrong values
        assert read["orth"] <= CELL.config["accuracy"]["orth"]
        assert read["resid"] > CELL.config["accuracy"]["resid"]


def test_numbers_of_a_known_decomposition_read_zero():
    """A = P diag(w) P^T for a signed permutation P: every product is
    exact, so each number reads 0."""
    w = torch.tensor([-2.0, -0.5, 0.25, 1.0, 3.0], dtype=torch.float64)
    p = torch.eye(5, dtype=torch.float64)[[3, 0, 4, 1, 2]]
    p[:, 1] *= -1
    a = p @ torch.diag(w) @ p.mT
    b = a.new_empty((5, 0))
    read = REF.numbers(a, b, (w.float(), p.float()), (w, p), EPS)
    assert read == {"resid": 0.0, "orth": 0.0, "fwd": 0.0}


def test_the_reference_reads_the_numbers_of_the_port_and_of_float32():
    """The library's float32 eigensolver, the plain reference at float32,
    is within the limits the port is held to; its float64 answer reads
    (near) nothing against itself."""
    a, b = REF.make_problem(96, 0, torch.float32, _gen(5))
    a64 = a.double()
    ref = REF.solve(a64, b, "float64")
    assert ref[0].dtype == ref[1].dtype == torch.float64
    self_read = REF.numbers(a64, b, ref, ref, EPS)
    assert self_read["fwd"] == 0.0 and self_read["resid"] < 1e-6
    f32 = REF.numbers(a64, b, REF.solve(a, b, "float32"), ref, EPS)
    assert f32["resid"] <= TINY_LIMITS["resid"]
    assert f32["fwd"] <= TINY_LIMITS["fwd"]
    assert f32["orth"] <= CELL.config["accuracy"]["orth"]


def test_problems_repeat_for_a_seed_are_symmetric_and_have_no_b():
    a1, b1 = REF.make_problem(24, 0, torch.float32, _gen(2 ** 31 + 7))
    a2, _ = REF.make_problem(24, 0, torch.float32, _gen(2 ** 31 + 7))
    a3, _ = REF.make_problem(24, 0, torch.float32, _gen(2 ** 31 + 8))
    assert a1.dtype == torch.float32 and tuple(a1.shape) == (24, 24)
    assert tuple(b1.shape) == (24, 0) and b1.dtype == torch.float32
    assert torch.equal(a1, a1.mT)
    assert torch.equal(a1, a2) and not torch.equal(a1, a3)
    # the formula of elementalx_torch.entry.make_eig_problem
    g = torch.randn((24, 24), generator=_gen(9))
    want = (g + g.mT) / math.sqrt(8 * 24)
    assert torch.equal(REF.make_problem(24, 0, torch.float32, _gen(9))[0],
                       want)


def test_the_work_of_an_eigendecomposition():
    """LAPACK Working Note 41: xSYTRD 4 n^3 / 3, xORMTR on n vectors
    2 n^3; A in, Q and w out."""
    assert CELL.work.flops(4096, 0) == pytest.approx(10 * 4096 ** 3 / 3)
    assert CELL.work.flops(30, 0) == pytest.approx(4 * 30 ** 3 / 3
                                                   + 2 * 30 ** 3)
    assert CELL.work.nbytes(10, 0, 4) == (100 + 100 + 10) * 4


def _counting_from_global(monkeypatch):
    built = []
    real = Et.DistMatrix.from_global

    def from_global(t, *args, **kw):
        built.append(tuple(t.shape))
        return real(t, *args, **kw)

    monkeypatch.setattr(Et.DistMatrix, "from_global", from_global)
    return built


def test_a_call_that_names_no_b_builds_no_b(monkeypatch):
    a, b = REF.make_problem(48, 0, torch.float32, _gen(3))
    solve = run.port_solver(CELL.config, GRID)
    built = _counting_from_global(monkeypatch)
    w, q = solve(a, b)
    assert built == [(48, 48)]
    assert w.dtype == q.dtype == torch.float32
    assert tuple(w.shape) == (48,) and tuple(q.shape) == (48, 48)
    # the tuple answer: the DistMatrix Q replicated and cut, w as it is
    W, Q = Et.HermitianEig(Et.LOWER, Et.DistMatrix.from_global(a, grid=GRID))
    assert torch.equal(w, W) and torch.equal(q, Q.replicated()[:48, :48])


STANDING = {
    "hpd_solve": ("hpd.f64.n16384", lambda A, B: Et.HPDSolve(
        Et.LOWER, Et.NORMAL, A, B)),
    "lu_solve": ("lu.f32.n16384", lambda A, B: Et.LinearSolve(A, B)),
    "ls_solve": ("ls.f32.n16384", lambda A, B: Et.LeastSquares(
        Et.NORMAL, A, B)),
    "gemm": ("gemm.bf16.n16384", lambda A, B: Et.Gemm(
        Et.NORMAL, Et.NORMAL, 1.0, A, B)),
}


@pytest.mark.parametrize("config", sorted(STANDING))
def test_each_standing_call_builds_a_and_b_and_answers_as_before(
        monkeypatch, config):
    """The four standing configurations' calls build both inputs and return
    the one X that the entry called by hand gives, bit for bit."""
    name, by_hand = STANDING[config]
    cell = cells.load_cell(name)
    dtype = getattr(torch, cell.traffic["dtype"])
    a, b = cell.reference.make_problem(64, 4, dtype, _gen(11))
    solve = run.port_solver(cell.config, GRID)
    built = _counting_from_global(monkeypatch)
    x = solve(a, b)
    assert built == [(64, 64), (64, 4)]
    X = by_hand(Et.DistMatrix.from_global(a, grid=GRID),
                Et.DistMatrix.from_global(b, grid=GRID))
    assert isinstance(x, torch.Tensor) and x.dtype == dtype
    assert torch.equal(x, X.replicated()[:X.m, :X.n])


@pytest.mark.parametrize("per_call_ms", [15, 85, 222, 363])
def test_the_traced_call_count_is_as_before_for_the_standing_cells(
        per_call_ms):
    """The standing cells' calls (gemm 15, HPD 85, LU 222, LS 363 ms)
    trace as many calls as under the former rule, at least 3."""
    before = max(3, min(100, math.ceil(1.0 / (per_call_ms / 1e3))))
    assert run.traced_calls(per_call_ms / 1e3) == before >= 3


@pytest.mark.parametrize("per_call_s", [1.1, 5.0, 17.0])
def test_a_call_of_seconds_traces_one_call(per_call_s):
    assert run.traced_calls(per_call_s) == 1


def test_the_control_casts_every_part_to_the_traffics_dtype():
    a, b = REF.make_problem(32, 0, torch.float32, _gen(4))
    w, q = run.control_solver(CELL, "float64")(a, b)
    assert w.dtype == q.dtype == torch.float32
