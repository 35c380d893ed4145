"""The port's least squares (``LeastSquares(NORMAL, A, B)``, the benchmark
cell ``ls.f32.n16384``) against the cell's plain reference
(``elxbench/reference/ls_solve.py``) on the CPU, in the benchmark's own
numbers (``elxbench/judge.py``): the port in float32 against the
reference in float64, the reference at TF32 in the port's place failing
the same limit, and the reference against ``numpy.linalg.lstsq``.
"""

import numpy as np
import pytest
import torch

import elementalx_torch as Et
from elementalx_torch.entry import make_ls_problem
from elementalx_torch.lapack import qr as tqr
from elxbench import cells
from elxbench.judge import numbers

REF = cells.load_cell("ls.f32.n16384").reference
CPU = Et.Grid("cpu")
EPS32 = torch.finfo(torch.float32).eps
#: resid's limit at n = 96, as the benchmark's tiny CPU runs hold it; both
#: the port's readings and TF32's fall about as 1/n (port at most 0.0036 at
#: n = 96, 0.0012 at 256, 1.9e-4 at 1024, 7.6e-5 at 2048; TF32 at least
#: 2.97, 0.51, 0.128, 0.047), so the limit at n is TINY_RESID * 96 / n
TINY_RESID = 0.3


def resid_limit(n):
    return TINY_RESID * 96 / n


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def _port(a, b, blocksize=None):
    """X through the public entry, as the benchmark's caller runs it, under
    ``blocksize`` pushed on the blocksize stack."""
    if blocksize:
        Et.PushBlocksizeStack(blocksize)
    try:
        A = Et.DistMatrix.from_global(a, grid=CPU)
        B = Et.DistMatrix.from_global(b, grid=CPU)
        X = Et.LeastSquares(Et.NORMAL, A, B)
        return X.replicated()[:X.m, :X.n]
    finally:
        if blocksize:
            Et.PopBlocksizeStack()


def _read(a, b, x):
    """The judge's numbers of x for the float32 problem (a, b)."""
    a64, b64 = a.double(), b.double()
    return numbers(a64, b64, x, REF.solve(a64, b64, "float64"), EPS32)


# (n, nrhs, blocksize, seed): the geqrf route (nb below 192), one panel and
# several, nb dividing n and not
GEQRF_CASES = [(96, 4, None, 2 ** 31 + 1), (128, 4, None, 7),
               (200, 3, 64, 11), (256, 8, 64, 12)]
# float32 at nb = 256: CholeskyQR2 panels ("fast") and a geqrf tail
# ("short": fewer than 4 nb rows left); (fast, slow, short)
CHOLQR_CASES = [(1024, 8, 256, 21, (1, 0, 3)), (2048, 4, 256, 22, (5, 0, 3))]


@pytest.mark.parametrize("n,nrhs,nb,seed", GEQRF_CASES)
def test_the_port_against_the_reference(n, nrhs, nb, seed):
    a, b = REF.make_problem(n, nrhs, torch.float32, _gen(seed))
    got = _read(a, b, _port(a, b, nb))
    assert got["resid"] < resid_limit(n), got


@pytest.mark.parametrize("n,nrhs,nb,seed,panels", CHOLQR_CASES)
def test_the_port_on_cholesky_qr2_panels_against_the_reference(
        n, nrhs, nb, seed, panels):
    a, b = REF.make_problem(n, nrhs, torch.float32, _gen(seed))
    tqr.cholqr_panels.update(fast=0, slow=0, short=0)
    x = _port(a, b, nb)
    assert tuple(tqr.cholqr_panels.values()) == panels
    got = _read(a, b, x)
    assert got["resid"] < resid_limit(n), got


@pytest.mark.parametrize("n,nrhs,seed", [c[:2] + c[3:4] for c in GEQRF_CASES]
                         + [c[:2] + c[3:4] for c in CHOLQR_CASES])
def test_the_reference_at_tf32_fails_the_limit(n, nrhs, seed):
    """The control: TF32 products in the port's place break the limit the
    port keeps, so the comparison would catch a lower precision."""
    a, b = REF.make_problem(n, nrhs, torch.float32, _gen(seed))
    got = _read(a, b, REF.solve(a, b, "tf32"))
    assert got["resid"] > resid_limit(n), got


@pytest.mark.parametrize("n,nrhs,nb", [(1, 1, None), (8, 3, None),
                                       (37, 3, None), (100, 4, 16),
                                       (130, 2, 32)])
def test_the_reference_against_numpy_lstsq(n, nrhs, nb):
    a, b = REF.make_problem(n, nrhs, torch.float64, _gen(n))
    want = np.linalg.lstsq(a.numpy(), b.numpy(), rcond=None)[0]
    got = REF.solve(a, b, "float64", nb=nb)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-11 * np.abs(want).max())


def test_larft_gives_the_product_of_the_reflectors():
    """I - V T V^T equals H_1 H_2 ... H_k for the panel geqrf factored,
    tau = 0 (a column already reduced) included."""
    a = torch.randn(12, 5, generator=_gen(3), dtype=torch.float64)
    # row 2 out of reflectors 0 and 1, and column 2 = 1.5 e_2: nothing
    # below the diagonal is left to reduce there, so tau_2 = 0
    a[2, :2] = 0
    a[:, 2] = 0
    a[2, 2] = 1.5
    pk, tau = torch.geqrf(a)
    v = pk.tril(-1)
    v.diagonal().fill_(1)
    q = torch.eye(12, dtype=torch.float64)
    for i in range(5):
        q = q @ (torch.eye(12, dtype=torch.float64)
                 - tau[i] * torch.outer(v[:, i], v[:, i]))
    t = REF.larft(v, tau)
    assert float(tau[2]) == 0.0
    assert torch.equal(t, t.triu())
    torch.testing.assert_close(torch.eye(12, dtype=torch.float64)
                               - v @ t @ v.mT, q, rtol=0, atol=1e-14)


@pytest.mark.parametrize("precision", ["float32", "tf32"])
def test_each_precision_is_what_it_says(precision):
    a, b = REF.make_problem(128, 4, torch.float64, _gen(4))
    exact = REF.solve(a, b, "float64", nb=32)
    err = float((REF.solve(a, b, precision, nb=32).double() - exact)
                .abs().max() / exact.abs().max())
    lo, hi = {"float32": (1e-8, 1e-4), "tf32": (1e-5, 1e-1)}[precision]
    assert lo < err < hi
    if precision == "tf32":
        f32 = float((REF.solve(a, b, "float32", nb=32).double() - exact)
                    .abs().max() / exact.abs().max())
        assert err > 10 * f32


@pytest.mark.parametrize("n,nrhs,seed", [(24, 2, 2 ** 31 + 7), (64, 5, 3)])
def test_the_problem_is_make_ls_problems_at_m_equal_n(n, nrhs, seed):
    """The reference's frozen copy draws what the port's entry draws for a
    square float32 problem, and repeats for a seed."""
    a, b = REF.make_problem(n, nrhs, torch.float32, _gen(seed))
    ea, eb = make_ls_problem(n, n, nrhs, torch.float32, "cpu", seed=seed)
    assert torch.equal(a, ea) and torch.equal(b, eb)
    a2, _ = REF.make_problem(n, nrhs, torch.float32, _gen(seed + 1))
    assert not torch.equal(a, a2)
