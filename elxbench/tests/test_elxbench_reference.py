"""The plain references against NumPy on tiny problems."""

import numpy as np
import pytest
import torch

from elxbench import cells
from elxbench.reference import common

HPD = cells.load_cell("hpd.f64.n16384").reference
LU = cells.load_cell("lu.f32.n16384").reference


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


@pytest.mark.parametrize("n,nrhs,nb", [(1, 1, None), (37, 3, None),
                                       (100, 4, 16), (130, 2, 32)])
def test_hpd_reference_against_numpy(n, nrhs, nb):
    a, b = HPD.make_problem(n, nrhs, torch.float64, _gen(n))
    assert torch.equal(a, a.mT)
    want = np.linalg.solve(a.numpy(), b.numpy())
    got = HPD.solve(a, b, "float64", nb=nb)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


def test_hpd_reference_reads_only_the_lower_triangle():
    a, b = HPD.make_problem(64, 2, torch.float64, _gen(1))
    junk = a + torch.triu(torch.full_like(a, 7.0), 1)
    assert torch.equal(HPD.solve(a, b, "float64", nb=16),
                       HPD.solve(junk, b, "float64", nb=16))


@pytest.mark.parametrize("n,nrhs,nb", [(1, 1, None), (37, 3, None),
                                       (100, 4, 16), (130, 2, 32)])
def test_lu_reference_against_numpy(n, nrhs, nb):
    a, b = LU.make_problem(n, nrhs, torch.float64, _gen(n))
    want = np.linalg.solve(a.numpy(), b.numpy())
    got = LU.solve(a, b, "float64", nb=nb)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def test_rows_from_pivots_replays_lapacks_swaps():
    piv = np.array([3, 3, 4, 4])  # 1-based, as getrf returns them
    rows = LU.rows_from_pivots(piv, 5)
    want = list(range(5))
    for i, p in enumerate(piv - 1):
        want[i], want[p] = want[p], want[i]
    assert rows.tolist() == want


def test_problems_repeat_for_a_seed_and_differ_across_seeds():
    for ref in (HPD, LU):
        a1, b1 = ref.make_problem(24, 2, torch.float32, _gen(2 ** 31 + 7))
        a2, b2 = ref.make_problem(24, 2, torch.float32, _gen(2 ** 31 + 7))
        a3, _ = ref.make_problem(24, 2, torch.float32, _gen(2 ** 31 + 8))
        assert torch.equal(a1, a2) and torch.equal(b1, b2)
        assert not torch.equal(a1, a3)


def test_tf32_round_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1 + 2 ** -12, 1 + 2 ** -10, 1 + 3 * 2 ** -11, -3.14159,
                      float("inf"), 0.0], dtype=torch.float32)
    got = common.tf32_round(x).tolist()
    assert got[:3] == [1.0, 1 + 2 ** -10, 1 + 2 ** -9]  # ties to even
    assert got[3] == -3.140625 and got[4] == float("inf") and got[5] == 0.0
    r = torch.randn(1000, generator=_gen(3))
    rel = ((common.tf32_round(r) - r) / r).abs().max()
    assert 2 ** -13 < rel <= 2 ** -11


def test_each_precision_is_what_it_says():
    a, b = HPD.make_problem(128, 4, torch.float64, _gen(4))
    exact = HPD.solve(a, b, "float64", nb=32)
    err = {p: float((HPD.solve(a, b, p, nb=32).double() - exact).abs().max())
           for p in ("float32", "tf32")}
    assert 1e-9 < err["float32"] < 1e-5
    assert err["tf32"] > 10 * err["float32"]
    with pytest.raises(ValueError):
        common.compute_dtype("bfloat16")
