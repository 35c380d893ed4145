"""The nominal work: LAPACK's operation counts, checked against a count of
the textbook algorithms' multiplications (divisions and square roots
among them) and additions at small n."""

import pytest

from elxbench import cells


def _count_potrf(n):
    mults = adds = 0
    for k in range(n):
        m = n - k - 1
        mults += 1 + m + m * (m + 1) // 2  # sqrt, column scale, update
        adds += m * (m + 1) // 2
    return mults + adds


def _count_getrf(n):
    mults = adds = 0
    for k in range(n):
        m = n - k - 1
        mults += m + m * m  # multipliers, rank-1 update
        adds += m * m
    return mults + adds


def _count_trsv(n, unit):
    # each off-diagonal entry one multiplication and one addition; a
    # non-unit diagonal one division per row
    return n * (n - 1) + (0 if unit else n)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 33])
@pytest.mark.parametrize("nrhs", [1, 5])
def test_hpd_solve_flops_are_lapacks_counts(n, nrhs):
    work = cells.load_cell("hpd.f64.n16384").work
    potrs = nrhs * 2 * _count_trsv(n, unit=False)
    assert work.flops(n, nrhs) == pytest.approx(_count_potrf(n) + potrs,
                                                abs=1e-9)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 33])
@pytest.mark.parametrize("nrhs", [1, 5])
def test_lu_solve_flops_are_lapacks_counts(n, nrhs):
    work = cells.load_cell("lu.f32.n16384").work
    getrs = nrhs * (_count_trsv(n, unit=True) + _count_trsv(n, unit=False))
    assert work.flops(n, nrhs) == pytest.approx(_count_getrf(n) + getrs,
                                                abs=1e-9)


@pytest.mark.parametrize("cell", ["hpd.f64.n16384", "lu.f32.n16384"])
def test_bytes_read_each_input_once_and_write_the_output_once(cell):
    work = cells.load_cell(cell).work
    assert work.nbytes(10, 3, 8) == (100 + 30 + 30) * 8


def test_nominal_work_at_the_cells_sizes():
    hpd = cells.load_cell("hpd.f64.n16384").work
    lu = cells.load_cell("lu.f32.n16384").work
    assert hpd.flops(16384, 256) == pytest.approx(1.6035e12, rel=1e-4)
    assert lu.flops(16384, 256) == pytest.approx(3.0693e12, rel=1e-4)
    assert hpd.flops(2048, 1) == pytest.approx(2.8738e9, rel=1e-4)
