"""The end-to-end timings are taken over every call of a window."""

import statistics

import pytest

from elxbench import stats


def test_nearest_rank_is_a_time_a_call_took():
    calls = [float(v) for v in range(1, 101)]
    assert stats.nearest_rank(calls, 0.9) == 90.0
    assert stats.nearest_rank(calls[:11], 0.9) == 10.0
    assert stats.nearest_rank([5.0], 0.9) == 5.0
    with pytest.raises(ValueError):
        stats.nearest_rank([], 0.9)


def test_window_metrics_over_all_calls_not_medians_of_chunks():
    # two chunks of 50 calls: the slow calls sit in the second chunk only
    calls = [10.0] * 50 + [10.0] * 40 + [30.0] * 10
    window_s = sum(calls) / 1e3 + 0.1  # the harness's own time between calls
    m = stats.window_metrics(window_s, calls)
    assert m["solve_ms"] == pytest.approx(window_s * 1e3 / 100)
    assert m["solve_ms_p90"] == 10.0
    calls[89] = 30.0
    assert stats.window_metrics(window_s, calls)["solve_ms_p90"] == 30.0
    chunked = statistics.median([stats.nearest_rank(calls[:50], 0.9),
                                 stats.nearest_rank(calls[50:], 0.9)])
    assert chunked != stats.window_metrics(window_s, calls)["solve_ms_p90"]


def test_spread_is_the_quartile_distance_over_the_median():
    vals = [100.0, 101.0, 99.0, 102.0, 98.0, 100.5]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / statistics.median(vals))
    assert stats.spread([7.0] * 6) == 0.0
