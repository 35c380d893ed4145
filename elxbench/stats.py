"""The arithmetic of the end-to-end metrics and of their spread.

Both timings are taken over every call of the window: ``solve_ms`` is the
window's wall time over the calls it completed, ``solve_ms_p90`` the 90th
percentile of all the calls' times, never a median of chunks.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Sequence


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-quantile (0 < q <= 1) by nearest rank: the smallest value with
    at least q of the values at or below it (a time that a call took)."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q * len(ordered))) - 1]


def window_metrics(window_s: float, call_ms: Sequence[float]) -> Dict[str, float]:
    """solve_ms and solve_ms_p90 of a window of len(call_ms) calls."""
    return {"solve_ms": window_s * 1e3 / len(call_ms),
            "solve_ms_p90": nearest_rank(call_ms, 0.9)}


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile as a share of
    the median, the quartiles as ``statistics.quantiles(values, n=4)``
    gives them."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
