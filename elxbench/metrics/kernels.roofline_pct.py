"""kernels.roofline_pct: the solve's nominal least time over the device's
busy time in the same traced calls, in percent.

The roofline rule: the least time of a call is the larger of its nominal
operations over the peak of its dtype and its nominal bytes over the
memory bandwidth (``peaks.json``); the work is the configuration's
``work/<config>.py``, the problem's, not each launch's, so it reads the
same whatever kernels implement the solve.
"""

UNIT = "%"


def read(t: dict):
    peak = t.get("peak_flops_per_s")
    if not (t.get("busy_s") and t.get("flops_per_call") and peak):
        return None
    least = max(t["flops_per_call"] / peak,
                t["bytes_per_call"] / t["peak_bytes_per_s"])
    return 100.0 * least * t["calls"] / t["busy_s"]
