"""device.idle_pct: the share of the traced window of whole calls in which
no operation ran on the device, 100 (1 - busy / window), in percent."""

UNIT = "%"


def read(t: dict):
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
