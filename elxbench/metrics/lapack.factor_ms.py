"""lapack.factor_ms: the factorization's device time a solve, in ms: the
device times of the program's ``lapack.Cholesky`` and ``lapack.LU`` spans
(``elementalx_torch.trace``: CUDA events on the stream at the span's
entry and exit, so it counts the device's idle time inside the stage too)
in the traced calls, over the solves the program recorded. Nothing to
read where the program records no spans (no ``elementalx_torch.trace``)
or no solve."""

import sys

UNIT = "ms"
SPANS = ("lapack.Cholesky", "lapack.LU")


def read(t: dict):
    mod = sys.modules.get("elementalx_torch.trace")
    if not t.get("calls") or mod is None:
        return None
    s = mod.summary()
    device = [s["spans"][n]["device_ms"] for n in SPANS if n in s["spans"]]
    device = [ms for ms in device if ms is not None]
    if not s["solves"] or not device:
        return None
    return sum(device) / s["solves"]
