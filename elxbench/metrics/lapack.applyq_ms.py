"""lapack.applyq_ms: the time to apply Q^T to B a solve, in ms: the device
times of the program's ``lapack.ApplyQ`` spans (``elementalx_torch.trace``:
CUDA events on the stream at the span's entry and exit, so it counts the
device's idle time inside the application too) in the traced calls, over
the solves the program recorded. Nothing to read where the program records
no ``lapack.ApplyQ`` span or no solve."""

import sys

UNIT = "ms"
SPAN = "lapack.ApplyQ"


def read(t: dict):
    mod = sys.modules.get("elementalx_torch.trace")
    if not t.get("calls") or mod is None:
        return None
    s = mod.summary()
    span = s["spans"].get(SPAN)
    if not s["solves"] or span is None or span["device_ms"] is None:
        return None
    return span["device_ms"] / s["solves"]
