"""blas.trsm_ms: the triangular solves' device time a solve, in ms: the
device times of the program's ``blas.Trsm`` spans (two a solve;
``elementalx_torch.trace``: CUDA events on the stream at the span's entry
and exit) in the traced calls, over the solves the program recorded.
Nothing to read where the program records no spans or no solve."""

import sys

UNIT = "ms"


def read(t: dict):
    mod = sys.modules.get("elementalx_torch.trace")
    if not t.get("calls") or mod is None:
        return None
    s = mod.summary()
    trsm = s["spans"].get("blas.Trsm")
    if not s["solves"] or trsm is None or trsm["device_ms"] is None:
        return None
    return trsm["device_ms"] / s["solves"]
