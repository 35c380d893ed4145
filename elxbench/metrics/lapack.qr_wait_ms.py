"""lapack.qr_wait_ms: the host's wait on the device in the QR's panels a
solve, in ms: the host times of the program's ``lapack.qr.predicate``
spans (``elementalx_torch.trace``: the host's read of each CholeskyQR2
panel's predicate, which waits for the stream to reach it) in the traced
calls, over the solves the program recorded; 0 where QR panels ran and
none waited. ``lapack.host_self_ms``, whose reader leaves out only
``lapack.cholesky.nan_check``, counts these waits too. Nothing to read
where the program records no QR panel (``lapack.qr.panel``) or no
solve."""

import sys

UNIT = "ms"
SPAN = "lapack.qr.predicate"
PANELS = "lapack.qr.panel"


def read(t: dict):
    mod = sys.modules.get("elementalx_torch.trace")
    if not t.get("calls") or mod is None:
        return None
    s = mod.summary()
    if not s["solves"] or PANELS not in s["spans"]:
        return None
    span = s["spans"].get(SPAN)
    return (span["host_ms"] if span else 0.0) / s["solves"]
