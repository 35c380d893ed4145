"""lapack.qr_geqrf_panels: the QR panels that geqrf factors, a solve: the
count of the program's ``lapack.qr.geqrf`` spans (``elementalx_torch.trace``:
one a panel that the CholeskyQR2 route sends to geqrf, because its
predicate failed or fewer than 4 panel widths of rows remain, or that
the geqrf route factors) in the traced calls, over the solves the program
recorded; 0 where QR panels ran and none went to geqrf. Nothing to read
where the program records no QR panel (``lapack.qr.panel``) or no
solve."""

import sys

UNIT = "count"
SPAN = "lapack.qr.geqrf"
PANELS = "lapack.qr.panel"


def read(t: dict):
    mod = sys.modules.get("elementalx_torch.trace")
    if not t.get("calls") or mod is None:
        return None
    s = mod.summary()
    if not s["solves"] or PANELS not in s["spans"]:
        return None
    span = s["spans"].get(SPAN)
    return (span["count"] if span else 0) / s["solves"]
