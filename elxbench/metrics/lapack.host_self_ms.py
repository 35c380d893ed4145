"""lapack.host_self_ms: the lapack drivers' own host time a solve, in ms:
the self time (host time less that of child spans) of every ``lapack.*``
span of ``elementalx_torch.trace`` in the traced calls, over the solves
the program recorded: the drivers' Python and torch dispatch outside
blas. The host's wait for the device in ``lapack.cholesky.nan_check`` is
left out: it measures how far the device lags, not host work. Taken
under the profiler, which adds to every torch op's host cost: compare it
traced against traced only. Nothing to read where the program records no
spans or no solve."""

import sys

UNIT = "ms"
LAYER = "lapack."
WAITS = ("lapack.cholesky.nan_check",)


def read(t: dict):
    mod = sys.modules.get("elementalx_torch.trace")
    if not t.get("calls") or mod is None:
        return None
    s = mod.summary()
    if not s["solves"]:
        return None
    return sum(v["self_ms"] for n, v in s["spans"].items()
               if n.startswith(LAYER) and n not in WAITS) / s["solves"]
