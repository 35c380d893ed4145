"""blas.host_self_ms: blas's own host time a solve, in ms: the self time
(host time less that of child spans) of every ``blas.*`` span of
``elementalx_torch.trace`` in the traced calls, over the solves the
program recorded, or over the traced calls where the call is no lapack
solve (a Gemm): trinv's loop, Trsm's recursion and K1's wrapper. Taken
under the profiler, which adds to every torch op's host cost: compare it
traced against traced only. Nothing to read where the program records
neither a solve nor a blas span."""

import sys

UNIT = "ms"
LAYER = "blas."


def read(t: dict):
    mod = sys.modules.get("elementalx_torch.trace")
    if not t.get("calls") or mod is None:
        return None
    s = mod.summary()
    blas = [v["self_ms"] for n, v in s["spans"].items()
            if n.startswith(LAYER)]
    solves = s["solves"] or (t["calls"] if blas else 0)
    if not solves:
        return None
    return sum(blas) / solves
