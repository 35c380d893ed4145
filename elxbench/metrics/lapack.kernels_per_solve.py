"""lapack.kernels_per_solve: device kernels (copies and fills left out) in
the traced calls over the number of calls: what the lapack drivers
launch for one solve."""

UNIT = "count"


def read(t: dict):
    if not t.get("calls"):
        return None
    return t["kernels"] / t["calls"]
