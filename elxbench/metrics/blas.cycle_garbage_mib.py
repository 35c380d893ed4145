"""blas.cycle_garbage_mib: device memory that the caller's collection after
each call of the window frees, over the window's calls, in MiB: what a
solve leaves held by reference cycles (Trsm's recursive closure keeps its
prepared n x n triangle) instead of freeing it on return. It reads 0 once
a solve leaves no such cycle. Without a CUDA card there is no device
memory to read."""

UNIT = "MiB"


def read(t: dict):
    freed = t.get("cycle_bytes_per_call")
    return None if freed is None else freed / 2 ** 20
