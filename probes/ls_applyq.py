"""ApplyQ on the T's that QR kept against ApplyQ rebuilding a T for every
block, on one NVIDIA GPU, at the least-squares cell's shape (square float32
A, n = 16384, nrhs = 256; QR takes 512-wide panels there).

- One ``LeastSquares(NORMAL, A, B)`` with ``qr.applyq_blocks`` reset: the
  blocks ApplyQ applied with a stored T and those it built a T for.
- ``ApplyQ(True, fact, B)`` on the stored T's ("stored") and with
  ``blocksize=Blocksize()`` ("rebuilt": ApplyPackedReflectors, a
  ``build_wy_T`` for every 128-column block), after a warm run each, in
  turns (rebuilt, stored, stored, rebuilt) three times: host ms around a
  synchronised call, then in one more call each the torch ops dispatched
  (a dispatch mode) and the kernels the profiler saw.
- max|stored - rebuilt| / max|rebuilt|.

Prints one JSON line a measurement, the card's name and power limit first.

Usage, from the root of the repository, on a machine with the card:
``python3 probes/ls_applyq.py [--n 16384] [--nrhs 256]``
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import elementalx_torch as Et  # noqa: E402
from elementalx_torch.core.environment import Blocksize  # noqa: E402
from elementalx_torch.entry import make_ls_problem  # noqa: E402
from elementalx_torch.lapack import qr  # noqa: E402


class _Ops(TorchDispatchMode):
    """Counts the torch ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _kernels(fn) -> int:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--nrhs", type=int, default=256)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip(), "n": args.n, "nrhs": args.nrhs}))
    dev = torch.device("cuda", 0)
    grid = Et.Grid(dev)
    a, b = make_ls_problem(args.n, args.n, args.nrhs, device=dev, seed=17)
    A = Et.DistMatrix.from_global(a, grid=grid)
    B = Et.DistMatrix.from_global(b, grid=grid)

    Et.LeastSquares(Et.NORMAL, A, B)  # builds the kernels
    qr.applyq_blocks.update(stored=0, rebuilt=0)
    solve_ms = _ms(lambda: Et.LeastSquares(Et.NORMAL, A, B))
    print(json.dumps({"least_squares_ms": solve_ms,
                      "applyq_blocks_a_solve": dict(qr.applyq_blocks)}))

    fact = qr.QR(A)
    routes = {"stored": lambda: qr.ApplyQ(True, fact, B),
              "rebuilt": lambda: qr.ApplyQ(True, fact, B, Blocksize())}
    for fn in routes.values():
        fn()
    times = {k: [] for k in routes}
    for _ in range(3):
        for k in ("rebuilt", "stored", "stored", "rebuilt"):
            times[k].append(_ms(routes[k]))
    for k, fn in routes.items():
        ops = _Ops()
        with ops:
            fn()
        print(json.dumps({"route": k, "panel_width": fact.panel_width,
                          "host_ms": times[k],
                          "median_ms": statistics.median(times[k]),
                          "ops_a_call": ops.n,
                          "kernels_a_call": _kernels(fn)}))
    got, want = (routes[k]().replicated() for k in ("stored", "rebuilt"))
    rel = float((got - want).abs().max() / want.abs().max())
    print(json.dumps({"max_rel_stored_vs_rebuilt": rel}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
