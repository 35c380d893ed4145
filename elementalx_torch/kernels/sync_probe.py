"""The cost of the synchronisation steps K4 and K6 are built from, on the
card: ``csrc/sync_probe.cu``. Not a kernel of any path; ``chip_smoke.py``
and ``probes/k4_k6.py`` read the chain floors of K4 (one cluster barrier
and one DSMEM round trip a column) and K6 (three cluster barriers an op)
from it."""

from __future__ import annotations

import ctypes

import torch

from .common import check_launch, kernel_function

KINDS = {"grid.sync": 0, "cluster barrier": 1,
         "cluster barrier + DSMEM read": 2}


def step_us(kind: str, ctas: int, iters: int = 4000,
            device: int = 0) -> float:
    """Microseconds of one step of ``kind`` (a key of KINDS) over ``ctas``
    CTAs (a cooperative grid for "grid.sync", one cluster otherwise): two
    launches of ``iters`` and 2 ``iters`` steps timed with CUDA events,
    the difference over ``iters`` (the launch's own cost cancels)."""
    fn = kernel_function("elx_sync_probe", (ctypes.c_int,) * 3
                         + (ctypes.c_void_p,) * 2)
    with torch.cuda.device(device):
        sink = torch.zeros((1,), dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run(k: int) -> float:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            check_launch(fn(KINDS[kind], ctas, k, sink.data_ptr(), stream),
                         "elx_sync_probe")
            e1.record()
            e1.synchronize()
            return e0.elapsed_time(e1)

        run(iters)
        best = min(run(2 * iters) - run(iters) for _ in range(3))
    return best * 1e3 / iters
