"""How many of ten K9 launches torch.profiler records, in a bare window
and in a scheduled one, on one card.

Usage, from the root of the repository, on a machine with an NVIDIA GPU:

    python3 probes/profiler_window.py

Prints the card's name and power limit, then replays what chip_smoke.py
does before its K9 launch check: the HPD step at n = 16384 under CPU+CUDA
profiles (fused tail, then default), then, ten times for each window kind
in turns (bare, scheduled, bare, scheduled), 1050 unsynchronised
axpby calls at 16384 x 256 followed by a profile window of ten calls:

- "bare": a window opened just before the ten calls (the first design of
  the check);
- "scheduled": the ten calls in the recorded step of a window with a
  warm-up step of the same calls before it and 20 ms of idle host time
  around each step (``window_kernels`` in chip_smoke.py).

For each window it prints how many device kernels the profiler recorded,
and any that are not K9's. About a minute with the build.
"""

import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, schedule

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from elementalx_torch.entry import entry  # noqa: E402
from elementalx_torch.kernels import common  # noqa: E402
from elementalx_torch.kernels import elementwise as k9  # noqa: E402

CUDA = torch.autograd.DeviceType.CUDA


def sync():
    torch.cuda.synchronize()


def main():
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    common.kernel_library()
    dev = torch.device("cuda", 0)
    step, (a, b) = entry(n=16384, nrhs=256, dtype=torch.float32, device=dev)
    step(a, b)
    sync()
    for label in ("fused tail", "default"):
        if label == "fused tail":
            os.environ["ELX_PALLAS_POTRF"] = "1"
        else:
            os.environ.pop("ELX_PALLAS_POTRF", None)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(a, b)
            sync()
        print(f"HPD step ({label}): "
              f"{sum(e.device_type == CUDA for e in prof.events())} "
              f"device events")
    del a, b
    x = torch.randn(16384, 256, device=dev)
    y = torch.randn(16384, 256, device=dev)

    def call():
        k9.axpby(0.3, x, 1.0, y)

    def host():
        for _ in range(1050):
            call()
        sync()

    def bare():
        host()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            sync()
        return [e.name for e in prof.events() if e.device_type == CUDA]

    def scheduled():
        host()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                time.sleep(0.02)
                for _ in range(10):
                    call()
                sync()
                time.sleep(0.02)
                prof.step()
        return [e.name for e in prof.events() if e.device_type == CUDA]

    for name, fn in (("bare", bare), ("scheduled", scheduled),
                     ("bare", bare), ("scheduled", scheduled)):
        seen = [fn() for _ in range(10)]
        foreign = [k for s in seen for k in s if "ew_flat_kernel" not in k]
        print(f"{name}: kernels recorded per window of 10 calls "
              f"{[len(s) for s in seen]}, not K9's {foreign[:3]}")


if __name__ == "__main__":
    main()
