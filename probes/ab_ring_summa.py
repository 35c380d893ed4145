"""K8 (the ring SUMMA) of two copies of the port, in turns, on one card.

Usage, from the root of the repository, on a machine with an NVIDIA GPU:

    python probes/ab_ring_summa.py ROOT_A ROOT_B

Each ROOT holds an ``elementalx_torch`` package (for example ``.`` and an
unpacked ``git archive`` of the parent commit in a directory that
.gitignore lists). The runs go A, B, B, A, each in its own process, so
each copy builds its own kernel library (under its own package) once.
Each run prints, for float32 and bfloat16 at M = K = N = 16384 on a 2x2
virtual grid on cuda:0: the mean kernel time of three launches (CUDA
events), the largest difference from the plain version, and the
registers nvcc gave each K8 instance (its ``-Xptxas -v`` report).
"""

import subprocess
import sys

CHILD = r'''
import sys
sys.path.insert(0, sys.argv[1])
import torch
import elementalx_torch as Et
from elementalx_torch.kernels import common
from elementalx_torch.kernels.ring_summa import (ring_summa_kernel,
                                                 ring_summa_plain)

common.kernel_library()
log = (common.library_path().parent / "build.log").read_text().splitlines()
regs = {}
for i, line in enumerate(log):
    if "Compiling entry function" in line and "ring_kernel" in line:
        inst = line.split("ring_kernel")[1].split("EEv")[0]
        for later in log[i:i + 6]:
            if "Used" in later:
                regs[inst] = later.split("Used")[1].split(",")[0].strip()
                break
dev = torch.device("cuda", 0)
grid = Et.Grid([dev] * 4, height=2)
gen = torch.Generator(device=dev).manual_seed(0)
n = 16384
out = []
for dt in (torch.float32, torch.bfloat16):
    av, bv = ([x.contiguous() for x in Et.Copy(Et.DistMatrix.from_global(
        torch.randn((n, n), generator=gen, device=dev).to(dt), grid=grid),
        Et.VC, Et.STAR).blocks] for _ in range(2))
    c, ref = ring_summa_kernel(av, bv), ring_summa_plain(av, bv)
    err = max((x.double() - y.double()).abs().max().item()
              for x, y in zip(c, ref))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        ring_summa_kernel(av, bv)
    e1.record()
    e1.synchronize()
    out.append(f"{str(dt)[6:]} {e0.elapsed_time(e1) / 3:.2f} ms "
               f"(max|kernel - plain| {err:.3e})")
print(sys.argv[1], "|", "; ".join(out), "| registers", regs)
'''


def main() -> None:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    a, b = sys.argv[1:]
    for root in (a, b, b, a):
        run = subprocess.run([sys.executable, "-c", CHILD, root],
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise SystemExit(run.stderr[-4000:])
        print(run.stdout.strip())


if __name__ == "__main__":
    main()
