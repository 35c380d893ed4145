"""The paths that run K3a or K3b, timed for one or more copies of the port
on one card, each copy in its own process, in turns.

Usage, from the root of the repository, on a machine with an NVIDIA GPU:

    python3 probes/hpd_paths.py ROOT [ROOT ...] [--rounds 2] [--f64-only]

Each ROOT holds an ``elementalx_torch`` package (for example ``.`` and an
unpacked ``git archive`` of the parent commit in a directory that
.gitignore lists). A round runs every root once, in the order given and
then reversed (A B B A). Each run prints, with chip_smoke.py's shapes and
seeds:

- the HPD solve at n = 16384, nrhs = 256, float32 (``entry()``), on the
  default path (K3a) and with the fused tail (``ELX_PALLAS_POTRF=1``,
  K3b): the first and the best of three warm steps, ms, host clock
  around a synchronised run, and the scaled residual;
- the bfloat16-storage Cholesky at n = 16384, default and fused: the best
  of three, ms;
- HermitianGenDefEig AXBX at n = 8192 with the fused tail (K3b at
  (8192, 2048)): one step, ms, and its scaled residual;
- the HPD solve at n = 16384, nrhs = 256 in float64 (every K1 product on
  the FMA core in trees before the FP64 tensor-core core, on "dmma"
  after it): the first and the best of three warm steps, ms, its scaled
  residual and K1's launches by core. ``--f64-only`` runs this path
  alone.

After the card's name and power limit, one line per (root, path).
"""

import subprocess
import sys

CHILD = r'''
import importlib
import os
import sys
import time
sys.path.insert(0, sys.argv[1])
import torch
import elementalx_torch as Et
from elementalx_torch.entry import entry, gen_def_eig_step, make_gendef_problem

root = sys.argv[1]
f64_only = sys.argv[2] == "1"
dev = torch.device("cuda", 0)
sync = torch.cuda.synchronize


def timed(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return (time.perf_counter() - t0) * 1e3, out


n, nrhs = 16384, 256
eps = torch.finfo(torch.float32).eps
for label, fused in (() if f64_only else (("default (K3a)", False),
                                           ("fused tail (K3b)", True))):
    if fused:
        os.environ["ELX_PALLAS_POTRF"] = "1"
    else:
        os.environ.pop("ELX_PALLAS_POTRF", None)
    step, (a, b) = entry(n=n, nrhs=nrhs, dtype=torch.float32, device=dev)
    first, (x, _) = timed(lambda: step(a, b))
    best = min(timed(lambda: step(a, b))[0] for _ in range(3))
    resid = ((a.double() @ x.double() - b.double()).abs().max()
             / (eps * n * b.double().abs().max())).item()
    print(f"{root} HPD n={n} nrhs={nrhs} f32, {label}: first {first:.1f} ms, "
          f"best warm {best:.1f} ms, scaled residual {resid:.4f}",
          flush=True)
    A16 = Et.DistMatrix.from_global(a.bfloat16(), grid=Et.Grid(dev))
    best16 = min(timed(lambda: Et.Cholesky(Et.LOWER, A16))[0]
                 for _ in range(3))
    print(f"{root} Cholesky bf16 storage n={n}, {label}: best {best16:.1f} ms",
          flush=True)
    del a, b, x, A16
if not f64_only:
    os.environ["ELX_PALLAS_POTRF"] = "1"
    ga, gb = make_gendef_problem(8192, device=dev)
    gen_def_eig_step(ga, gb, "AXBX")
    ms, (w, X, r) = timed(lambda: gen_def_eig_step(ga, gb, "AXBX"))
    print(f"{root} GenDefEig AXBX n=8192 f32, fused tail: {ms:.1f} ms "
          f"(second run), scaled residual {r.item():.4f}", flush=True)
    del ga, gb, w, X
    os.environ.pop("ELX_PALLAS_POTRF", None)
mm = importlib.import_module("elementalx_torch.kernels.matmul")
step, (a, b) = entry(n=n, nrhs=nrhs, dtype=torch.float64, device=dev)
mm.reset_launches()
first, (x, _) = timed(lambda: step(a, b))
cores = {c: getattr(mm.matmul, f"launches_{c}") for c in mm.CORES}
best = min(timed(lambda: step(a, b))[0] for _ in range(3))
resid = ((a @ x - b).abs().max() / (torch.finfo(torch.float64).eps * n
                                     * b.abs().max())).item()
print(f"{root} HPD n={n} nrhs={nrhs} f64: first {first:.1f} ms, best warm "
      f"{best:.1f} ms, scaled residual {resid:.4f}, K1 launches {cores}",
      flush=True)
'''


def main():
    args = sys.argv[1:]
    rounds = 1
    f64_only = "--f64-only" in args
    args = [x for x in args if x != "--f64-only"]
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        args = args[:i] + args[i + 2:]
    if not args:
        sys.exit(__doc__)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for _ in range(rounds):
        for root in args + args[::-1]:
            subprocess.run([sys.executable, "-c", CHILD, root,
                            str(int(f64_only))], check=True)


if __name__ == "__main__":
    main()
