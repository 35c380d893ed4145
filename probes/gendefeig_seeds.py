"""GenDefEig's scaled residual at n = 8192 over seeds, for one or more
copies of the port, on one card.

Usage, from the root of the repository, on a machine with an NVIDIA GPU:

    python3 probes/gendefeig_seeds.py ROOT [ROOT ...] [--stages] \
        [--dump-de] [--seeds 0 1 2]

Each ROOT holds an ``elementalx_torch`` package (for example ``.`` and an
unpacked ``git archive`` of the parent commit in a directory that
.gitignore lists); each runs in its own process and builds its own kernel
library. For every seed, the pencil of ``entry.make_gendef_problem(8192,
seed=seed)`` (float32) goes through ``gen_def_eig_step(a, b, "AXBX")``
with the fused Cholesky tail (``ELX_PALLAS_POTRF=1``), as chip_smoke.py's
phase 11 runs it at seed 0, and the probe prints:

- the step's scaled residual max|AX-BXW| / (eps n (max|A| + max|w|
  max|B|) max|X|) and its B-orthogonality max|X^T B X - I| / (eps n),
  the gates of phase 11 (both under 100);
- phase 11's split of the eigensolver's share: HermitianEig's own scaled
  residual on C = L^-1 A L^-T, times the growth of its largest entry
  through L, times the change of units to the pencil's metric.

With ``--stages``, each seed also prints where X's B-orthogonality goes,
each as max|Q^T Q - I| / (eps n) in float64: Z = L^T X (C's
eigenvectors as GenDefEig returns them), and for C again through
HermitianTridiag (latrd, K5) and through SBR b=256 (K6): the
tridiagonal's eigenvectors from ``tridiag_eig`` and, for latrd, Q after
the backtransform.

With ``--dump-de``, each seed also prints the (d, e) that latrd (K5)
makes of C, the input of ``tridiag_eig`` behind the orthogonality that
``--stages`` reads, as lines ``de <name> <i>/<count> <text>``: the
little-endian float32 bytes of each array, zlib-compressed and base64
encoded, cut into pieces of 8000 characters (join the pieces of a name
in order, decode, decompress), and then the orthogonality of
``tridiag_eig``'s vectors of that (d, e).

After the card's name and power limit, one line per (ROOT, seed).
"""

import subprocess
import sys

CHILD = r'''
import base64
import os
import sys
import zlib
sys.path.insert(0, sys.argv[1])
import torch
import elementalx_torch as Et
from elementalx_torch.entry import gen_def_eig_step, make_gendef_problem
from elementalx_torch.lapack import condense, sbr, tridiag_eig

dev = torch.device("cuda", 0)
ng = 8192
eps = torch.finfo(torch.float32).eps
os.environ["ELX_PALLAS_POTRF"] = "1"
stages = "--stages" in sys.argv
dump = "--dump-de" in sys.argv


def orth(q):
    q = q.double()
    return ((q.mT @ q - torch.eye(q.shape[1], device=dev,
                                  dtype=torch.float64)).abs().max()
            / (eps * ng)).item()


for seed in (int(a) for a in sys.argv[2:] if not a.startswith("--")):
    ga, gb = make_gendef_problem(ng, device=dev, seed=seed)
    GA = Et.DistMatrix.from_global(ga, grid=Et.Grid(dev))
    GB = Et.DistMatrix.from_global(gb, grid=Et.Grid(dev))
    GL = Et.Cholesky(Et.LOWER, GB)
    GC = Et.TwoSidedTrsm(Et.LOWER, Et.NON_UNIT, GA, GL)
    wg, xg, rg = gen_def_eig_step(ga, gb, "AXBX")
    torch.cuda.synchronize()
    Ld = GL.data[:ng, :ng].double().tril()
    Cd = GC.data[:ng, :ng].double()
    Cd = Cd.tril() + Cd.tril(-1).mT
    del GA, GB, GL, GC
    ad, bd, xd, wd = ga.double(), gb.double(), xg.double(), wg.double()
    borth = ((xd.mT @ (bd @ xd) - torch.eye(ng, device=dev,
                                            dtype=torch.float64)).abs().max()
             / (eps * ng)).item()
    zd = Ld.mT @ xd
    R = Cd @ zd - zd * wd[None, :]
    wmax, rmax = wd.abs().max(), R.abs().max()
    r_std = (rmax / (eps * ng * wmax)).item()
    grow = (Ld @ R).abs().max().item() / rmax.item()
    units = (wmax / ((ad.abs().max() + wmax * bd.abs().max())
                     * xd.abs().max())).item()
    print(f"{sys.argv[1]} seed {seed}: scaled residual {rg.item():.4f} "
          f"(gate 100), B-orthogonality {borth:.4f}; eigensolver share = "
          f"HermitianEig's residual on C {r_std:.4f} x growth through L "
          f"{grow:.4f} x units {units:.4f} = {r_std * grow * units:.4f}",
          flush=True)
    if dump:
        fact = condense.HermitianTridiag(
            Et.LOWER, Et.DistMatrix.from_global(Cd.float(), grid=Et.Grid(dev)))
        for name, arr in (("d", fact.d), ("e", fact.e)):
            raw = arr.float().cpu().numpy().astype("<f4").tobytes()
            text = base64.b64encode(zlib.compress(raw, 9)).decode()
            pieces = [text[i:i + 8000] for i in range(0, len(text), 8000)]
            for i, piece in enumerate(pieces):
                print(f"de {name} {i}/{len(pieces)} {piece}", flush=True)
        _, zt = tridiag_eig.tridiag_eig(fact.d, fact.e)
        print(f"{sys.argv[1]} seed {seed}: C through latrd: tridiag_eig's "
              f"vectors {orth(zt):.4f}", flush=True)
        del fact, zt
    if stages:
        c32 = Cd.float()
        fact = condense.HermitianTridiag(
            Et.LOWER, Et.DistMatrix.from_global(c32, grid=Et.Grid(dev)))
        _, zt = tridiag_eig.tridiag_eig(fact.d, fact.e)
        q = condense.tridiag_apply_q(fact, zt, False)
        sf = sbr.sbr_tridiag(c32, 256)
        _, zs = tridiag_eig.tridiag_eig(sf.d, sf.e)
        print(f"{sys.argv[1]} seed {seed}: orthogonality of Z = L^T X "
              f"{orth(zd):.4f}; C through latrd: tridiag_eig's vectors "
              f"{orth(zt):.4f}, after the backtransform {orth(q):.4f}; C "
              f"through SBR b=256: tridiag_eig's vectors {orth(zs):.4f}",
              flush=True)
        del c32, fact, zt, q, sf, zs
    del Ld, Cd, ad, bd, xd, wd, zd, R, ga, gb, wg, xg
    torch.cuda.empty_cache()
'''


def main():
    args = sys.argv[1:]
    seeds = ["0", "1", "2"]
    flags = [a for a in args if a in ("--stages", "--dump-de")]
    args = [a for a in args if a not in flags]
    if "--seeds" in args:
        i = args.index("--seeds")
        args, seeds = args[:i], args[i + 1:]
    if not args:
        sys.exit(__doc__)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for root in args:
        subprocess.run([sys.executable, "-c", CHILD, root, *seeds, *flags],
                       check=True)


if __name__ == "__main__":
    main()
