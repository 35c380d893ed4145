"""A/B of the minimum-norm branch of LeastSquares on one NVIDIA GPU.

Two routes to X = A^H (A A^H)^{-1} B for a wide A (m < n):

- "lq": the JAX package's route. L Q = LQ(A) = QR(A^H)^H, a Trsm with L,
  then Q^H applied through the QR factor recovered as Adjoint(packed):
  three K9 transposes of an m x n array.
- "qr": the port's route. QR(A^H) once, a Trsm with R^H read as a view:
  one K9 transpose.

Both run in turns (lq, qr, qr, lq, twice, after one warm run each) at
m=8192, n=16384, nrhs=256 float32, timed on the host clock around a
synchronised call, with their K9 transpose launches counted. ExplicitQR
at n=8192, timed before and after, shows how far the host clock drifts
during the call. Last, K9's axpby at the residual Gemm's 16384 x 256
is timed with CUDA events three ways: with Python numbers for alpha and
beta (each placed on the card by a fill launch), with 0-d tensors made
once on the card, and as torch.add.

Usage, from the root of the repository, on a machine with the card:
``python3 probes/ab_ls_min_norm.py``
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import elementalx_torch as Et  # noqa: E402
from elementalx_torch.blas.level1 import Adjoint, GetSubmatrix  # noqa: E402
from elementalx_torch.blas.trsm import Trsm  # noqa: E402
from elementalx_torch.core.dmatrix import DistMatrix, padded_extent  # noqa: E402
from elementalx_torch.entry import make_ls_problem  # noqa: E402
from elementalx_torch.kernels import elementwise as k9  # noqa: E402
from elementalx_torch.lapack.euclidean_min import LeastSquares  # noqa: E402
from elementalx_torch.lapack.lq import LQ  # noqa: E402
from elementalx_torch.lapack.qr import ApplyQ, QRFactorization  # noqa: E402


def via_lq(A: DistMatrix, B: DistMatrix) -> DistMatrix:
    """The minimum-norm solution through LQ(A), as the JAX package's
    LeastSquares computes it."""
    m, n = A.m, A.n
    fact = LQ(A)
    Lsq = GetSubmatrix(fact.packed, slice(0, m), slice(0, m))
    Y = Trsm(Et.LEFT, Et.LOWER, Et.NORMAL, Et.NON_UNIT, 1.0, Lsq, B)
    Ydat = Y.redistribute(Et.MC, Et.MR).data
    full = k9.fill((padded_extent(n, A.grid), Ydat.shape[1]), 0.0,
                   Ydat.dtype, Ydat.device)
    full[:m, : Y.n] = Ydat[:m, : Y.n]
    Yfull = DistMatrix.from_padded(full, n, Y.n, Et.MC, Et.MR, A.grid,
                                   A.wrap)
    qr_fact = QRFactorization(Adjoint(fact.packed), fact.tau.conj())
    return ApplyQ(False, qr_fact, Yfull)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ab_ls_min_norm: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    def host_ms(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    grid = Et.Grid(dev)
    q = torch.randn((8192, 8192), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    Q8 = Et.DistMatrix.from_global(q, grid=grid)
    Et.ExplicitQR(Q8)
    _, control0 = host_ms(lambda: Et.ExplicitQR(Q8))

    a, b = make_ls_problem(8192, 16384, 256, device=dev)
    A = Et.DistMatrix.from_global(a, grid=grid)
    B = Et.DistMatrix.from_global(b, grid=grid)
    routes = {"lq": lambda: via_lq(A, B),
              "qr": lambda: LeastSquares(Et.NORMAL, A, B)}
    outs, times, transposes = {}, {"lq": [], "qr": []}, {}
    for name, fn in routes.items():
        k9.transpose.launches = 0
        outs[name], _ = host_ms(fn)
        transposes[name] = k9.transpose.launches
    for name in ("lq", "qr", "qr", "lq") * 2:
        _, ms = host_ms(routes[name])
        times[name].append(ms)
    _, control1 = host_ms(lambda: Et.ExplicitQR(Q8))
    x_lq = outs["lq"].data[:16384, :256].double()
    x_qr = outs["qr"].data[:16384, :256].double()
    rel = ((x_lq - x_qr).norm() / x_lq.norm()).item()
    if not rel < 1e-4:
        raise SystemExit(f"ab_ls_min_norm: the routes differ by {rel}")
    for name in ("lq", "qr"):
        ts = times[name]
        print(f"min-norm LeastSquares via {name}, m=8192 n=16384 nrhs=256 "
              f"f32: K9 transposes {transposes[name]}; host ms "
              f"{', '.join(f'{t:.1f}' for t in ts)} (median "
              f"{sorted(ts)[len(ts) // 2]:.1f})")
    print(f"||X_lq - X_qr|| / ||X_lq|| = {rel:.3e}; ExplicitQR n=8192 "
          f"control: {control0:.1f} ms before, {control1:.1f} ms after")

    def event_ms(fn, iters=50):
        fn()
        sync()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / iters

    x = torch.randn((16384, 256), device=dev)
    y = torch.randn((16384, 256), device=dev)
    al = torch.full((), 0.3, device=dev)
    be = torch.full((), 1.0, device=dev)
    calls = {"axpby, Python alpha and beta": lambda: k9.axpby(0.3, x, 1.0, y),
             "axpby, 0-d alpha and beta on the card":
                 lambda: k9.axpby(al, x, be, y),
             "torch.add(y, x, alpha=0.3)": lambda: torch.add(y, x, alpha=0.3)}
    got = {name: [] for name in calls}
    for name in list(calls) + list(reversed(calls)):
        got[name].append(event_ms(calls[name]))
    for name, ts in got.items():
        print(f"K9 16384x256 f32 {name}: {sum(ts) / len(ts):.4f} ms per call"
              f" (CUDA events, 50 calls back to back, two turns)")


if __name__ == "__main__":
    main()
