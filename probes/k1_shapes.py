"""K1's calls on the main paths, by route and shape class, on the CPU.

Usage, from the root of the repository (no card needed, about a minute):

    python3 probes/k1_shapes.py

It runs each slice's entry point once at a small order on CPU tensors
(the distributed step on a 2x2 grid of CPU positions) and records every
K1 call: the route ``matmul.route`` gives its operands (the wrappers take
the plain version on the CPU, so nothing launches) and whether C has at
most 16 rows or at most 16 columns. It prints, per slice, the calls by
route and the shapes of the calls with M <= 16 or N <= 16 (the skinny
route's question: whether a C = (B^T A^T)^T route for few rows would
have any caller). The orders are small, so shapes that scale with n
read smaller here than on the card; which calls are skinny does not
change with n.
"""

import collections
import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import elementalx_torch as Et  # noqa: E402
from elementalx_torch import entry as E  # noqa: E402
from elementalx_torch.core.grid import Grid  # noqa: E402
from elementalx_torch.lapack.hermitian_eig import HermitianEigCtrl  # noqa: E402


def main():
    Grid.set_default(Grid("cpu"))
    mm = importlib.import_module("elementalx_torch.kernels.matmul")
    orig = mm.matmul
    routes = collections.defaultdict(collections.Counter)
    skinny = collections.defaultdict(collections.Counter)
    current = [""]

    def spy(a, b, out_dtype=None):
        M, K = a.shape
        N = b.shape[1]
        routes[current[0]][mm.route(a, b)] += 1
        if M <= 16 or N <= 16:
            skinny[current[0]][(str(a.dtype)[6:], M, K, N)] += 1
        return orig(a, b, out_dtype)

    # every module that imported the wrapper by name calls the spy
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("elementalx_torch") \
                and getattr(mod, "matmul", None) is orig:
            mod.matmul = spy
    mm.matmul = spy

    def run(name, fn):
        current[0] = name
        fn()

    g22 = Et.Grid(["cpu"] * 4, height=2)
    current[0] = "make_dist_problem n=1024 2x2 (the HPD solve of its x)"
    a, b, x, gm = E.make_dist_problem(1024, g22, torch.float32, seed=0)
    run("dist_gemm_step n=1024 2x2",
        lambda: E.dist_gemm_step(a, b, x, gm, g22))
    a, b = E.make_hpd_problem(1024, 256, device="cpu")
    run("hpd_solve_step n=1024", lambda: E.hpd_solve_step(a, b))
    a, b = E.make_lu_problem(1024, 256, device="cpu")
    run("linear_solve_step n=1024", lambda: E.linear_solve_step(a, b))
    h = E.make_eig_problem(1024, device="cpu")
    run("hermitian_eig_step latrd n=1024", lambda: E.hermitian_eig_step(
        h, HermitianEigCtrl(tridiag_alg="latrd")))
    run("hermitian_eig_step sbr n=1024", lambda: E.hermitian_eig_step(
        h, HermitianEigCtrl(tridiag_alg="sbr")))
    a, b = E.make_gendef_problem(1024, device="cpu")
    run("gen_def_eig_step n=1024", lambda: E.gen_def_eig_step(a, b))
    a, b = E.make_ls_problem(1024, 1024, 256, device="cpu")
    run("least_squares_step 1024^2", lambda: E.least_squares_step(a, b))
    a, b = E.make_ls_problem(512, 1024, 256, device="cpu")
    run("least_squares_step 512 x 1024",
        lambda: E.least_squares_step(a, b))
    for name in routes:
        calls = ", ".join(f"{k} {v}" for k, v in sorted(routes[name].items()))
        few = "; ".join(f"{dt} ({M}x{K})x({K}x{N}) {c}"
                        for (dt, M, K, N), c in sorted(skinny[name].items()))
        print(f"{name}: K1 calls by route: {calls}; with M <= 16 or "
              f"N <= 16: {few or 'none'}")


if __name__ == "__main__":
    main()
