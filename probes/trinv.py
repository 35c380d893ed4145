"""K10 (the triangular inverse) against the plain chain it replaced and
against its bound, on one NVIDIA GPU, at the shapes the main paths give it.

For each shape, float32 and float64:

- device ms a call of K10 and of the plain chain (``trinv_plain``, the
  JAX package's log-depth tree of batched products), from torch.profiler:
  the device kernels of 20 calls, recorded in the second step of a
  scheduled window, summed and divided by 20; the kernels a call;
- host us a call (200 calls issued without a synchronisation) and wall ms
  a synchronised call, kernel and chain in turns (chain, kernel, kernel,
  chain);
- the same three readings of the library's batched triangular solve
  against I, ``torch.linalg.solve_triangular(U, I, upper=True,
  unitriangular=unit)`` (cuBLAS trsm, reading only the triangle), between
  the kernel's two;
- the bound: max(n^3/3 operations a matrix at 67 TFLOP/s, U's triangle
  read and X written at 3.35 TB/s), and the device ms at every stripe
  width (``_launch``), the widest first;
- max|K10 - chain| / max|chain| on the same input.

The shapes: QR's CholeskyQR2 panel (1 x 512 upper, row-major as W and
column-major as R1 = L1.mT), LU's panels (1 x 1024
and 1 x 512, unit lower through .mT), Trsm's 32 diagonal 512 x 512 blocks
of a 16384^2 triangle (one strided view), ``build_wy_T``'s 128-wide
blocks (1 x 128 and a batch of 64), and 1 x 2048 and 1 x 8192
(``tridiag_eig``'s cluster QR, column-major), which the wrapper inverts in
diagonal blocks of 1024 joined by K1 products.
First, nvcc's report (registers, spills) for the kernel's instances.
Last, the cells' steps at n = 16384 (HPD f32 and f64, LU f32, LS f32),
each once under torch.profiler: the triangular inverses they make (the
``blas.trinv`` spans) against K10's launches, which are equal where every
inverse is one launch.

Prints one JSON line a measurement, the card's name and power limit first.

Usage, from the root of the repository, on a machine with the card:
``python3 probes/trinv.py``
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, schedule

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from elementalx_torch import trace  # noqa: E402
from elementalx_torch.entry import (  # noqa: E402
    hpd_solve_step,
    least_squares_step,
    linear_solve_step,
    make_hpd_problem,
    make_ls_problem,
    make_lu_problem,
)
from elementalx_torch.kernels import common  # noqa: E402
from elementalx_torch.kernels.trinv import (  # noqa: E402
    WIDTHS,
    _launch,
    trinv,
    trinv_plain,
)

PEAK_FLOPS = 67e12  # FP32 FMA; FP64 on the tensor cores
PEAK_BYTES = 3.35e12
CALLS = 20


def device_ms(fn):
    """(device ms a call, device kernels a call) of fn, from the kernels
    torch.profiler records for CALLS calls in the second step of a
    scheduled window (a warm-up step of the same calls first, 20 ms of
    idle host time around each)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(0.02)
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
            prof.step()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in evs) / 1e3 / CALLS,
            len(evs) / CALLS)


def host_us(fn, calls=200):
    """Host us a call of fn, issued back to back without a synchronise."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def wall_ms(fn, calls=20):
    """Wall ms of one synchronised call of fn (median of calls)."""
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)[len(out) // 2]


def upper(batch, n, dtype, dev, gen):
    """Upper triangles with entries N(0, 1/n^2) above a diagonal in
    [1, 2), NaN below it (the kernel never reads those)."""
    a = torch.randn((batch, n, n), generator=gen, device=dev,
                    dtype=torch.float64) / n
    a = torch.triu(a, 1) + torch.diag_embed(
        1 + torch.rand((batch, n), generator=gen, device=dev,
                       dtype=torch.float64))
    a = a.masked_fill(torch.ones(n, n, dtype=torch.bool,
                                 device=dev).tril(-1), float("nan"))
    return a.to(dtype)


def case(name, dtype, dev, gen):
    """(argument the path passes, unit, clean (batch, n, n) upper
    triangle) of the shape ``name``."""
    if name == "trsm 32x512":
        n, nb = 16384, 512
        T = torch.full((n, n), float("nan"), dtype=dtype, device=dev)
        s0, s1 = T.stride()
        view = T.as_strided((n // nb, nb, nb), (nb * (s0 + s1), s0, s1))
        view.copy_(upper(n // nb, nb, dtype, dev, gen))
        return view, False, torch.triu(torch.nan_to_num(view))
    batch, n = {"qr 1x512": (1, 512), "qr 1x512 .mT": (1, 512),
                "lu 1x1024 unit": (1, 1024),
                "lu 1x512 unit": (1, 512), "wy 1x128": (1, 128),
                "wy 64x128": (64, 128), "1x2048": (1, 2048),
                "1x8192 .mT": (1, 8192)}[name]
    U = upper(batch, n, dtype, dev, gen)
    clean = torch.triu(torch.nan_to_num(U))
    if name.endswith(".mT"):
        # R1 = L1.mT and L2.mT: a lower Cholesky factor read transposed
        return U.mT.contiguous().mT, False, clean
    if "unit" in name:
        U.diagonal(dim1=-2, dim2=-1).fill_(float("nan"))
        clean.diagonal(dim1=-2, dim2=-1).fill_(1)
        # the LU path's unit lower triangle (contiguous), read through .mT
        return U.mT.contiguous(), True, clean
    return U, False, clean


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}))
    common.kernel_library()
    log = (common.library_path().parent / "build.log").read_text()
    report, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S*)'", line)
        if m:
            fn = m.group(1) if "trinv_kernel" in m.group(1) else None
        elif fn and ("registers" in line or "spill" in line):
            report.append(line.strip())
    print(json.dumps({"ptxas trinv_kernel": report}))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(19)
    for dtype in (torch.float32, torch.float64):
        for name in ("qr 1x512", "qr 1x512 .mT", "lu 1x1024 unit", "lu 1x512 unit",
                     "trsm 32x512", "wy 1x128", "wy 64x128", "1x2048",
                     "1x8192 .mT"):
            arg, unit, clean = case(name, dtype, dev, gen)
            batch, n = clean.shape[0], clean.shape[-1]
            U = arg.mT if unit else arg  # what trinv is given
            kern = lambda: trinv(U, unit)  # noqa: E731
            plain = lambda: trinv_plain(clean)  # noqa: E731
            eye = torch.eye(n, dtype=dtype, device=dev)
            lib = lambda: torch.linalg.solve_triangular(  # noqa: E731
                U, eye, upper=True, unitriangular=unit)
            err = ((kern().double() - plain().double()).abs().max()
                   / plain().double().abs().max()).item()
            p1, k1 = device_ms(plain), device_ms(kern)
            lb = device_ms(lib)
            k2, p2 = device_ms(kern), device_ms(plain)
            hp1, hk1, hl, hk2, hp2 = (host_us(plain), host_us(kern),
                                      host_us(lib), host_us(kern),
                                      host_us(plain))
            wp1, wk1, wl, wk2, wp2 = (wall_ms(plain), wall_ms(kern),
                                      wall_ms(lib), wall_ms(kern),
                                      wall_ms(plain))
            esz = clean.element_size()
            ops_ms = batch * n ** 3 / 3 / PEAK_FLOPS * 1e3
            bytes_ms = batch * 1.5 * n * n * esz / PEAK_BYTES * 1e3
            widths = {}
            if n <= 1024:
                U3 = U.reshape(-1, n, n)
                for W in WIDTHS:
                    X = torch.empty((batch, n, n), dtype=dtype, device=dev)
                    widths[W] = round(device_ms(
                        lambda: _launch(U3, X, unit, W))[0], 4)
            print(json.dumps({
                "shape": name, "dtype": str(dtype).split(".")[-1],
                "kernel_device_ms": round((k1[0] + k2[0]) / 2, 4),
                "kernel_kernels_a_call": k1[1],
                "plain_device_ms": round((p1[0] + p2[0]) / 2, 4),
                "plain_kernels_a_call": p1[1],
                "library_device_ms": round(lb[0], 4),
                "library_kernels_a_call": lb[1],
                "library_host_us": round(hl, 1),
                "library_wall_ms": round(wl, 4),
                "kernel_host_us": round((hk1 + hk2) / 2, 1),
                "plain_host_us": round((hp1 + hp2) / 2, 1),
                "kernel_wall_ms": round((wk1 + wk2) / 2, 4),
                "plain_wall_ms": round((wp1 + wp2) / 2, 4),
                "bound_ms": round(max(ops_ms, bytes_ms), 5),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "device_ms_by_width": widths, "max_rel_err": err}))
            del arg, clean, U, eye

    for label, make, step, dtype in (
            ("hpd f32", make_hpd_problem, hpd_solve_step, torch.float32),
            ("hpd f64", make_hpd_problem, hpd_solve_step, torch.float64),
            ("lu f32", make_lu_problem, linear_solve_step, torch.float32),
            ("ls f32", lambda n, r, dtype, device: make_ls_problem(
                n, n, r, dtype=dtype, device=device),
             least_squares_step, torch.float32)):
        a, b = make(16384, 256, dtype=dtype, device=dev)
        step(a, b)  # warm
        torch.cuda.synchronize()
        trinv.launches = 0
        with profile(activities=[ProfilerActivity.CPU]):
            step(a, b)
            torch.cuda.synchronize()
        spans = trace.summary()["spans"].get("blas.trinv", {"count": 0})
        print(json.dumps({"path": label, "trinv calls": spans["count"],
                          "K10 launches": trinv.launches}))
        del a, b


if __name__ == "__main__":
    main()
