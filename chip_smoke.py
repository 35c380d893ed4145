"""Drive the port's main paths (HPD solve, LU solve) on one NVIDIA GPU and
check them.

Usage, from the root of the repository: ``python3 chip_smoke.py``

Phases (each raises on failure, so the script exits non-zero):
  1. set-up: the card, torch and CUDA versions, the kernel build time;
  2. K1 (local GEMM) against its plain version at the main path's shapes;
  3. K3a (Cholesky diagonal block) against its plain version, and the NaN
     poisoning of a block that is not positive definite;
  4. the slice: ``elementalx_torch.entry`` at n=16384, nrhs=256, float32,
     with the scaled residual checked in float64 and the kernels' launch
     counts read around the run; and a small float64 run held against the
     same step on the CPU (plain versions);
  5. K4 (pivoted LU panel) against its plain version at the LU path's
     sub-panel shapes, checked in float64 (P A = L U, |L| <= 1, identical
     float64 pivots);
  6. the LU slice: ``linear_solve_step`` at n=16384, nrhs=256, float32,
     gated on the scaled backward error and the kernels' launch counts,
     and a small float64 run held against the same step on the CPU.
The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, it fails and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from elementalx_torch.entry import (
        entry,
        hpd_solve_step,
        linear_solve_step,
        make_lu_problem,
    )
    from elementalx_torch.kernels import common
    from elementalx_torch.kernels.getrf import getrf_panel, getrf_panel_plain
    from elementalx_torch.kernels.matmul import matmul, matmul_plain
    from elementalx_torch.kernels.potrf import (
        potrf_block_inv,
        potrf_block_inv_plain,
    )

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    def time_ms(fn, iters):
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

    def time_pair(kernel, plain, iters):
        """Kernel and plain version in turns: plain, kernel, kernel, plain."""
        p1 = time_ms(plain, iters)
        k1 = time_ms(kernel, iters)
        k2 = time_ms(kernel, iters)
        p2 = time_ms(plain, iters)
        return (k1 + k2) / 2, (p1 + p2) / 2

    # ---- 1. set-up ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    common.kernel_library()
    print(f"kernel library ready in {time.perf_counter() - t0:.2f} s "
          f"({common.library_path()})")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---- 2. K1 against torch.matmul (f32 accumulation) ----
    # Tolerance: max|C - C_plain| <= rtol * max|C_plain|. float32: both
    # are FP32 FMA sums of K terms in possibly different orders, so 1e-5
    # (about 100 eps) covers K up to 16384; bfloat16 output: the two f32
    # accumulators may round to neighbouring bf16 values, 2^-7 apart
    # relative to the largest entry, so 1e-2.
    k1_cases = [
        ("history f32", 8192, 7680, 512, torch.float32, False, 1e-5),
        ("L21 f32", 15872, 512, 512, torch.float32, False, 1e-5),
        ("bench bf16", 16384, 16384, 16384, torch.bfloat16, False, 1e-2),
        ("ragged f32", 1000, 777, 1001, torch.float32, False, 1e-5),
        ("ragged transposed f32", 1000, 777, 1001, torch.float32, True,
         1e-5),
    ]
    k1_main = None
    for name, M, K, N, dt, transposed, rtol in k1_cases:
        if transposed:
            a, b = randn(K, M, dtype=dt).mT, randn(N, K, dtype=dt).mT
        else:
            a, b = randn(M, K, dtype=dt), randn(K, N, dtype=dt)
        c, ref = matmul(a, b), matmul_plain(a, b)
        sync()
        err = (c.double() - ref.double()).abs().max().item()
        scale = ref.double().abs().max().item()
        require(err <= rtol * scale,
                f"K1 {name}: max_abs_err {err} > {rtol} * {scale}")
        iters = 2 if M * N * K > 1e12 else 10
        ms, plain_ms = time_pair(lambda: matmul(a, b),
                                 lambda: matmul_plain(a, b), iters)
        tf = 2 * M * N * K / ms / 1e9
        print(f"K1 {name} ({M}x{K})x({K}x{N}): max_abs_err {err:.3e} "
              f"(tol {rtol} x {scale:.3e})  kernel {ms:.4f} ms "
              f"({tf:.2f} TFLOP/s)  plain {plain_ms:.4f} ms")
        if k1_main is None:
            k1_main = (err, ms, plain_ms)
        del a, b, c, ref

    # ---- 3. K3a against torch.linalg.cholesky_ex + triangular inverse ----
    # Tolerance: max|out - plain| <= 1e-5 * max|plain| in float32; the
    # blocks are g g^T / w + 2 I (condition number below 3), so both
    # factorizations agree to a few float32 ulps.
    k3_main = None
    for w in (512, 2048, 200):
        g = randn(w, w, dtype=torch.float64)
        sym = (g @ g.mT / w + 2 * torch.eye(w, device=dev,
                                            dtype=torch.float64)).float()
        l11, inv_lh = potrf_block_inv(sym)
        l_ref, inv_ref = potrf_block_inv_plain(sym)
        sync()
        err = max((l11 - l_ref).abs().max().item(),
                  (inv_lh - inv_ref).abs().max().item())
        scale = max(l_ref.abs().max().item(), inv_ref.abs().max().item())
        require(err <= 1e-5 * scale,
                f"K3a w={w}: max_abs_err {err} > 1e-5 * {scale}")
        require(l11.triu(1).abs().max().item() == 0.0
                and inv_lh.tril(-1).abs().max().item() == 0.0,
                f"K3a w={w}: nonzero entries outside the triangles")
        bad_l, bad_inv = potrf_block_inv(-sym)
        sync()
        require(bool(bad_l.isnan().all()) and bool(bad_inv.isnan().all()),
                f"K3a w={w}: a non-HPD block was not poisoned with NaN")
        ms, plain_ms = time_pair(lambda: potrf_block_inv(sym),
                                 lambda: potrf_block_inv_plain(sym), 10)
        print(f"K3a w={w} f32: max_abs_err {err:.3e} (tol 1e-5 x "
              f"{scale:.3e}), non-HPD -> NaN  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms")
        if k3_main is None:
            k3_main = (err, ms, plain_ms)

    # ---- 4. the slice ----
    # A small float64 problem on the card against the same step on the
    # CPU, where every kernel wrapper takes its plain version.
    step, (a, b) = entry(n=300, nrhs=5, dtype=torch.float64, device=dev)
    x_gpu, _ = step(a, b)
    x_cpu, _ = hpd_solve_step(a.cpu(), b.cpu())
    diff = (x_gpu.cpu() - x_cpu).abs().max().item()
    require(diff <= 1e-10 * x_cpu.abs().max().item(),
            f"slice n=300 f64: card and CPU differ by {diff}")
    print(f"slice n=300 f64: card vs CPU max|dX| {diff:.3e}")

    n, nrhs = 16384, 256
    step, (a, b) = entry(n=n, nrhs=nrhs, dtype=torch.float32, device=dev)
    sync()
    matmul.launches = 0
    potrf_block_inv.launches = 0
    t0 = time.perf_counter()
    x, nrm = step(a, b)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {"K1": matmul.launches, "K3a": potrf_block_inv.launches}
    t0 = time.perf_counter()
    step(a, b)
    sync()
    again_ms = (time.perf_counter() - t0) * 1e3
    require(tuple(x.shape) == (n, nrhs), f"X has shape {tuple(x.shape)}")
    require(bool(torch.isfinite(x).all()) and bool(torch.isfinite(nrm)),
            "non-finite X or residual norm")
    eps = torch.finfo(torch.float32).eps
    resid = ((a.double() @ x.double() - b.double()).abs().max()
             / (eps * n * b.double().abs().max())).item()
    require(resid < 100, f"scaled residual {resid} >= 100")
    require(launches["K1"] > 0 and launches["K3a"] > 0,
            f"the main path did not launch every kernel: {launches}")
    print(f"slice HPDSolve + residual Gemm + Nrm2, n={n} nrhs={nrhs} f32: "
          f"{first_ms:.1f} ms (first run), {again_ms:.1f} ms (second run); "
          f"scaled residual max|AX-B|/(eps n max|B|) = {resid:.4f}; "
          f"||R||_F = {nrm.item():.4e}; launches {launches}")

    # ---- 5. K4 against torch.linalg.lu_factor (getrf_panel_plain) ----
    # Checked in float64 on the kernel's own factor: lperm a permutation;
    # max|P A - L U| <= w eps max|A|, the classical gamma_w bound for
    # multipliers of at most 1 and a growth factor near 1 (float32, w=512:
    # 6.1e-5); |L| <= 1 + w eps. float64 pivots must equal the plain
    # version's; float32 ones may differ on near-ties and are counted.
    k4_main = None
    for Mt, w, dt in ((16384, 512, torch.float32), (8192, 512, torch.float32),
                      (1000, 200, torch.float32), (4096, 512, torch.float64)):
        a = randn(Mt, w, dtype=torch.float64).to(dt)
        out, piv = getrf_panel(a)
        ref, ref_piv = getrf_panel_plain(a)
        sync()
        lperm = torch.cat([piv, torch.nonzero(torch.isin(
            torch.arange(Mt, device=dev), piv, invert=True)).flatten()])
        require(torch.equal(torch.sort(lperm).values,
                            torch.arange(Mt, device=dev)),
                f"K4 ({Mt},{w}): lperm is not a permutation")
        packed = out[lperm].double()
        L = torch.tril(packed, -1)[:, :w] + torch.eye(
            Mt, w, device=dev, dtype=torch.float64)
        U = torch.triu(packed[:w])
        ad = a.double()
        tol = w * torch.finfo(dt).eps
        resid = (ad[lperm] - L @ U).abs().max().item()
        scale = ad.abs().max().item()
        lmax = L.abs().max().item()
        require(resid <= tol * scale,
                f"K4 ({Mt},{w}) {dt}: max|PA-LU| {resid} > {tol} * {scale}")
        require(lmax <= 1 + tol, f"K4 ({Mt},{w}) {dt}: max|L| {lmax}")
        ndiff = int((piv != ref_piv).sum())
        if dt == torch.float64:
            require(ndiff == 0, f"K4 ({Mt},{w}) f64: {ndiff} pivots differ "
                                "from the plain version's")
        err = (out.double() - ref.double()).abs().max().item()
        ms, plain_ms = time_pair(lambda: getrf_panel(a),
                                 lambda: getrf_panel_plain(a), 5)
        print(f"K4 ({Mt},{w}) {str(dt)[6:]}: max|PA-LU| {resid:.3e} "
              f"(tol {tol:.2e} x {scale:.3f}), max|L| {lmax:.6f}, "
              f"{ndiff} pivots differ, max|out-plain| {err:.3e}  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        if k4_main is None:
            k4_main = (err, ms, plain_ms)
        del a, out, ref, packed, L, U, ad

    # ---- 6. the LU slice ----
    a, b = make_lu_problem(300, 5, dtype=torch.float64, device=dev)
    x_gpu, _ = linear_solve_step(a, b)
    x_cpu, _ = linear_solve_step(a.cpu(), b.cpu())
    diff = (x_gpu.cpu() - x_cpu).abs().max().item()
    require(diff <= 1e-10 * x_cpu.abs().max().item(),
            f"LU slice n=300 f64: card and CPU differ by {diff}")
    print(f"LU slice n=300 f64: card vs CPU max|dX| {diff:.3e}")

    a, b = make_lu_problem(n, nrhs, dtype=torch.float32, device=dev)
    sync()
    matmul.launches = 0
    getrf_panel.launches = 0
    t0 = time.perf_counter()
    x, nrm = linear_solve_step(a, b)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    lu_launches = {"K1": matmul.launches, "K4": getrf_panel.launches}
    t0 = time.perf_counter()
    linear_solve_step(a, b)
    sync()
    again_ms = (time.perf_counter() - t0) * 1e3
    require(tuple(x.shape) == (n, nrhs), f"X has shape {tuple(x.shape)}")
    require(bool(torch.isfinite(x).all()) and bool(torch.isfinite(nrm)),
            "LU slice: non-finite X or residual norm")
    ad, xd, bd = a.double(), x.double(), b.double()
    r = bd - ad @ xd
    berr = (r.abs().sum(1).max() / (eps * n * ad.abs().sum(1).max()
                                    * xd.abs().sum(1).max())).item()
    hpd_style = (r.abs().max() / (eps * n * bd.abs().max())).item()
    require(berr < 100, f"LU slice: scaled backward error {berr} >= 100")
    require(lu_launches["K1"] > 0 and lu_launches["K4"] > 0,
            f"the LU path did not launch every kernel: {lu_launches}")
    del ad, xd, bd, r
    torch.linalg.solve(a, b)
    sync()
    t0 = time.perf_counter()
    torch.linalg.solve(a, b)
    sync()
    solve_ms = (time.perf_counter() - t0) * 1e3
    print(f"slice LinearSolve + residual Gemm + Nrm2, n={n} nrhs={nrhs} f32: "
          f"{first_ms:.1f} ms (first run), {again_ms:.1f} ms (second run); "
          f"scaled backward error ||B-AX||_inf/(eps n ||A||_inf ||X||_inf) "
          f"= {berr:.4f}; max|AX-B|/(eps n max|B|) = {hpd_style:.4f}; "
          f"||R||_F = {nrm.item():.4e}; launches {lu_launches}; "
          f"torch.linalg.solve (context) {solve_ms:.1f} ms")

    kernels = [
        {"name": "K1 local GEMM (matmul)", "route": "cuda",
         "source": "elementalx_torch/kernels/csrc/matmul.cu",
         "replaces": "elementalx/kernels/matmul.py:39",
         "launches": launches["K1"] + lu_launches["K1"],
         "max_abs_err": k1_main[0],
         "ms": k1_main[1], "plain_ms": k1_main[2]},
        {"name": "K3a Cholesky diagonal block (potrf_block_inv)",
         "route": "cuda", "source": "elementalx_torch/kernels/csrc/potrf.cu",
         "replaces": "elementalx/kernels/potrf.py:263",
         "launches": launches["K3a"], "max_abs_err": k3_main[0],
         "ms": k3_main[1], "plain_ms": k3_main[2]},
        {"name": "K4 pivoted LU panel (getrf_panel)", "route": "cuda",
         "source": "elementalx_torch/kernels/csrc/getrf.cu",
         "replaces": "elementalx/kernels/getrf.py:210",
         "launches": lu_launches["K4"], "max_abs_err": k4_main[0],
         "ms": k4_main[1], "plain_ms": k4_main[2]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
