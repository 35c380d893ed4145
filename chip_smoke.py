"""Drive the port's main paths (HPD solve, LU solve, HermitianEig) on one
NVIDIA GPU and check them.

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
     and a small float64 run held against the same step on the CPU;
  7. K5 (latrd panel) and K6 (bulge chase) against their plain versions:
     K5 at the HermitianEig path's panels (M=8192, k0=0 and 4096), a
     ragged panel and a float64 one; K6 at n=8192 with b=256 and b=128
     and at n=1000 with b=16, through the spectrum of (d, e) and the
     orthogonality of Q2, and in float64 entry by entry;
  8. the HermitianEig slice: ``hermitian_eig_step`` at n=8192, float32,
     through the latrd path (K5) and the SBR path (K6), each run twice,
     gated on the scaled residual, the orthogonality and the launch
     counts, with its stages timed once; and a small float64 run held
     against the same step on the CPU.
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
    import elementalx_torch as Et
    from elementalx_torch.entry import (
        entry,
        hermitian_eig_step,
        hpd_solve_step,
        linear_solve_step,
        make_eig_problem,
        make_lu_problem,
    )
    from elementalx_torch.kernels import common
    from elementalx_torch.kernels.getrf import getrf_panel, getrf_panel_plain
    from elementalx_torch.kernels.latrd import latrd_panel, latrd_panel_plain
    from elementalx_torch.kernels.matmul import matmul, matmul_plain
    from elementalx_torch.kernels.potrf import (
        potrf_block_inv,
        potrf_block_inv_plain,
    )
    from elementalx_torch.kernels.sb2tr import sb2tr, sb2tr_plain
    from elementalx_torch.lapack import condense, sbr, tridiag_eig
    from elementalx_torch.lapack.hermitian_eig import HermitianEigCtrl

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


    # ---- 7. K5 and K6 against their plain versions ----
    # K5 tolerance: max|out - plain| <= rtol * max|plain| for P, W and
    # tau; float32 1e-4 (symvs over up to 8192 terms summed in another
    # order, compounded over 128 columns), float64 1e-10. Every reflector
    # [1; v] of the panel is a unit vector up to tau: |[1; v]|^2 tau = 2.
    def sym(m, dt):
        x = randn(m, m, dtype=torch.float64)
        return ((x + x.mT) / 2).to(dt)

    k5_main = None
    for M, k0, w, dt in ((8192, 0, 128, torch.float32),
                         (8192, 4096, 128, torch.float32),
                         (1000, 37, 100, torch.float32),
                         (2048, 0, 128, torch.float64)):
        a = sym(M, dt)
        out = latrd_panel(a, k0, w, 128)
        ref = latrd_panel_plain(a, k0, w, 128)
        sync()
        rtol = 1e-4 if dt == torch.float32 else 1e-10
        errs = []
        for name, o, r in zip(("P", "W", "tau"), out, ref):
            err = (o.double() - r.double()).abs().max().item()
            scale = r.double().abs().max().item()
            require(err <= rtol * scale,
                    f"K5 ({M},{k0},{w}) {name}: {err} > {rtol} * {scale}")
            errs.append(err)
        P, _, tau = out
        unit = max(abs((1 + P[k0 + j + 2:, j].double().square().sum().item())
                       * tau[j].item() - 2)
                   for j in range(w) if tau[j].item() != 0)
        require(unit <= 100 * rtol, f"K5 ({M},{k0},{w}): reflector "
                                    f"|[1;v]|^2 tau - 2 = {unit}")
        ms, plain_ms = time_pair(lambda: latrd_panel(a, k0, w, 128),
                                 lambda: latrd_panel_plain(a, k0, w, 128), 3)
        print(f"K5 latrd panel (M={M}, k0={k0}, w={w}) {str(dt)[6:]}: "
              f"max_abs_err P {errs[0]:.3e} W {errs[1]:.3e} tau "
              f"{errs[2]:.3e} (rtol {rtol}), max|(|[1;v]|^2 tau - 2)| "
              f"{unit:.2e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        if k5_main is None:
            k5_main = (max(errs), ms, plain_ms)
        del a, out, ref

    # K6: the spectrum of (d, e) within 100 n eps max|w| of eigvalsh of
    # the band (float64 eigvalsh), for the kernel and the plain version,
    # and the two spectra within 1e-4 max|w| of each other; Q2 =
    # _apply_q2(vout) (in float64) orthogonal to 100 n eps and reducing
    # the band to (d, e): max|Q2^T A Q2 - T| <= 1e-4 max|w|. Single d/e
    # entries move with float32 rounding far more than the spectrum, so
    # float32 is never compared entry by entry; float64 is, to 1e-9
    # max|A|.
    def band(m, b, dt):
        i = torch.arange(m, device=dev)
        return torch.where((i[:, None] - i[None, :]).abs() <= b,
                           sym(m, torch.float64),
                           torch.zeros((), dtype=torch.float64,
                                       device=dev)).to(dt)

    def spectrum(d, e):
        T = torch.diag(d.double()) + torch.diag(e.double(), -1) \
            + torch.diag(e.double(), 1)
        return torch.linalg.eigvalsh(T)

    # The plain chase is one op at a time (about 0.4 ms an op): 51 s at
    # n=8192, b=256, 101 s at b=128 (NVIDIA H100 80GB HBM3, 700 W). It
    # runs once at the path's default band and is left out at b=128,
    # where only the kernel is held to the spectrum and Q2.
    k6_main = None
    eps32 = torch.finfo(torch.float32).eps
    for m, b, with_plain in ((8192, 256, True), (8192, 128, False),
                             (1000, 16, True)):
        ab = band(m, b, torch.float32)
        ev = torch.linalg.eigvalsh(ab.double())
        wmax = ev.abs().max().item()
        bound = 100 * m * eps32 * wmax
        ks = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            v, d, e = sb2tr(ab, b)
            sync()
            ks.append((time.perf_counter() - t0) * 1e3)
        wk = spectrum(d, e)
        errk = (wk - ev).abs().max().item()
        require(errk <= bound, f"K6 n={m} b={b}: spectrum error {errk} > "
                               f"{bound}")
        plain = "plain not run"
        if with_plain:
            t0 = time.perf_counter()
            _, dp, ep = sb2tr_plain(ab, b)
            sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
            wp = spectrum(dp, ep)
            errp = (wp - ev).abs().max().item()
            errkp = (wk - wp).abs().max().item()
            require(errp <= bound, f"K6 n={m} b={b}: the plain chase's "
                                   f"spectrum error {errp} > {bound}")
            require(errkp <= 1e-4 * wmax, f"K6 n={m} b={b}: kernel and "
                                          f"plain spectra {errkp} apart")
            plain = (f"plain {plain_ms:.1f} ms (one run), its spectrum error "
                     f"{errp:.3e}, kernel vs plain spectra {errkp:.3e}")
            if k6_main is None:
                k6_main = (errkp, (ks[0] + ks[1]) / 2, plain_ms)
        Q2 = sbr._apply_q2(v.double(), torch.eye(m, device=dev,
                                                 dtype=torch.float64), m, b)
        orth = (Q2.mT @ Q2 - torch.eye(m, device=dev, dtype=torch.float64)
                ).abs().max().item()
        require(orth <= 100 * m * eps32, f"K6 n={m} b={b}: Q2 orthogonality "
                                         f"{orth}")
        T = torch.diag(d.double()) + torch.diag(e.double(), -1) \
            + torch.diag(e.double(), 1)
        red = (Q2.mT @ ab.double() @ Q2 - T).abs().max().item()
        require(red <= 1e-4 * wmax, f"K6 n={m} b={b}: max|Q2^T A Q2 - T| "
                                    f"{red} > 1e-4 * {wmax}")
        print(f"K6 bulge chase n={m} b={b} f32: spectrum error {errk:.3e} "
              f"(bound {bound:.3e}), max|Q2^T Q2 - I| {orth:.3e}, "
              f"max|Q2^T A Q2 - T| {red:.3e} (tol {1e-4 * wmax:.3e})  kernel "
              f"{ks[0]:.1f} / {ks[1]:.1f} ms  {plain}")
        del ab, Q2, T, v
    for m, b in ((1000, 16), (2048, 256)):
        ab = band(m, b, torch.float64)
        v, d, e = sb2tr(ab, b)
        vp, dp, ep = sb2tr_plain(ab, b)
        sync()
        err = max((x - y).abs().max().item()
                  for x, y in ((v, vp), (d, dp), (e, ep)))
        tol = 1e-9 * ab.abs().max().item()
        require(err <= tol, f"K6 n={m} b={b} f64: vout/d/e differ from the "
                            f"plain chase by {err} > {tol}")
        print(f"K6 bulge chase n={m} b={b} f64: max|out - plain| over vout, "
              f"d, e {err:.3e} (tol {tol:.3e})")

    # ---- 8. the HermitianEig slice ----
    h = make_eig_problem(300, dtype=torch.float64, device=dev, seed=1)
    w_gpu, q_gpu, _ = hermitian_eig_step(h)
    w_cpu, q_cpu, _ = hermitian_eig_step(h.cpu())
    dw = (w_gpu.cpu() - w_cpu).abs().max().item()
    require(dw <= 1e-10 * w_cpu.abs().max().item(),
            f"eig slice n=300 f64: eigenvalues differ by {dw}")
    align = (q_cpu * q_gpu.cpu()).sum(0).abs().min().item()
    require(align >= 1 - 1e-8, f"eig slice n=300 f64: min |diag(Z_cpu^T "
                               f"Z_gpu)| = {align}")
    print(f"eig slice n=300 f64: card vs CPU max|dw| {dw:.3e}, "
          f"min |diag(Z_cpu^T Z_gpu)| {align:.12f}")

    ne = 8192
    h = make_eig_problem(ne, device=dev)
    eig_launches = {}
    for alg in ("latrd", "sbr"):
        ctrl = HermitianEigCtrl(tridiag_alg=alg)
        sync()
        matmul.launches = latrd_panel.launches = sb2tr.launches = 0
        t0 = time.perf_counter()
        w, q, r = hermitian_eig_step(h, ctrl)
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        eig_launches[alg] = {"K1": matmul.launches,
                             "K5": latrd_panel.launches,
                             "K6": sb2tr.launches}
        t0 = time.perf_counter()
        hermitian_eig_step(h, ctrl)
        sync()
        again_ms = (time.perf_counter() - t0) * 1e3
        resid = r.item()
        qd = q.double()
        orth = ((qd.mT @ qd - torch.eye(ne, device=dev, dtype=torch.float64)
                 ).abs().max() / (eps32 * ne)).item()
        del qd
        require(tuple(q.shape) == (ne, ne) and bool(torch.isfinite(w).all())
                and bool(torch.isfinite(q).all()),
                f"eig slice {alg}: non-finite or misshapen output")
        require(resid < 100, f"eig slice {alg}: scaled residual {resid}")
        require(orth < 100, f"eig slice {alg}: orthogonality {orth}")
        lc = eig_launches[alg]
        require(lc["K1"] > 0 and lc["K5" if alg == "latrd" else "K6"] > 0,
                f"the eig path ({alg}) did not launch its kernels: {lc}")
        print(f"slice HermitianEig + residual Gemm ({alg}), n={ne} f32: "
              f"{first_ms:.1f} ms (first run), {again_ms:.1f} ms (second "
              f"run); scaled residual max|HQ-QW|/(eps n max|w|) = "
              f"{resid:.4f}; max|Q^T Q - I|/(eps n) = {orth:.4f}; "
              f"launches {lc}")

    def stage(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    H = Et.DistMatrix.from_global(h, grid=Et.Grid(dev))
    fact, t_tri = stage(lambda: condense.HermitianTridiag(Et.LOWER, H))
    (w, Z), t_eig = stage(lambda: tridiag_eig.tridiag_eig(fact.d, fact.e))
    _, t_bt = stage(lambda: condense.tridiag_apply_q(fact, Z, False))
    sf, t_tri2 = stage(lambda: sbr.sbr_tridiag(h, 256))
    _, t_bt2 = stage(lambda: sbr.sbr_apply_q(sf, Z, 256))
    print(f"eig stages n={ne} f32: latrd tridiagonalization {t_tri:.1f} ms, "
          f"tridiag_eig {t_eig:.1f} ms, backtransform {t_bt:.1f} ms; SBR "
          f"tridiagonalization {t_tri2:.1f} ms, SBR backtransform "
          f"{t_bt2:.1f} ms")
    del fact, Z, sf, H
    torch.linalg.eigh(h)
    _, eigh_ms = stage(lambda: torch.linalg.eigh(h))
    print(f"torch.linalg.eigh n={ne} f32 (context): {eigh_ms:.1f} ms")

    kernels = [
        {"name": "K1 local GEMM (matmul)", "route": "cuda",
         "source": "elementalx_torch/kernels/csrc/matmul.cu",
         "replaces": "elementalx/kernels/matmul.py:39",
         "launches": launches["K1"] + lu_launches["K1"]
         + eig_launches["latrd"]["K1"] + eig_launches["sbr"]["K1"],
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
        {"name": "K5 latrd panel (latrd_panel)", "route": "cuda",
         "source": "elementalx_torch/kernels/csrc/latrd.cu",
         "replaces": "elementalx/kernels/latrd.py:224",
         "launches": eig_launches["latrd"]["K5"], "max_abs_err": k5_main[0],
         "ms": k5_main[1], "plain_ms": k5_main[2]},
        {"name": "K6 band to tridiagonal bulge chase (sb2tr)",
         "route": "cuda", "source": "elementalx_torch/kernels/csrc/sb2tr.cu",
         "replaces": "elementalx/kernels/sb2tr.py:276",
         "launches": eig_launches["sbr"]["K6"], "max_abs_err": k6_main[0],
         "ms": k6_main[1], "plain_ms": k6_main[2]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
