"""Drive the port's main paths (HPD solve, LU solve, HermitianEig, the
BLAS levels 2 and 3, the fused Cholesky panel tail, HermitianGenDefEig,
level 1, least squares and the distributed GEMM) on one NVIDIA GPU and
check them.

Usage, from the root of the repository: ``python3 chip_smoke.py``

Phases (each raises on failure, so the script exits non-zero):
  1. set-up: the card, torch and CUDA versions, the kernel build time;
  2. K1 (local GEMM) against its plain version at the main path's shapes,
     each case on the core ``route`` gives it: float32 on the FP32 FMA core
     fed by cp.async (bit for bit the FMA core's; rows of 777 floats and
     their .mT in 4-byte copies on 64 x 128 tiles), bfloat16 on the
     tensor cores (the Cholesky history product with B a .mH view into
     float32, and 16384^3), the dist step's SUMMA_C k-panel (8192 x 128)
     (128 x 2) on the skinny route (the same bits twice), float64 2048^3
     and misaligned bf16 on the FMA core; each timed against
     ``torch.matmul`` in the operands' type and its bound at the right
     peak (FP64 FMA 33.5 TFLOP/s for float64);
  3. K3a (Cholesky diagonal block) against its plain version, and the NaN
     poisoning of a block that is not positive definite;
  4. the slice: ``elementalx_torch.entry`` at n=16384, nrhs=256, float32,
     with the scaled residual checked in float64 and the kernels' launch
     counts read around the run; and a small float64 run held against the
     same step on the CPU (plain versions). From here on every K1 launch
     on the FMA core is named by its operands, and the float64 runs of the
     slices against the CPU (phases 4, 6, 8, 11, 14) count their K1
     launches by core;
  5. the cost of a grid.sync(), a cluster barrier and a cluster barrier
     with a DSMEM read (kernels/sync_probe.py); K4 (pivoted LU panel)
     against its plain version at the LU path's sub-panel shapes and in
     float64, each on the route ``k4_route`` gives it (float64 at
     16384 x 512: the grid route), checked in float64 (P A = L U,
     |L| <= 1, identical float64 pivots), with its roofline bound and its
     chain floor (a column a barrier and a DSMEM read); where the cluster
     route runs, the grid route gives the same bits and runs in turns with
     it; then K4 at each of the LU path's 32 sub-panel heights;
  6. the LU slice: ``linear_solve_step`` at n=16384, nrhs=256, float32,
     gated on the scaled backward error and the kernels' launch counts
     (every K4 panel on the cluster route), and a small float64 run held
     against the same step on the CPU (a torch.profiler trace of one warm
     step, K4's share of the device time and the idle share, runs after
     phase 12);
  7. K5 (latrd panel) and K6 (bulge chase) against their plain versions:
     K5 at the HermitianEig path's panels (M=8192, k0=0 and 4096, beside
     the four-barrier design's times), a ragged panel and a float64 one,
     the same bits on a
     second run, each against its bound (each byte once) and the floor of
     its algorithm (the trailing triangle streamed once per column; a
     triangle that fits in the 50 MB L2 is marked so);
     K6 at n=8192 with b=256 and b=128 and at n=1000
     with b=16, each on the route ``k6_route`` gives it, kernel and plain
     in turns (kernel, plain, kernel; the two kernel runs the same bits),
     through the spectrum of (d, e) and the orthogonality of Q2, with its
     roofline bound and its chain floor, the l2 route (the first design)
     in turns with the cluster route at n=8192; and in float64 entry by
     entry;
  8. the HermitianEig slice: ``hermitian_eig_step`` at n=8192, float32,
     through the latrd path (K5) and the SBR path (K6 on the cluster
     route), each run twice, gated on the scaled residual, the
     orthogonality and the launch counts, with its stages timed once;
     tridiagonalization plus backtransform at n = 1024 to 8192 through
     latrd, SBR b=256 and SBR b=128, best of three (the table the
     HermitianEig default comes from); and a small float64 run held
     against the same step on the CPU;
  9. K2 (masked rank-k update), K3b/K3c (fused panel tail) and K7
     (lower-triangle symv) against their plain versions at the level-3,
     HPD and symv shapes, K7 on the core ``route`` gives each case (TMA
     tiles, or the scalar unit at n=16383) with its GB/s, and its two
     cores in turns at n=16384; K3c once at each of the HPD path's 32
     panel shapes, the launches its JSON entry reports;
 10. the fused-tail HPD slice: ``entry()`` at n=16384 under
     ``ELX_PALLAS_POTRF=1`` (set for the phase only), gated on the scaled
     residual and 32 K3b launches; a bfloat16-storage Cholesky at n=16384
     through the fused tail beside the default path, gated on every
     history product taking K1's tensor cores and none its FMA core, with
     its time; and the public Herk,
     Trrk and Symv (n=16384 and 16383: one launch on each K7 core) at
     phase 9's shapes, with their K2/K7 launch counts;
 11. the HermitianGenDefEig slice: ``gen_def_eig_step`` at n=8192,
     float32, AXBX, with the fused tail, gated on the scaled residual,
     the B-orthogonality and the launch counts, with the residual split
     by stage in float64 (HermitianEig's own residual on C gated too);
     and all three pencils at n=300 in float64 held against the same step
     on the CPU;
 12. K9 (axpby, scale, hadamard, fill, transpose) against its plain
     versions, bit for bit, timed in turns against the plain version and
     the library call at each float32 shape the paths give it (axpby and
     fill at 16384 x 256, axpby at 8192 x 256, transpose at 8192 x 16384
     and 16384 x 8192, every entry at 16384^2, the level-1 block's);
     checked in bfloat16, float64, a ragged 1000 x 777 case with .mT
     inputs, and the conjugate transpose of a real input; then the host's
     time per axpby call at 16384 x 256 (1000 unsynchronised calls)
     against torch.add, gated on one device kernel a call;
 13. the least-squares slice: every public function of lapack/qr.py,
     lq.py, gqr.py and euclidean_min.py at about n=300 in float64 held
     against the same call on the CPU; ``least_squares_step`` at
     m = n = 16384, nrhs = 256 (QR) and at m = 8192, n = 16384 (the
     minimum-norm solution through the QR of A^H, one K9 transpose), and
     ExplicitQR at n = 8192, each run twice, gated on the scaled backward
     error, the minimum norm, the orthogonality and reconstruction of
     Q R, the CholeskyQR2 fast panels and the launch counts; then the public
     level-1 operations at 16384^2 with their K9 launches.
 14. the distributed GEMM slice on virtual grids (every position on the
     one card): K8 (ring SUMMA) at M = K = N = 16384 on a 2x2 grid in
     float32 (FP32 FMA core fed by cp.async) and bfloat16 (tensor cores),
     once through its DistMatrix entry ``ring_summa`` with the launches by
     core, then against its plain version, timed against it, its bound and
     the library call, and at a ragged float64 size on a 4x2 grid; ``dist_gemm_step`` at n=16384 float32 on the 2x2 grid with x
     moved off the solution, gated on R3 entry by entry against a float64
     chain in plain torch, on the norms against the same step on a 1 x 1
     grid and on its K1/K8/K9 launches (every SUMMA product on K1's skinny
     route, none on the FMA core), with the bytes each
     redistribution moved and a profile; SUMMA A/B/C/Dot, Cannon and
     Gemm3D(depth=2) at n=16384 against K1 on the gathered operands; a
     Gemm on 2x3 and 3x2 grids against a float64 product; every ordered pair of
     redistributions at 1000 x 777 bit for bit; and the step at n=300 in
     float64 on the 2x2 and 4x2 grids against CPU grids of the same shape.
Phases 4, 6, 8, 10 and 11 also read K9's launches (the residual Gemm's
beta C is a K9 axpby) and gate that no K9 transpose runs on their paths.
The line before the last is a JSON summary of the kernels (K1 and K8 one
row per core that the main paths launched, the float64 runs included,
K7 one per core), each with
its bound (the
larger of its bytes over 3.35 TB/s and its operations over the peak of the
units it runs on: 67 TFLOP/s FP32, 989 TFLOP/s dense bf16 on the tensor
cores, the H100 SXM's published peaks; 33.5 TFLOP/s of FP64 FMA for the
FMA core's float64 row); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
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


#: H100 SXM published peaks: FP32 outside the tensor cores, dense bf16 on
#: the tensor cores, HBM3; FP64 FMA outside the tensor cores (the FMA
#: core's float64); and its L2's size
PEAK_FP32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
PEAK_FP64 = 33.5e12
L2_BYTES = 50e6


def roofline(flops: float, nbytes: float, peak: float = PEAK_FP32):
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``flops`` operations at ``peak`` (FP32 FMA unless the kernel runs
    on the bf16 tensor cores) and ``nbytes`` of memory traffic."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import elementalx_torch as Et
    from elementalx_torch.core import collectives
    from elementalx_torch.entry import (
        dist_gemm_step,
        entry,
        gen_def_eig_step,
        hermitian_eig_step,
        hpd_solve_step,
        least_squares_step,
        linear_solve_step,
        make_dist_problem,
        make_eig_problem,
        make_gendef_problem,
        make_hpd_problem,
        make_ls_problem,
        make_lu_problem,
    )
    from elementalx_torch.kernels import common
    from elementalx_torch.kernels import elementwise as k9
    from elementalx_torch.kernels.getrf import _launch as k4_launch
    from elementalx_torch.kernels.getrf import cluster_ctas as k4_ctas
    from elementalx_torch.kernels.getrf import getrf_panel, getrf_panel_plain
    from elementalx_torch.kernels.getrf import reset_launches as k4_reset
    from elementalx_torch.kernels.getrf import route as k4_route
    from elementalx_torch.kernels.latrd import latrd_panel, latrd_panel_plain
    from elementalx_torch.kernels.matmul import CORES as K1_CORES
    from elementalx_torch.kernels.matmul import _launch as k1_launch
    from elementalx_torch.kernels.matmul import matmul, matmul_plain
    from elementalx_torch.kernels.matmul import reset_launches as k1_reset
    from elementalx_torch.kernels.matmul import route as k1_route
    from elementalx_torch.kernels.potrf import (
        potrf_block_inv,
        potrf_block_inv_plain,
        potrf_panel_tail,
        potrf_panel_tail_full,
        potrf_panel_tail_full_plain,
        potrf_panel_tail_plain,
    )
    from elementalx_torch.kernels.ring_summa import CORES as K8_CORES
    from elementalx_torch.kernels.ring_summa import reset_launches as k8_reset
    from elementalx_torch.kernels.ring_summa import route as k8_route
    from elementalx_torch.kernels.ring_summa import (
        ring_summa,
        ring_summa_kernel,
        ring_summa_plain,
    )
    from elementalx_torch.kernels.sb2tr import _launch as k6_launch
    from elementalx_torch.kernels.sb2tr import chain_ops as k6_chain_ops
    from elementalx_torch.kernels.sb2tr import cluster_size as k6_ctas
    from elementalx_torch.kernels.sb2tr import reset_launches as k6_reset
    from elementalx_torch.kernels.sb2tr import route as k6_route
    from elementalx_torch.kernels.sb2tr import sb2tr, sb2tr_plain
    from elementalx_torch.kernels.symv import CORES as K7_CORES
    from elementalx_torch.kernels.sync_probe import step_us as sync_step_us
    from elementalx_torch.kernels.symv import _launch as k7_launch
    from elementalx_torch.kernels.symv import reset_launches as k7_reset
    from elementalx_torch.kernels.symv import route as k7_route
    from elementalx_torch.kernels.symv import (
        symv_lower,
        symv_lower_plain,
        symv_lower_trailing,
    )
    from elementalx_torch.kernels.trrk import (
        masked_rank_k,
        masked_rank_k_plain,
    )
    from elementalx_torch.lapack import condense, qr, sbr, tridiag_eig
    from elementalx_torch.lapack.hermitian_eig import (
        SBR_AUTO_BAND,
        SBR_AUTO_MIN_N,
        HermitianEigCtrl,
    )

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    sbr_auto = (SBR_AUTO_BAND, SBR_AUTO_MIN_N)

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

    def device_profile(fn):
        """(wall ms, {kernel name: device ms}, device kernels run) of one
        synchronised run of fn under torch.profiler."""
        from torch.profiler import ProfilerActivity, profile

        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        by_name, count = {}, 0
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                count += 1
                by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                    + ev.time_range.elapsed_us() / 1e3)
        return wall, by_name, count

    def time_pair(kernel, plain, iters):
        """Kernel and plain version in turns: plain, kernel, kernel, plain."""
        p1 = time_ms(plain, iters)
        k1 = time_ms(kernel, iters)
        k2 = time_ms(kernel, iters)
        p2 = time_ms(plain, iters)
        return (k1 + k2) / 2, (p1 + p2) / 2

    k9_entries = ("axpby", "scale", "hadamard", "fill", "transpose")

    def k9_reset():
        for name in k9_entries:
            getattr(k9, name).launches = 0

    def k9_counts():
        return {name: getattr(k9, name).launches for name in k9_entries}

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
    # Each case names the core route() gives it (float32 and float64 with
    # at most 16 columns: "skinny"; float32 with a unit stride in each
    # operand: "fma_async", in 16-byte copies where the operands allow and
    # in 4-byte ones otherwise; bfloat16: "wgmma", or "fma" for a
    # misaligned operand; wider float64: "fma") and must launch it.
    # Tolerance: max|C - C_plain| <= rtol * max|C_plain|. float32: both
    # are FP32 FMA sums of K terms in possibly different orders, so 1e-5
    # (about 100 eps) covers K up to 16384; float64 1e-12; bfloat16
    # output: the two f32 accumulators may round to neighbouring bf16
    # values, 2^-7 apart relative to the largest entry, so 1e-2; bfloat16
    # into float32: exact products of bf16 values summed in f32 in another
    # order (the tensor cores' blocks against cuBLAS's), 1e-4 at K <=
    # 16384. Every "fma_async" result also equals the FMA core's bit for
    # bit (the same fma chain over k for every entry), and the skinny
    # route gives the same bits on a second run.
    # The history case as the Cholesky gives it: rows of an n x n buffer
    # times the .mH view of the panel's rows. The skinny case as the dist
    # step's SUMMA_C gives it: a 128-column k-panel of an 8192 x 8192 A
    # block times 128 rows of the (8192 x 2) B block.
    def k1_counts():
        return {core: getattr(matmul, f"launches_{core}")
                for core in K1_CORES}

    k1_module = sys.modules[matmul.__module__]

    def history(dt):
        buf = randn(16384, 16384, dtype=dt)
        return buf[8192:, :7680], buf[8192:8704, :7680].mH

    k1_cases = [
        # (name, operands, out_dtype, core, rtol, bound peak)
        ("history f32", lambda: (randn(8192, 7680), randn(7680, 512)),
         None, "fma_async", 1e-5, PEAK_FP32),
        ("L21 f32", lambda: (randn(15872, 512), randn(512, 512)), None,
         "fma_async", 1e-5, PEAK_FP32),
        ("history bf16 -> f32, B = row.mH", lambda: history(torch.bfloat16),
         torch.float32, "wgmma", 1e-4, PEAK_BF16),
        ("bench bf16", lambda: (randn(16384, 16384, dtype=torch.bfloat16),
                                randn(16384, 16384, dtype=torch.bfloat16)),
         None, "wgmma", 1e-2, PEAK_BF16),
        ("dist step SUMMA_C k-panel f32",
         lambda: (randn(8192, 8192)[:, 128:256], randn(8192, 2)[256:384]),
         None, "skinny", 1e-5, PEAK_FP32),
        ("ragged f32 (rows of 777 floats)",
         lambda: (randn(1000, 777), randn(777, 1001)), None, "fma_async",
         1e-5, PEAK_FP32),
        ("ragged transposed f32",
         lambda: (randn(777, 1000).mT, randn(1001, 777).mT), None,
         "fma_async", 1e-5, PEAK_FP32),
        ("f64 2048^3", lambda: (randn(2048, 2048, dtype=torch.float64),
                                randn(2048, 2048, dtype=torch.float64)),
         None, "fma", 1e-12, PEAK_FP64),
        ("misaligned bf16 (rows of 258 bytes)",
         lambda: (randn(257, 129, dtype=torch.bfloat16),
                  randn(129, 65, dtype=torch.bfloat16)), None, "fma", 1e-2,
         PEAK_FP32),
    ]
    k1_main, k1_case = {}, {}
    for name, make, out_dt, core, rtol, peak in k1_cases:
        a, b = make()
        M, K = a.shape
        N = b.shape[1]
        require(k1_route(a, b) == core,
                f"K1 {name}: route {k1_route(a, b)}, not {core}")
        k1_reset()
        c = matmul(a, b, out_dtype=out_dt)
        require(k1_counts()[core] == 1 and matmul.launches == 1,
                f"K1 {name}: launches {k1_counts()}, not one on {core}")
        ref = matmul_plain(a, b, out_dtype=out_dt)
        sync()
        err = (c.double() - ref.double()).abs().max().item()
        scale = ref.double().abs().max().item()
        require(err <= rtol * scale,
                f"K1 {name}: max_abs_err {err} > {rtol} * {scale}")
        same = ""
        if core == "fma_async":
            require(torch.equal(c, k1_launch("fma", a, b, torch.float32)),
                    f"K1 {name}: the pipeline differs from the FMA core")
            same = ", equal to the FMA core bit for bit"
            if k1_module.tma_unit_dim(a) is None or \
                    k1_module.tma_unit_dim(b) is None:
                # operands that only 4-byte copies can read: the pipeline
                # and the FMA core in turns
                pipe_ms, fma_ms = time_pair(
                    lambda: matmul(a, b),
                    lambda: k1_launch("fma", a, b, torch.float32), 10)
                same += (f" (in turns: pipeline {pipe_ms:.4f} ms, FMA core "
                         f"{fma_ms:.4f} ms)")
        if core == "skinny":
            require(torch.equal(c, matmul(a, b)),
                    f"K1 {name}: two runs give different bits")
            # a call costs more host time than device time here: the
            # device's own time from a CUDA graph of 50 calls, the kernel
            # and torch.matmul each
            graph_ms = []
            for fn in (lambda: matmul(a, b), lambda: torch.matmul(a, b)):
                graph = torch.cuda.CUDAGraph()
                fn()
                sync()
                with torch.cuda.graph(graph):
                    for _ in range(50):
                        fn()
                graph_ms.append(time_ms(graph.replay, 5) / 50)
                del graph
            same = (f", the same bits on a second run (replayed from a CUDA "
                    f"graph: kernel {graph_ms[0]:.4f} ms, torch.matmul "
                    f"{graph_ms[1]:.4f} ms a call)")
        iters = 2 if M * N * K > 1e12 else (50 if M * N * K < 1e8 else 10)
        ms, plain_ms = time_pair(lambda: matmul(a, b, out_dtype=out_dt),
                                 lambda: matmul_plain(a, b, out_dtype=out_dt),
                                 iters)
        tf = 2 * M * N * K / ms / 1e9
        # the library call: torch.matmul in the operands' type (cuBLAS; on
        # the tensor cores for bf16)
        lib_ms = time_ms(lambda: torch.matmul(a, b), iters)
        nbytes = (a.element_size() * (M * K + K * N)
                  + c.element_size() * M * N)
        bound = roofline(2 * M * N * K, nbytes, peak)
        print(f"K1 {name} ({M}x{K})x({K}x{N}) on {core}: max_abs_err "
              f"{err:.3e} (tol {rtol} x {scale:.3e}){same}  kernel "
              f"{ms:.4f} ms ({tf:.2f} TFLOP/s, {bound[0] / ms:.1%} of the "
              f"{bound[1]} bound {bound[0]:.4f} ms)  plain {plain_ms:.4f} ms"
              f"  torch.matmul {lib_ms:.4f} ms (kernel / library "
              f"{ms / lib_ms:.3f})")
        k1_main.setdefault(core, (err, ms, plain_ms, lib_ms, bound))
        k1_case.setdefault(core, f"{name} ({M}x{K})x({K}x{N})")
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
            # Cholesky w^3/3 and the triangular inverse w^3/3; the block
            # read once, l11 and invLH written once
            k3_main = (err, ms, plain_ms, roofline(2 * w ** 3 / 3, 12 * w * w))

    # From here on every K1 launch on the FMA core is named by its operands
    # (fma_named), and the float64 runs of the slices against the CPU
    # count their K1 launches by core (f64_k1): float64 of more than 16
    # columns is what stays on the FMA core.
    fma_named, f64_k1 = {}, {}

    def k1_launch_named(core, a_, b_, out_dtype):
        if core == "fma":
            key = (f"{str(a_.dtype)[6:]} ({a_.shape[0]}x{a_.shape[1]})x"
                   f"({b_.shape[0]}x{b_.shape[1]}) strides "
                   f"{tuple(a_.stride())} {tuple(b_.stride())}")
            fma_named[key] = fma_named.get(key, 0) + 1
        return k1_launch(core, a_, b_, out_dtype)

    k1_module._launch = k1_launch_named

    def f64_run(name, fn):
        k1_reset()
        out = fn()
        sync()
        f64_k1[name] = {"K1 cores": k1_counts()}
        return out

    # ---- 4. the slice ----
    # A small float64 problem on the card against the same step on the
    # CPU, where every kernel wrapper takes its plain version.
    step, (a, b) = entry(n=300, nrhs=5, dtype=torch.float64, device=dev)
    x_gpu, _ = f64_run("HPD n=300", lambda: step(a, b))
    x_cpu, _ = hpd_solve_step(a.cpu(), b.cpu())
    diff = (x_gpu.cpu() - x_cpu).abs().max().item()
    require(diff <= 1e-10 * x_cpu.abs().max().item(),
            f"slice n=300 f64: card and CPU differ by {diff}")
    print(f"slice n=300 f64: card vs CPU max|dX| {diff:.3e}")

    n, nrhs = 16384, 256
    step, (a, b) = entry(n=n, nrhs=nrhs, dtype=torch.float32, device=dev)
    sync()
    k1_reset()
    potrf_block_inv.launches = 0
    k9_reset()
    t0 = time.perf_counter()
    x, nrm = step(a, b)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {"K1": matmul.launches, "K1 cores": k1_counts(),
                "K3a": potrf_block_inv.launches,
                "K9": k9_counts()}
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
    require(launches["K9"]["transpose"] == 0,
            f"a K9 transpose on the HPD path: {launches}")
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
    # Each shape runs on the route k4_route gives it (the cluster route:
    # one thread-block cluster, one cluster barrier a column; the grid
    # route: one grid.sync() a column) and must launch it. Where the
    # cluster route runs, the grid route (the first design) gives the same
    # bits and is timed in turns with it. The chain floor: w columns x the
    # step the route repeats a column, from kernels/sync_probe.py (a
    # cluster barrier and a DSMEM read at the cluster's size; a grid.sync
    # over 132 CTAs).
    sync_us = {c: sync_step_us("cluster barrier + DSMEM read", c)
               for c in (1, 2, 4, 8, 16)}
    bar_us = {c: sync_step_us("cluster barrier", c) for c in (1, 2, 4, 8, 16)}
    gsync_us = sync_step_us("grid.sync", 132)
    print(f"synchronisation steps (kernels/sync_probe.py): grid.sync over "
          f"132 CTAs {gsync_us:.3f} us; cluster barrier "
          + ", ".join(f"{c} CTAs {t:.3f} us" for c, t in bar_us.items())
          + "; barrier + DSMEM read "
          + ", ".join(f"{c} CTAs {t:.3f} us" for c, t in sync_us.items()))

    def k4_floor(Mt, w, dt):
        c = k4_ctas(Mt, dt)
        return w * (sync_us[c] if c else gsync_us) / 1e3

    k4_main = None
    for Mt, w, dt in ((16384, 512, torch.float32), (8192, 512, torch.float32),
                      (1000, 200, torch.float32), (4096, 512, torch.float64),
                      (16384, 512, torch.float64)):
        a = randn(Mt, w, dtype=torch.float64).to(dt)
        rt = k4_route(Mt, dt)
        k4_reset()
        out, piv = getrf_panel(a)
        require(getattr(getrf_panel, f"launches_{rt}") == 1
                and getrf_panel.launches == 1,
                f"K4 ({Mt},{w}) {dt}: not one launch on the {rt} route")
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
        turns = ""
        if rt == "cluster":
            og, pg = k4_launch("grid", a)
            sync()
            require(torch.equal(og, out) and torch.equal(pg, piv),
                    f"K4 ({Mt},{w}) {dt}: the cluster and grid routes "
                    "differ")
            c_ms, g_ms = time_pair(lambda: k4_launch("cluster", a),
                                   lambda: k4_launch("grid", a), 5)
            turns = (f"; in turns: cluster route {c_ms:.4f} ms, grid route "
                     f"(the first design) {g_ms:.4f} ms, the same bits")
        flops, nbytes = Mt * w * w - w ** 3 / 3, dt.itemsize * 2 * Mt * w
        bound = roofline(flops, nbytes)
        print(f"K4 ({Mt},{w}) {str(dt)[6:]} {rt} route "
              f"({k4_ctas(Mt, dt)} CTAs): max|PA-LU| {resid:.3e} "
              f"(tol {tol:.2e} x {scale:.3f}), max|L| {lmax:.6f}, "
              f"{ndiff} pivots differ, max|out-plain| {err:.3e}  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
              f"{bound[0]:.4f} ms ({bound[1]})  chain floor "
              f"{k4_floor(Mt, w, dt):.4f} ms" + turns)
        if k4_main is None:
            lib_ms = time_ms(lambda: torch.linalg.lu_factor_ex(a), 5)
            k4_main = (err, ms, plain_ms, lib_ms, bound)
        del a, out, ref, packed, L, U, ad
    # the LU path's sub-panels at n=16384: (16384 - k0, 512), k0 = 0, 512,
    # ...; each on its route, beside its chain floor
    a = randn(16384, 512)
    parts = []
    for Mt in range(16384, 0, -512):
        sub = a[16384 - Mt:]
        ms = time_ms(lambda: getrf_panel(sub), 3)
        parts.append(f"{Mt}: {k4_route(Mt, sub.dtype)} "
                     f"{k4_ctas(Mt, sub.dtype)} CTAs {ms:.4f} ms, floor "
                     f"{k4_floor(Mt, 512, sub.dtype):.4f}")
    print("K4 at the LU path's sub-panel heights (Mt: route, ms, chain "
          "floor ms): " + "; ".join(parts))
    del a, sub

    # ---- 6. the LU slice ----
    a, b = make_lu_problem(300, 5, dtype=torch.float64, device=dev)
    x_gpu, _ = f64_run("LU n=300", lambda: linear_solve_step(a, b))
    x_cpu, _ = linear_solve_step(a.cpu(), b.cpu())
    diff = (x_gpu.cpu() - x_cpu).abs().max().item()
    require(diff <= 1e-10 * x_cpu.abs().max().item(),
            f"LU slice n=300 f64: card and CPU differ by {diff}")
    print(f"LU slice n=300 f64: card vs CPU max|dX| {diff:.3e}")

    a, b = make_lu_problem(n, nrhs, dtype=torch.float32, device=dev)
    sync()
    k1_reset()
    k4_reset()
    k9_reset()
    t0 = time.perf_counter()
    x, nrm = linear_solve_step(a, b)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    lu_launches = {"K1": matmul.launches, "K1 cores": k1_counts(),
                   "K4": getrf_panel.launches,
                   "K4 routes": {r: getattr(getrf_panel, f"launches_{r}")
                                 for r in ("cluster", "grid")},
                   "K9": k9_counts()}
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
    require(lu_launches["K4 routes"]["cluster"] == lu_launches["K4"],
            f"a K4 panel of the LU path left the cluster route: "
            f"{lu_launches}")
    require(lu_launches["K9"]["transpose"] == 0,
            f"a K9 transpose on the LU path: {lu_launches}")
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
        same = all(torch.equal(o, o2)
                   for o, o2 in zip(out, latrd_panel(a, k0, w, 128)))
        require(same, f"K5 ({M},{k0},{w}): two runs give different bits")
        print(f"K5 latrd panel (M={M}, k0={k0}, w={w}) {str(dt)[6:]}: "
              f"max_abs_err P {errs[0]:.3e} W {errs[1]:.3e} tau "
              f"{errs[2]:.3e} (rtol {rtol}), max|(|[1;v]|^2 tau - 2)| "
              f"{unit:.2e}, the same bits on a second run  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms")
        # per column j: the symv over the trailing order m_j = m0 - j - 1
        # (2 m_j^2) and the V/W corrections (8 m_j j). The bound: those
        # operations, and each byte read once (the trailing lower
        # triangle, m0 (m0 + 1) / 2 words) and P and W written once.
        # Beside it the floor of K5's algorithm:
        # column j + 1's symv needs column j's reflector, so every column
        # streams its trailing triangle again (m_j (m_j + 1) / 2 words);
        # a triangle that fits in the 50 MB L2 comes back from there
        # after the first column, so that floor does not bind on HBM.
        m0 = M - k0
        esz = a.element_size()
        fl = sum(2 * (m0 - j - 1) ** 2 + 8 * (m0 - j - 1) * j
                 for j in range(w))
        tri = sum((m0 - j - 1) * (m0 - j) / 2 for j in range(w))
        bound = roofline(fl, esz * (m0 * (m0 + 1) / 2 + 2 * m0 * w))
        stream = roofline(fl, esz * (tri + 2 * m0 * w))
        in_l2 = esz * m0 * (m0 + 1) / 2 <= L2_BYTES
        print(f"K5 ({M},{k0},{w}) {str(dt)[6:]}: bound {bound[0]:.4f} ms "
              f"(by {bound[1]}), kernel at {bound[0] / ms:.1%} of it; the "
              f"algorithm's floor {stream[0]:.4f} ms (by {stream[1]}: "
              f"{esz * tri / 1e9:.2f} GB, the trailing triangle once a "
              f"column), kernel at {stream[0] / ms:.1%} of it"
              + ("; the triangle fits in the 50 MB L2, so that floor does "
                 "not bind" if in_l2 else ""))
        if k5_main is None:
            k5_main = (max(errs), ms, plain_ms, bound)
            # the whole reduction of order M: every column j < M - 2
            # streams its trailing triangle of order M - j - 1
            whole = esz * sum((M - j - 1) * (M - j) / 2
                              for j in range(M - 2))
            print(f"K5 bound of the whole reduction at M={M} "
                  f"{str(dt)[6:]}: {whole / PEAK_BYTES * 1e3:.1f} ms "
                  f"({whole / 1e9:.1f} GB)")
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
    # n=8192, b=256, 101 s at b=128 (NVIDIA H100 80GB HBM3, 700 W). Each
    # shape runs on the route k6_route gives it and must launch it; the
    # kernel runs before and after the one plain run (kernel, plain,
    # kernel). At n=8192 the l2 route (the first design) runs in turns
    # with the cluster route (cluster, l2, l2, cluster) and is held to the
    # same spectrum. Beside the roofline bound (the band read once, 8 b^2
    # operations an op) stands the chain floor: the ops on the critical
    # path at the kernel's lag of two (k6_chain_ops) x the least time of
    # one op on the C SMs of its cluster, the larger of its 8 b^2 FP32
    # operations at C/132 of the card's peak and its three cluster
    # barriers (kernels/sync_probe.py).
    def k6_floor(m, b):
        c = k6_ctas(b, torch.float32)
        op_us = max(8 * b * b / (c * PEAK_FP32 / 132) * 1e6,
                    3 * bar_us[c])
        return k6_chain_ops(m, b, 2) * op_us / 1e3, op_us

    k6_main = None
    eps32 = torch.finfo(torch.float32).eps
    for m, b in ((8192, 256), (8192, 128), (1000, 16)):
        ab = band(m, b, torch.float32)
        ev = torch.linalg.eigvalsh(ab.double())
        wmax = ev.abs().max().item()
        bound = 100 * m * eps32 * wmax
        rt = k6_route(b, torch.float32)

        def run_k6():
            sync()
            t0 = time.perf_counter()
            out = sb2tr(ab, b)
            sync()
            return out, (time.perf_counter() - t0) * 1e3

        k6_reset()
        (v, d, e), k_first = run_k6()
        require(getattr(sb2tr, f"launches_{rt}") == 1
                and sb2tr.launches == 1,
                f"K6 n={m} b={b}: not one launch on the {rt} route")
        wk = spectrum(d, e)
        errk = (wk - ev).abs().max().item()
        require(errk <= bound, f"K6 n={m} b={b}: spectrum error {errk} > "
                               f"{bound}")
        t0 = time.perf_counter()
        _, dp, ep = sb2tr_plain(ab, b)
        sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        (v2, d2, e2), k_second = run_k6()
        require(torch.equal(v, v2) and torch.equal(d, d2)
                and torch.equal(e, e2),
                f"K6 n={m} b={b}: two runs differ")
        ms = (k_first + k_second) / 2
        wp = spectrum(dp, ep)
        errp = (wp - ev).abs().max().item()
        errkp = (wk - wp).abs().max().item()
        require(errp <= bound, f"K6 n={m} b={b}: the plain chase's "
                               f"spectrum error {errp} > {bound}")
        require(errkp <= 1e-4 * wmax, f"K6 n={m} b={b}: kernel and "
                                      f"plain spectra {errkp} apart")
        roof = roofline(4 * m * m * b, 4 * (2 * m * (b + 1) + 2 * m))
        floor, op_us = k6_floor(m, b)
        if k6_main is None:
            # about n^2 / (2b) ops of 8 b^2 operations each (the
            # two-sided update of a b x b block and the one-sided one
            # of the block below it); the band read once, vout, d
            # and e written once
            k6_main = (errkp, ms, plain_ms, roof)
        turns = ""
        if m == 8192:
            l2_ms, cl_ms = time_pair(lambda: k6_launch("l2", ab, b),
                                     lambda: k6_launch("cluster", ab, b), 1)
            _, dl, el = k6_launch("l2", ab, b)
            errl = (spectrum(dl, el) - ev).abs().max().item()
            require(errl <= bound, f"K6 n={m} b={b}: the l2 route's "
                                   f"spectrum error {errl} > {bound}")
            turns = (f"; in turns: cluster route {cl_ms:.1f} ms, l2 route "
                     f"(the first design) {l2_ms:.1f} ms (spectrum error "
                     f"{errl:.3e})")
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
        print(f"K6 bulge chase n={m} b={b} f32 {rt} route "
              f"({k6_ctas(b, torch.float32)} CTAs a sweep): spectrum error "
              f"{errk:.3e} (bound {bound:.3e}), max|Q2^T Q2 - I| {orth:.3e}, "
              f"max|Q2^T A Q2 - T| {red:.3e} (tol {1e-4 * wmax:.3e})  "
              f"kernel {k_first:.1f} / {k_second:.1f} ms (the same bits)  "
              f"plain {plain_ms:.1f} ms (one run), its spectrum error "
              f"{errp:.3e}, kernel vs plain spectra {errkp:.3e}  roofline "
              f"bound {roof[0]:.4f} ms ({roof[1]})  chain floor "
              f"{floor:.2f} ms ({k6_chain_ops(m, b, 2)} ops x {op_us:.3f} "
              f"us)" + turns)
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
    w_gpu, q_gpu, _ = f64_run("HermitianEig n=300",
                              lambda: hermitian_eig_step(h))
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
        k1_reset()
        latrd_panel.launches = 0
        k6_reset()
        k9_reset()
        t0 = time.perf_counter()
        w, q, r = hermitian_eig_step(h, ctrl)
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        eig_launches[alg] = {"K1": matmul.launches, "K1 cores": k1_counts(),
                             "K5": latrd_panel.launches,
                             "K6": sb2tr.launches,
                             "K6 routes": {r: getattr(sb2tr, f"launches_{r}")
                                           for r in ("cluster", "l2")},
                             "K9": k9_counts()}
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
        require(lc["K9"]["transpose"] == 0,
                f"a K9 transpose on the eig path ({alg}): {lc}")
        require(lc["K6 routes"]["cluster"] == lc["K6"],
                f"a K6 chase on the eig path ({alg}) left the cluster "
                f"route: {lc}")
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

    # Tridiagonalization plus backtransform of an n x n block, best of
    # three, through latrd, SBR b=256 and SBR b=128: the measurement that
    # sets hermitian_eig.SBR_AUTO_BAND and SBR_AUTO_MIN_N. The identity
    # stands in for the eigenvectors (the backtransform's cost does not
    # depend on them).
    def tri_bt(hn, alg, bw):
        nn = hn.shape[0]
        Z = torch.eye(nn, device=dev)
        if alg == "latrd":
            f = condense.HermitianTridiag(
                Et.LOWER, Et.DistMatrix.from_global(hn, grid=Et.Grid(dev)))
            Mp = f.packed.data.shape[0]
            Zf = Z.new_zeros((Mp, Mp))
            Zf[:nn, :nn] = Z
            return condense.tridiag_apply_q(f, Zf, False)
        return sbr.sbr_apply_q(sbr.sbr_tridiag(hn, bw), Z, bw)

    table = []
    for nn in (1024, 2048, 4096, 8192):
        hn = make_eig_problem(nn, device=dev)
        best = {}
        for alg, bw in (("latrd", 0), ("SBR b=256", 256), ("SBR b=128", 128)):
            best[alg] = min(stage(lambda: tri_bt(hn, alg.split()[0], bw))[1]
                            for _ in range(3))
        table.append((nn, best))
        del hn
    print("tridiagonalization + backtransform, best of three (ms): "
          + "; ".join(f"n={nn} " + " / ".join(f"{k} {v:.1f}"
                                              for k, v in best.items())
                      + f" (fastest: {min(best, key=best.get)})"
                      for nn, best in table)
          + f"; tridiag_alg='auto' takes SBR with band {sbr_auto[0]} from "
            f"n={sbr_auto[1]} (HermitianEigCtrl's default band "
            f"{HermitianEigCtrl().band})")
    torch.linalg.eigh(h)
    _, eigh_ms = stage(lambda: torch.linalg.eigh(h))
    print(f"torch.linalg.eigh n={ne} f32 (context): {eigh_ms:.1f} ms")

    # ---- 9. K2, K3b, K3c and K7 against their plain versions ----
    def tri_off(M, N, lower):
        i = torch.arange(M, device=dev)[:, None]
        j = torch.arange(N, device=dev)[None, :]
        return (j > i) if lower else (j < i)

    # K2 tolerance: max|out - plain| <= rtol * max|plain|; float32 1e-5
    # (FP32 sums of K terms, possibly in another order), float64 1e-12;
    # entries off the triangle must equal C bit for bit.
    k2_main = None
    for name, M, K, N, lower, dt in (
            ("trailing update", 15872, 512, 15872, True, torch.float32),
            ("upper", 4096, 512, 4096, False, torch.float32),
            ("ragged", 1000, 777, 1001, True, torch.float32),
            ("f64", 2048, 256, 2048, True, torch.float64)):
        a, b, c = (randn(M, K, dtype=dt), randn(K, N, dtype=dt),
                   randn(M, N, dtype=dt))
        out = masked_rank_k(lower, -1.0, a, b, 1.0, c)
        ref = masked_rank_k_plain(lower, -1.0, a, b, 1.0, c)
        sync()
        rtol = 1e-5 if dt == torch.float32 else 1e-12
        err = (out.double() - ref.double()).abs().max().item()
        scale = ref.double().abs().max().item()
        off = tri_off(M, N, lower)
        require(err <= rtol * scale, f"K2 {name}: {err} > {rtol} * {scale}")
        require(torch.equal(out[off], c[off]),
                f"K2 {name}: entries off the triangle changed")
        del off, out, ref
        iters = 3 if M * N * K > 1e11 else 10
        ms, plain_ms = time_pair(
            lambda: masked_rank_k(lower, -1.0, a, b, 1.0, c),
            lambda: masked_rank_k_plain(lower, -1.0, a, b, 1.0, c), iters)
        tri = sum(min(i + 1, N) if lower else max(N - i, 0)
                  for i in range(M))
        print(f"K2 {name} ({M}x{K})x({K}x{N}) {'lower' if lower else 'upper'}"
              f" {str(dt)[6:]}: max_abs_err {err:.3e} (tol {rtol} x "
              f"{scale:.3e}), off-triangle entries equal C  kernel "
              f"{ms:.4f} ms ({2 * K * tri / ms / 1e9:.2f} TFLOP/s on the "
              f"triangle)  plain {plain_ms:.4f} ms")
        if k2_main is None:
            addmm_ms = time_ms(lambda: torch.where(
                tri_off(M, N, lower), c, torch.addmm(c, a, b, alpha=-1.0)),
                iters)
            print(f"K2 context: torch.addmm over the full square + "
                  f"torch.where {addmm_ms:.4f} ms")
            k2_main = (err, ms, plain_ms,
                       roofline(2 * K * tri, 4 * (M * K + K * N + 2 * tri)))
        del a, b, c

    # K3b tolerance: L21 within 1e-5 of max|plain| (float32; a block of
    # condition number below 3), 5e-4 with low_apply (both versions round
    # the apply's operands to bfloat16, from inverses that differ in
    # float32 rounding, so a few operands land on the neighbouring bf16
    # value: about 7e-5 measured), and then K3b without low_apply must lie
    # more than ten times that error away (the rounding itself moves L21 by
    # about 3e-3 of max|L21|, so a kernel that skipped it fails); L11 must
    # equal K3a's output bit for bit (the same device code in the same
    # order); a block that is not positive definite gives NaN in every row.
    def spd_block(w):
        g = randn(w, w, dtype=torch.float64)
        return (g @ g.mT / w + 2 * torch.eye(w, device=dev,
                                            dtype=torch.float64)).float()

    k3b_main = None
    for Mt, w, low in ((16384, 512, False), (16384, 512, True),
                       (8192, 2048, False), (8192, 2048, True),
                       (1000, 200, False)):
        sym = spd_block(w)
        pan = randn(Mt, w)
        pan[:w] = float("nan")  # the diagonal block's rows are never read
        out = potrf_panel_tail(sym, pan, low_apply=low)
        ref = potrf_panel_tail_plain(sym, pan, low_apply=low)
        l11, _ = potrf_block_inv(sym)
        sync()
        rtol = 5e-4 if low else 1e-5
        err = (out[w:] - ref[w:]).abs().max().item()
        scale = ref[w:].abs().max().item()
        require(err <= rtol * scale,
                f"K3b ({Mt},{w}) low={low}: {err} > {rtol} * {scale}")
        sep = ""
        if low:
            unrounded = potrf_panel_tail(sym, pan)
            sync()
            gap = (out[w:] - unrounded[w:]).abs().max().item()
            require(gap > 10 * err,
                    f"K3b ({Mt},{w}): low_apply moves L21 by {gap}, not "
                    f"more than 10 x {err}")
            sep = f", {gap:.3e} from low_apply=False"
            del unrounded
        require(torch.equal(out[:w], l11),
                f"K3b ({Mt},{w}): L11 differs from K3a's")
        bad = potrf_panel_tail(-sym, pan, low_apply=low)
        sync()
        require(bool(bad.isnan().all()),
                f"K3b ({Mt},{w}): a non-HPD block was not poisoned")
        ms, plain_ms = time_pair(
            lambda: potrf_panel_tail(sym, pan, low_apply=low),
            lambda: potrf_panel_tail_plain(sym, pan, low_apply=low), 5)
        print(f"K3b ({Mt},{w}) low_apply={low}: max_abs_err L21 {err:.3e} "
              f"(tol {rtol} x {scale:.3e}){sep}, L11 equal to K3a's, "
              f"non-HPD -> NaN  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        if k3b_main is None:
            # the work: chol of the block (w^3/3) and a triangular solve
            # for L21 ((Mt - w) w^2)
            k3b_main = (err, ms, plain_ms,
                        roofline(w ** 3 / 3 + (Mt - w) * w * w,
                                 4 * (w * w + (Mt - w) * w + Mt * w)))
        del pan, out, ref, bad

    # K3c: its rows from tile kidx on equal K3b's on the same rows, bit
    # for bit, and the rows above are exact zeros. No driver calls K3c
    # (in either package), so its launches are one sweep over the HPD
    # path's 32 panel shapes (n=16384, nb=512).
    M3, w3 = 16384, 512
    nt = M3 // w3
    kmid = nt // 2 - 1
    sym = spd_block(w3)
    pan = randn(M3, w3)
    for k in (0, kmid, nt - 1):
        o = potrf_panel_tail_full(sym, pan, k)
        r = potrf_panel_tail(sym, pan[k * w3:])
        sync()
        require(torch.equal(o[k * w3:], r) and not bool(o[:k * w3].any()),
                f"K3c kidx={k}: not K3b's rows below zeros")
    o = potrf_panel_tail_full(sym, pan, kmid)
    r = potrf_panel_tail_full_plain(sym, pan, kmid)
    sync()
    k3c_err = (o - r).abs().max().item()
    require(k3c_err <= 1e-5 * r.abs().max().item(),
            f"K3c kidx={kmid}: {k3c_err} from its plain version")
    ms, plain_ms = time_pair(
        lambda: potrf_panel_tail_full(sym, pan, kmid),
        lambda: potrf_panel_tail_full_plain(sym, pan, kmid), 5)
    r0 = kmid * w3
    k3c_main = (k3c_err, ms, plain_ms,
                roofline(w3 ** 3 / 3 + (M3 - r0 - w3) * w3 * w3,
                         4 * (w3 * w3 + (M3 - r0 - w3) * w3 + M3 * w3)))
    sync()
    potrf_panel_tail_full.launches = 0
    for k in range(nt):
        potrf_panel_tail_full(sym, pan, k)
    sync()
    k3c_launches = potrf_panel_tail_full.launches
    require(k3c_launches == nt, f"K3c sweep: {k3c_launches} launches")
    print(f"K3c ({M3},{w3}) kidx 0/{kmid}/{nt - 1}: rows from the diagonal "
          f"tile equal K3b's, zeros above; kidx={kmid} max_abs_err "
          f"{k3c_err:.3e}  kernel "
          f"{ms:.4f} ms  plain {plain_ms:.4f} ms; sweep over the {nt} panel "
          f"shapes: {k3c_launches} launches")
    del sym, pan, o, r

    # K7 tolerance: 1e-5 of max|y| in float32 (sums of n terms in another
    # order), 1e-12 in float64; NaN in the strict upper triangle must not
    # reach y; two runs give the same bits. Each case names the core
    # route() gives it: the TMA tiles for rows 16-byte multiples apart (any
    # k0), the scalar unit otherwise (n = 16383 float32, the order of
    # phase 10's second Symv). At n = 16384 the two cores also run in turns
    # (tma, unit, unit, tma) through their C entries.
    k7_main = {}
    for n7, k0, dt, want in ((16384, 0, torch.float32, "tma"),
                             (16384, 5000, torch.float32, "tma"),
                             (4096, 0, torch.float64, "tma"),
                             (16383, 0, torch.float32, "unit")):
        A = randn(n7, n7, dtype=dt)
        v = randn(n7 - k0, dtype=dt)
        An = A.clone()
        iu = torch.triu_indices(n7, n7, 1, device=dev)
        An[iu[0], iu[1]] = float("nan")
        del iu
        core = k7_route(An[k0:, k0:])
        require(core == want, f"K7 n={n7} k0={k0}: route {core}, not {want}")
        run = (lambda: symv_lower(An, v)) if k0 == 0 else \
            (lambda: symv_lower_trailing(An, v, k0))
        y, y2 = run(), run()
        ref = symv_lower_plain(A[k0:, k0:], v)
        sync()
        rtol = 1e-5 if dt == torch.float32 else 1e-12
        err = (y - ref).abs().max().item()
        scale = ref.abs().max().item()
        require(err <= rtol * scale, f"K7 n={n7} k0={k0}: {err} > {rtol} * "
                                     f"{scale}")
        require(torch.equal(y, y2), f"K7 n={n7}: two runs differ")
        ms, plain_ms = time_pair(run, lambda: symv_lower_plain(A[k0:, k0:], v),
                                 10)
        m7, esz = n7 - k0, A.element_size()
        tri_bytes = esz * m7 * (m7 + 1) / 2
        b7 = roofline(2 * m7 * m7, tri_bytes + esz * 2 * m7)
        extra = ""
        if k0 == 0 and dt == torch.float32:
            H = torch.tril(A) + torch.tril(A, -1).mT
            lib_ms = time_ms(lambda: torch.mv(H, v), 10)
            del H
            k7_main[core] = (err, ms, plain_ms, lib_ms, b7)
            extra = (f"  torch.mv on the full symmetric matrix {lib_ms:.4f} "
                     f"ms")
        print(f"K7 symv ({core}) n={n7} k0={k0} {str(dt)[6:]} (NaN above the "
              f"diagonal): max_abs_err {err:.3e} (tol {rtol} x {scale:.3e}),"
              f" same bits twice  kernel {ms:.4f} ms "
              f"({tri_bytes / ms / 1e6:.1f} GB/s of the triangle; bound "
              f"{b7[0]:.4f} ms, {b7[0] / ms:.1%} of it)  plain "
              f"{plain_ms:.4f} ms{extra}")
        if core == "tma" and n7 == 16384 and k0 == 0:
            tma_ms, unit_ms = time_pair(lambda: k7_launch("tma", An, v),
                                        lambda: k7_launch("unit", An, v), 10)
            print(f"K7 cores in turns at n={n7} f32: tma {tma_ms:.4f} ms "
                  f"({tri_bytes / tma_ms / 1e6:.1f} GB/s), unit "
                  f"{unit_ms:.4f} ms ({tri_bytes / unit_ms / 1e6:.1f} GB/s)")
        del A, An, v, y, y2, ref
    require(set(k7_main) == set(K7_CORES), f"K7: no row for "
                                           f"{set(K7_CORES) - set(k7_main)}")

    # ---- 10. the fused-tail HPD slice ----
    os.environ["ELX_PALLAS_POTRF"] = "1"
    try:
        step, (a, b) = entry(n=n, nrhs=nrhs, dtype=torch.float32, device=dev)
        sync()
        k1_reset()
        potrf_block_inv.launches = 0
        potrf_panel_tail.launches = 0
        k9_reset()
        t0 = time.perf_counter()
        x, nrm = step(a, b)
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        fused_launches = {"K1": matmul.launches, "K1 cores": k1_counts(),
                          "K3a": potrf_block_inv.launches,
                          "K3b": potrf_panel_tail.launches,
                          "K9": k9_counts()}
        t0 = time.perf_counter()
        step(a, b)
        sync()
        again_ms = (time.perf_counter() - t0) * 1e3
        require(tuple(x.shape) == (n, nrhs) and bool(torch.isfinite(x).all()),
                "fused HPD slice: non-finite or misshapen X")
        resid = ((a.double() @ x.double() - b.double()).abs().max()
                 / (eps * n * b.double().abs().max())).item()
        require(resid < 100, f"fused HPD slice: scaled residual {resid}")
        require(fused_launches["K3b"] == 32 and fused_launches["K3a"] == 0
                and fused_launches["K1"] > 0
                and fused_launches["K9"]["transpose"] == 0,
                f"fused HPD slice launches {fused_launches}")
        print(f"slice HPDSolve with the fused tail (ELX_PALLAS_POTRF=1), "
              f"n={n} nrhs={nrhs} f32: {first_ms:.1f} ms (first run), "
              f"{again_ms:.1f} ms (second run); scaled residual "
              f"{resid:.4f}; launches {fused_launches}")
        for label in ("fused tail", "default (K3a)"):
            if label != "fused tail":
                os.environ.pop("ELX_PALLAS_POTRF", None)
            wall, by_name, _ = device_profile(lambda: step(a, b))
            busy = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            print(f"HPD step profile ({label}), n={n} f32: wall {wall:.1f} "
                  f"ms, device busy {busy:.1f} ms (idle "
                  f"{100 * (1 - busy / wall):.1f}%); "
                  + "; ".join(f"{k[:40]} {v:.1f} ms ({100 * v / wall:.1f}%)"
                              for k, v in top))
        os.environ["ELX_PALLAS_POTRF"] = "1"
        del x, b

        # bfloat16 storage: the fused tail with low_apply beside the
        # default (K3a) path; max|A - L L^T| / max|A| < 5e-2 for the fused.
        # Every history product (bf16 operands, f32 result: two a panel
        # from the third, one for the second) must take K1's tensor-core
        # core: none on the FMA core; the default path's L21 products are
        # float32 (the pipelined FMA core), the fused path has none.
        a16 = a.bfloat16()
        A16 = Et.DistMatrix.from_global(a16, grid=Et.Grid(dev))
        ab = a16.float()
        from elementalx_torch.core.environment import Blocksize
        nb16 = max(Blocksize(), 512)
        hist_products = sum(1 + (k0 > nb16) for k0 in range(nb16, n, nb16))
        errs16, chol16 = {}, {}
        for label, fuse in (("fused tail", True), ("default", False)):
            if fuse:
                os.environ["ELX_PALLAS_POTRF"] = "1"
            else:
                os.environ.pop("ELX_PALLAS_POTRF", None)
            potrf_panel_tail.launches = potrf_block_inv.launches = 0
            k1_reset()
            sync()
            t0 = time.perf_counter()
            L16 = Et.Cholesky(Et.LOWER, A16)
            sync()
            t16 = (time.perf_counter() - t0) * 1e3
            cores = k1_counts()
            chol16[label] = cores
            Lf = L16.data.float()
            errs16[label] = ((Lf @ Lf.mT - ab).abs().max()
                             / ab.abs().max()).item()
            require(cores["wgmma"] == hist_products and cores["fma"] == 0
                    and cores["fma_async"] == (0 if fuse else n // nb16 - 1),
                    f"bf16 Cholesky ({label}): K1 launches {cores}; want "
                    f"{hist_products} history products on wgmma, none on "
                    "fma")
            print(f"Cholesky bf16 storage n={n} ({label}): "
                  f"max|A - LL^T|/max|A| = {errs16[label]:.4e}; {t16:.1f} "
                  f"ms; launches K3b {potrf_panel_tail.launches}, K3a "
                  f"{potrf_block_inv.launches}, K1 {cores} (every one of "
                  f"the {hist_products} history products on wgmma)")
            del L16, Lf
        os.environ["ELX_PALLAS_POTRF"] = "1"
        require(all(e < 5e-2 for e in errs16.values()),
                f"bf16 Cholesky: max|A - LL^T|/max|A| {errs16}")
        del a, a16, A16, ab
    finally:
        os.environ.pop("ELX_PALLAS_POTRF", None)

    # the public level-2/3 operations at phase 9's shapes
    g2 = Et.Grid(dev)
    M2, K2w = 15872, 512
    a = randn(M2, K2w)
    b = randn(K2w, M2)
    c = randn(M2, M2)
    A2 = Et.DistMatrix.from_global(a, grid=g2)
    B2 = Et.DistMatrix.from_global(b, grid=g2)
    C2 = Et.DistMatrix.from_global(c, grid=g2)
    # Symv at n (rows 16-byte multiples apart: K7's TMA tiles) and at
    # n - 1 (float32 rows of 65532 bytes: the scalar unit)
    hv = randn(n, n)
    xv = randn(n, 1)
    H2 = Et.DistMatrix.from_global(hv, grid=g2)
    X2 = Et.DistMatrix.from_global(xv, grid=g2)
    H3 = Et.DistMatrix.from_global(hv[1:, 1:].contiguous(), grid=g2)
    X3 = Et.DistMatrix.from_global(xv[1:].contiguous(), grid=g2)
    sync()
    k1_reset()
    k7_reset()
    masked_rank_k.launches = 0
    t0 = time.perf_counter()
    Hk = Et.Herk(Et.LOWER, Et.NORMAL, -1.0, A2, beta=1.0, C=C2)
    Tk = Et.Trrk(Et.LOWER, Et.NORMAL, Et.NORMAL, -1.0, A2, B2, 1.0, C2)
    Yv = Et.Symv(Et.LOWER, 1.0, H2, X2)
    Yv3 = Et.Symv(Et.LOWER, 1.0, H3, X3)
    sync()
    blas_ms = (time.perf_counter() - t0) * 1e3
    blas_launches = {"K2": masked_rank_k.launches,
                     "K7": {core: getattr(symv_lower, f"launches_{core}")
                            for core in K7_CORES},
                     "K1": matmul.launches}
    require(blas_launches == {"K2": 2, "K7": {"tma": 1, "unit": 1},
                              "K1": 0},
            f"Herk/Trrk/Symv launches {blas_launches}")
    checks = ((Hk.data, masked_rank_k_plain(True, -1.0, a, a.mT, 1.0, c)),
              (Tk.data, masked_rank_k_plain(True, -1.0, a, b, 1.0, c)),
              (Yv.data[:, 0], symv_lower_plain(hv, xv[:, 0])),
              (Yv3.data[:, 0], symv_lower_plain(hv[1:, 1:], xv[1:, 0])))
    for (out, ref), name in zip(checks, ("Herk", "Trrk", "Symv",
                                         "Symv n-1")):
        err = (out - ref).abs().max().item()
        require(err <= 1e-5 * ref.abs().max().item(),
                f"{name} at the phase 9 shape: {err} from the plain result")
    print(f"Herk + Trrk ({M2}x{K2w}, lower, C {M2}^2) + Symv (n={n} and "
          f"{n - 1}, LOWER) f32: {blas_ms:.1f} ms together; launches "
          f"{blas_launches}; each within 1e-5 of its plain version")
    del a, b, c, hv, xv, A2, B2, C2, H2, X2, H3, X3, Hk, Tk, Yv, Yv3, checks

    # ---- 11. the HermitianGenDefEig slice ----
    # n=300 float64, all three pencils: the card against the CPU, w to
    # 1e-10 of max|w| and X column by column up to sign to 1e-10 of
    # max|X|.
    ga, gb = make_gendef_problem(300, dtype=torch.float64, device=dev, seed=2)
    for pencil in ("AXBX", "ABX", "BAX"):
        wg, xg, rg = f64_run(f"GenDefEig {pencil} n=300",
                             lambda: gen_def_eig_step(ga, gb, pencil))
        wc, xc, rc = gen_def_eig_step(ga.cpu(), gb.cpu(), pencil)
        dw = (wg.cpu() - wc).abs().max().item()
        xg = xg.cpu()
        sgn = torch.where((xg * xc).sum(0) < 0, -1.0, 1.0).to(xg.dtype)
        dx = (xg * sgn[None, :] - xc).abs().max().item()
        require(dw <= 1e-10 * wc.abs().max().item()
                and dx <= 1e-10 * xc.abs().max().item() and rg.item() < 100,
                f"GenDefEig n=300 f64 {pencil}: card vs CPU dw {dw}, dX "
                f"{dx}, residual {rg.item()}")
        print(f"GenDefEig n=300 f64 {pencil}: card vs CPU max|dw| {dw:.3e}, "
              f"max|dX| (up to sign) {dx:.3e}; scaled residual card "
              f"{rg.item():.4f}, CPU {rc.item():.4f}")

    ng = 8192
    ga, gb = make_gendef_problem(ng, device=dev)
    os.environ["ELX_PALLAS_POTRF"] = "1"
    try:
        # the stages around HermitianEig, timed once (synchronised host
        # clock): Cholesky of B, the reduction, the back-substitution
        GA = Et.DistMatrix.from_global(ga, grid=Et.Grid(dev))
        GB = Et.DistMatrix.from_global(gb, grid=Et.Grid(dev))
        GL, t_chol = stage(lambda: Et.Cholesky(Et.LOWER, GB))
        GC, t_red = stage(lambda: Et.TwoSidedTrsm(Et.LOWER, Et.NON_UNIT,
                                                  GA, GL))
        _, t_back = stage(lambda: Et.Trsm(Et.LEFT, Et.LOWER, Et.ADJOINT,
                                          Et.NON_UNIT, 1.0, GL, GC))
        print(f"GenDefEig stages n={ng} f32 (fused tail): Cholesky of B "
              f"{t_chol:.1f} ms, TwoSidedTrsm {t_red:.1f} ms, the final Trsm "
              f"{t_back:.1f} ms")
        del GA, GB
        sync()
        k1_reset()
        potrf_block_inv.launches = 0
        potrf_panel_tail.launches = latrd_panel.launches = sb2tr.launches = 0
        k9_reset()
        t0 = time.perf_counter()
        wg, xg, rg = gen_def_eig_step(ga, gb, "AXBX")
        sync()
        gd_ms = (time.perf_counter() - t0) * 1e3
        gd_launches = {"K1": matmul.launches, "K1 cores": k1_counts(),
                       "K3a": potrf_block_inv.launches,
                       "K3b": potrf_panel_tail.launches,
                       "K5": latrd_panel.launches, "K6": sb2tr.launches,
                       "K9": k9_counts()}
    finally:
        os.environ.pop("ELX_PALLAS_POTRF", None)
    resid = rg.item()
    xd = xg.double()
    borth = ((xd.mT @ (gb.double() @ xd) - torch.eye(
        ng, device=dev, dtype=torch.float64)).abs().max()
        / (eps * ng)).item()
    del xd
    require(tuple(xg.shape) == (ng, ng) and bool(torch.isfinite(xg).all())
            and bool(torch.isfinite(wg).all()),
            "GenDefEig slice: non-finite or misshapen output")
    require(resid < 100, f"GenDefEig slice: scaled residual {resid}")
    require(borth < 100, f"GenDefEig slice: B-orthogonality {borth}")
    require(gd_launches["K1"] > 0 and gd_launches["K3b"] > 0
            and gd_launches["K5"] + gd_launches["K6"] > 0,
            f"the GenDefEig path did not launch its kernels: {gd_launches}")
    require(gd_launches["K9"]["transpose"] == 0,
            f"a K9 transpose on the GenDefEig path: {gd_launches}")
    print(f"slice HermitianGenDefEig AXBX + residual Gemms, n={ng} f32 "
          f"(fused tail): {gd_ms:.1f} ms; scaled residual max|AX-BXW|/(eps n"
          f" (max|A| + max|w| max|B|) max|X|) = {resid:.4f}; "
          f"max|X^T B X - I|/(eps n) = {borth:.4f}; launches {gd_launches}")

    # The scaled residual split by stage, in float64 on the card: with
    # Z = L^T X and C the lower triangle of TwoSidedTrsm's output made
    # symmetric (what HermitianEig reads),
    #   AX - BXW = (A - L C L^T) X + L (CZ - ZW) + (L L^T - B) X W,
    # the reduction's, the eigensolver's and the Cholesky's share, each in
    # the units of the scaled residual.
    Ld = GL.data[:ng, :ng].double().tril()
    Cd = GC.data[:ng, :ng].double()
    Cd = Cd.tril() + Cd.tril(-1).mT
    del GL, GC
    ad, bd, xd, wd = ga.double(), gb.double(), xg.double(), wg.double()
    xw = xd * wd[None, :]
    den = (eps * ng * (ad.abs().max() + wd.abs().max() * bd.abs().max())
           * xd.abs().max())

    def share(m):
        return (m.abs().max() / den).item()

    total = share(ad @ xd - bd @ xw)
    from_red = share((ad - Ld @ Cd @ Ld.mT) @ xd)
    zd = Ld.mT @ xd
    R = Cd @ zd - zd * wd[None, :]
    from_eig = share(Ld @ R)
    from_chol = share((Ld @ Ld.mT - bd) @ xw)
    # the eigensolver's share = HermitianEig's own scaled residual on C
    # x how far L's rows grow R's largest entry x the change of units
    wmax, rmax = wd.abs().max(), R.abs().max()
    r_std = (rmax / (eps * ng * wmax)).item()
    grow = (Ld @ R).abs().max().item() / rmax.item()
    units = (wmax / ((ad.abs().max() + wmax * bd.abs().max())
                     * xd.abs().max())).item()
    linf = Ld.abs().sum(1).max().item()
    require(total <= from_red + from_eig + from_chol + 1e-6 * total,
            "GenDefEig residual split: the shares do not bound the total")
    require(r_std < 100, f"GenDefEig: HermitianEig's residual on C {r_std}")
    print(f"GenDefEig n={ng} residual split (float64, units of the scaled "
          f"residual): total {total:.4f} = reduction (A - LCL^T)X "
          f"{from_red:.4f} + eigensolver L(CZ - ZW) {from_eig:.4f} + "
          f"Cholesky (LL^T - B)XW {from_chol:.4f} (at most); eigensolver "
          f"share = max|CZ-ZW|/(eps n max|w|) {r_std:.4f} x "
          f"max|L(CZ-ZW)|/max|CZ-ZW| {grow:.4f} x max|w|/((max|A| + max|w| "
          f"max|B|) max|X|) {units:.4f}; ||L||_inf {linf:.4f}, max|A| "
          f"{ad.abs().max().item():.4f}, max|B| {bd.abs().max().item():.4f},"
          f" max|w| {wmax.item():.4f}, max|X| {xd.abs().max().item():.4f}, "
          f"max|Z| {zd.abs().max().item():.4f}")
    del Ld, Cd, ad, bd, xd, wd, xw, zd, R, den, wmax, rmax
    del ga, gb, wg, xg

    # ---- 12. K9 against its plain versions ----
    # Every entry rounds as its plain version does (one rounding per
    # product and sum, bfloat16 in float32 with one rounding at the end),
    # so the outputs must be equal bit for bit; max|err| is printed. Each
    # entry is checked and timed at every float32 shape the paths give it,
    # in turns against its plain version and against one library call:
    # torch.add(y, x, alpha=a) for axpby with beta = 1, torch.mul,
    # Tensor.fill_ on a preallocated array, x.mT.contiguous(). The residual
    # Gemm of the HPD, LU and least-squares (a) steps accumulates into a
    # 16384 x 256 C (axpby, beta = 1), that of the minimum-norm step (b)
    # into an 8192 x 256 C; (b) fills a 16384 x 256 array and transposes
    # its 8192 x 16384 A; LeastSquares(ADJOINT) of a tall A transposes a
    # 16384 x 8192 one. 16384^2 is the shape of phase 13's level-1 block,
    # which runs every entry. The bf16, f64 and ragged strided cases are
    # checked, not timed.
    def k9_calls(x, y, al, be, rows, cols, dt):
        """(name, kernel, plain, library call) for each K9 entry."""
        buf = torch.empty((rows, cols), dtype=dt, device=dev)
        return (
            ("axpby", lambda: k9.axpby(al, x, be, y),
             lambda: k9.axpby_plain(al, x, be, y),
             (lambda: torch.add(y, x, alpha=al)) if be == 1.0 else
             (lambda: torch.add(be * y, x, alpha=al))),
            ("scale", lambda: k9.scale(al, x), lambda: k9.scale_plain(al, x),
             lambda: torch.mul(x, al)),
            ("hadamard", lambda: k9.hadamard(x, y),
             lambda: k9.hadamard_plain(x, y), lambda: torch.mul(x, y)),
            ("fill", lambda: k9.fill((rows, cols), al, dt, dev),
             lambda: k9.fill_plain((rows, cols), al, dt, dev),
             lambda: buf.fill_(al)),
            ("transpose", lambda: k9.transpose(x),
             lambda: k9.transpose_plain(x),
             lambda: x.mT.contiguous()))

    f32 = torch.float32
    # (label, rows, cols, type, .mT inputs, entries, betas, timed)
    k9_cases = (
        ("16384x256 f32", n, nrhs, f32, False, ("axpby", "fill"), (1.0,),
         True),
        ("8192x256 f32", n // 2, nrhs, f32, False, ("axpby",), (1.0,), True),
        ("8192x16384 f32", n // 2, n, f32, False, ("transpose",), (1.0,),
         True),
        ("16384x8192 f32", n, n // 2, f32, False, ("transpose",), (1.0,),
         True),
        ("16384^2 f32", n, n, f32, False, k9_entries, (1.0, -1.7), True),
        ("8192^2 bf16", n // 2, n // 2, torch.bfloat16, False, k9_entries,
         (-1.7,), False),
        ("4096^2 f64", n // 4, n // 4, torch.float64, False, k9_entries,
         (-1.7,), False),
        ("ragged 1000x777 .mT f32", 1000, 777, f32, True, k9_entries,
         (-1.7,), False))
    # the shape of each entry's row in the kernels line: the solver paths'
    # own where they launch the entry, else the level-1 block's
    k9_row_shape = {"axpby": "16384x256 f32", "fill": "16384x256 f32",
                    "transpose": "8192x16384 f32", "scale": "16384^2 f32",
                    "hadamard": "16384^2 f32"}
    k9_main = {}
    for label, rows, cols, dt, strided, names, betas, timed in k9_cases:
        if strided:
            x = randn(cols, rows, dtype=dt).mT
            y = randn(cols, rows, dtype=dt).mT
        else:
            x, y = randn(rows, cols, dtype=dt), randn(rows, cols, dtype=dt)
        for be in betas:
            for name, kern, plain, lib in k9_calls(x, y, 0.3, be, rows,
                                                   cols, dt):
                if name not in names or (name != "axpby" and be != 1.0
                                         and len(betas) > 1):
                    continue
                out, ref = kern(), plain()
                sync()
                require(out.shape == ref.shape and out.dtype == ref.dtype
                        and out.is_contiguous(),
                        f"K9 {name} {label}: shape/type/layout")
                err = (out.double() - ref.double()).abs().max().item() \
                    if out.numel() else 0.0
                require(torch.equal(out, ref),
                        f"K9 {name} {label}: max|kernel - plain| {err}, "
                        "not equal bit for bit")
                extra = ""
                if timed:
                    ms, plain_ms = time_pair(kern, plain, 10)
                    lib_ms = time_ms(lib, 10)
                    item = x.element_size()
                    n_in, n_out, ops = {"axpby": (2, 1, 3),
                                        "scale": (1, 1, 1),
                                        "hadamard": (2, 1, 1),
                                        "fill": (0, 1, 0),
                                        "transpose": (1, 1, 0)}[name]
                    bound = roofline(ops * rows * cols,
                                     item * (n_in + n_out) * rows * cols)
                    extra = (f"  kernel {ms:.4f} ms ({bound[0] / ms:.1%} of "
                             f"the {bound[1]} bound {bound[0]:.4f} ms)  plain "
                             f"{plain_ms:.4f} ms  library {lib_ms:.4f} ms")
                    if be == 1.0 and k9_row_shape[name] == label:
                        k9_main[name] = (err, ms, plain_ms, lib_ms, bound)
                print(f"K9 {name} {label}"
                      f"{f' beta={be}' if name == 'axpby' else ''}: "
                      f"max_abs_err {err:.3e}, equal bit for bit{extra}")
                del out, ref
        if strided or dt == torch.float64:
            out, ref = k9.transpose(x, True), k9.transpose_plain(x, True)
            sync()
            require(torch.equal(out, ref) and torch.equal(out, x.mT),
                    f"K9 transpose conjugate=True {label}: not x^T")
            print(f"K9 transpose conjugate=True {label} (real input): "
                  f"equal to x^T bit for bit")
        del x, y
    require(set(k9_main) == set(k9_entries),
            f"K9: no timed row for {set(k9_entries) - set(k9_main)}")

    # K9's host cost: 1000 calls of axpby with Python-number scalars at the
    # residual Gemm's 16384 x 256 without a synchronisation (perf_counter
    # around them; one synchronisation after), against torch.add, in turns
    # (K9, torch, torch, K9); the device kernels of one call (a number goes
    # by value: exactly one); and torch.full beside fill, the one call that
    # also returns a fresh array.
    x, y = randn(n, nrhs), randn(n, nrhs)

    def host_us(fn):
        for _ in range(50):
            fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        t1 = time.perf_counter()
        sync()
        return (t1 - t0) * 1e3

    k9_call = lambda: k9.axpby(0.3, x, 1.0, y)  # noqa: E731
    add_call = lambda: torch.add(y, x, alpha=0.3)  # noqa: E731
    h1, a1, a2, h2 = (host_us(k9_call), host_us(add_call),
                      host_us(add_call), host_us(k9_call))
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            k9_call()
        sync()
    # the profiler may miss the first launches of a window, never add any:
    # every kernel it saw must be K9's and at most one a call
    kern = [ev.name for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    require(0 < len(kern) <= 10 and all("ew_flat_kernel" in k for k in kern),
            f"K9 axpby with Python-number scalars, 10 calls: device kernels "
            f"{kern}")
    full_ms = time_ms(lambda: torch.full((n, nrhs), 0.3, device=dev), 10)
    print(f"K9 host cost at {n}x{nrhs}: axpby {(h1 + h2) / 2:.2f} us a call, "
          f"torch.add {(a1 + a2) / 2:.2f} us (1000 calls unsynchronised, in "
          f"turns); {len(kern)} device kernels seen for 10 calls, every "
          f"one K9's; torch.full "
          f"{full_ms:.4f} ms beside fill's row")
    del x, y

    # ---- the LU step's profile (phase 6's problem) ----
    # One warm LU step under torch.profiler: K4's share of the device time
    # (its group kernels, the used-row reset and its rank-32 updates, the
    # pipeline GEMM instance tagged 4) and the idle share. It runs after
    # phase 12, whose profiler window must see K9's launches alone.
    a, b = make_lu_problem(n, nrhs, dtype=torch.float32, device=dev)
    linear_solve_step(a, b)
    wall, by_name, count = device_profile(lambda: linear_solve_step(a, b))
    busy = sum(by_name.values())
    k4_names = ("group_cluster", "group_kernel", "u12_kernel",
                "init_used_kernel", "gemm<true, false, 4>")
    k4_dev = {k: v for k, v in by_name.items()
              if any(t in k for t in k4_names)}
    k4_ms = sum(k4_dev.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"LU step profile n={n} f32: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms (idle {100 * (1 - busy / wall):.1f}%), {count} "
          f"device kernels; K4 {k4_ms:.1f} ms ({100 * k4_ms / wall:.1f}% of "
          f"the wall, {100 * k4_ms / max(busy, 1e-9):.1f}% of the busy "
          f"time: "
          + ", ".join(f"{k[:60]} {v:.1f}" for k, v in k4_dev.items())
          + "); top: " + "; ".join(f"{k[:50]} {v:.1f} ms" for k, v in top))
    del a, b

    # ---- 13. the least-squares slice ----
    # (d) first: each public function of lapack/qr.py, lq.py, gqr.py and
    # euclidean_min.py at about n=300 in float64 on the card against the
    # same call on the CPU (every wrapper on its plain version there): every
    # output within 1e-10 of its largest entry (float64 products summed in
    # another order; LAPACK's geqrf signs on both sides), ColPivQR's pivots
    # equal.
    def f64(m_, n_, seed):
        gg = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn((m_, n_), generator=gg, device=dev,
                           dtype=torch.float64)

    tall, wide = f64(320, 300, 11), f64(280, 300, 12)
    rhs_t, rhs_w = f64(320, 4, 13), f64(280, 4, 14)
    sq, con, con_r = f64(300, 300, 15), f64(40, 300, 16), f64(40, 4, 17)
    gm_b = f64(320, 320, 18)
    Lq = Et.lapack
    public = {
        "QR": lambda D: Lq.QR(D(tall)),
        "ApplyQ": lambda D: Lq.ApplyQ(True, Lq.QR(D(tall)), D(rhs_t)),
        "ExplicitQR": lambda D: Lq.ExplicitQR(D(tall)),
        "ExplicitQR full": lambda D: Lq.ExplicitQR(D(wide), thin=False),
        "CholeskyQR": lambda D: Lq.CholeskyQR(D(tall)),
        "TSQR": lambda D: Lq.TSQR(D(tall)),
        "ColPivQR": lambda D: Lq.ColPivQR(D(tall)),
        "LQ": lambda D: Lq.LQ(D(wide)),
        "ExplicitLQ": lambda D: Lq.ExplicitLQ(D(wide)),
        "ExplicitRQ": lambda D: Lq.ExplicitRQ(D(wide)),
        "GQR": lambda D: Lq.GQR(D(tall), D(gm_b)),
        "GRQ": lambda D: Lq.GRQ(D(wide), D(sq)),
        "LeastSquares over": lambda D: Lq.LeastSquares(Et.NORMAL, D(tall),
                                                       D(rhs_t)),
        "LeastSquares under": lambda D: Lq.LeastSquares(Et.NORMAL, D(wide),
                                                        D(rhs_w)),
        "LeastSquares adjoint": lambda D: Lq.LeastSquares(
            Et.ADJOINT, D(wide.mT.contiguous()), D(rhs_w)),
        "Ridge": lambda D: Lq.Ridge(Et.NORMAL, D(tall), D(rhs_t), 0.7),
        "Tikhonov": lambda D: Lq.Tikhonov(Et.NORMAL, D(tall), D(rhs_t),
                                          D(sq)),
        "LSE": lambda D: Lq.LSE(D(tall), D(con), D(rhs_t), D(con_r)),
        "GLM": lambda D: Lq.GLM(D(tall[:, :40]), D(gm_b), D(rhs_t)),
    }

    def tensors(out):
        if isinstance(out, Et.DistMatrix):
            return [out.data]
        if isinstance(out, torch.Tensor):
            return [out]
        if hasattr(out, "perm"):
            return [out.perm]
        return [t for o in out for t in tensors(o)]

    card_grid, cpu_grid = Et.Grid(dev), Et.Grid("cpu")
    worst = 0.0
    for name, fn in public.items():
        got = tensors(fn(lambda t: Et.DistMatrix.from_global(
            t, grid=card_grid)))
        want = tensors(fn(lambda t: Et.DistMatrix.from_global(
            t.cpu(), grid=cpu_grid)))
        require(len(got) == len(want), f"{name} n~300 f64: outputs differ")
        for g_, w_ in zip(got, want):
            g_ = g_.cpu()
            require(g_.shape == w_.shape,
                    f"{name} n~300 f64: shapes {tuple(g_.shape)} "
                    f"{tuple(w_.shape)}")
            if not w_.is_floating_point():
                require(torch.equal(g_, w_), f"{name} n~300: pivots differ")
                continue
            scale_ = max(w_.abs().max().item(), 1e-300)
            rel = (g_ - w_).abs().max().item() / scale_
            require(rel <= 1e-10, f"{name} n~300 f64: card and CPU differ "
                                  f"by {rel} of max|out|")
            worst = max(worst, rel)
    print(f"least-squares family n~300 f64 ({len(public)} calls: "
          f"{', '.join(public)}): card vs CPU within {worst:.3e} of max|out|")
    del tall, wide, rhs_t, rhs_w, sq, con, con_r, gm_b

    def backward_error(a_, x_, b_):
        """||B - A X||_inf / (eps n ||A||_inf ||X||_inf) in float64, n the
        width of A."""
        ad, xd, bd = a_.double(), x_.double(), b_.double()
        r_ = bd - ad @ xd
        return (r_.abs().sum(1).max() / (eps * a_.shape[1]
                                         * ad.abs().sum(1).max()
                                         * xd.abs().sum(1).max())).item()

    def counted(fn):
        """Run fn once with every launch count and panel count at 0;
        (output, wall ms, counts)."""
        sync()
        k1_reset()
        k9_reset()
        qr.cholqr_panels.update(fast=0, slow=0, short=0)
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        return out, ms, {"K1": matmul.launches, "K1 cores": k1_counts(),
                         "K9": k9_counts(),
                         "cholqr": dict(qr.cholqr_panels)}

    ls_runs = {}
    for label, m13, n13 in (("(a) QR", n, n),
                             ("(b) minimum norm", n // 2, n)):
        a, b = make_ls_problem(m13, n13, nrhs, device=dev)
        (x, nrm), first_ms, lc = counted(lambda: least_squares_step(a, b))
        _, again_ms, _ = counted(lambda: least_squares_step(a, b))
        ls_runs[label] = lc
        x = x[:n13]
        require(tuple(x.shape) == (n13, nrhs) and bool(torch.isfinite(x).all())
                and bool(torch.isfinite(nrm)),
                f"LS {label}: non-finite or misshapen X")
        berr = backward_error(a, x, b)
        require(berr < 100, f"LS {label}: scaled backward error {berr}")
        require(lc["K1"] > 0 and lc["K9"]["axpby"] > 0
                and lc["cholqr"]["fast"] > 0,
                f"LS {label}: the path did not take its kernels: {lc}")
        extra = ""
        if m13 < n13:
            require(lc["K9"]["transpose"] >= 1 and lc["K9"]["fill"] >= 1,
                    f"LS {label}: K9 launches {lc['K9']}")
            ad = a.double()
            xref = ad.mT @ torch.linalg.solve(ad @ ad.mT, b.double())
            mn = ((x.double() - xref).norm() / x.double().norm()).item()
            require(mn < 1e-3, f"LS {label}: ||X - A^H (A A^H)^-1 B|| / ||X||"
                               f" = {mn}")
            extra = f"; minimum norm ||X - A^H(AA^H)^-1 B||/||X|| {mn:.3e}"
            del ad, xref
        torch.linalg.lstsq(a, b)
        _, lstsq_ms = stage(lambda: torch.linalg.lstsq(a, b))
        print(f"slice least_squares_step {label}, m={m13} n={n13} "
              f"nrhs={nrhs} f32: {first_ms:.1f} ms (first run), "
              f"{again_ms:.1f} ms (second run); scaled backward error "
              f"||B-AX||_inf/(eps n ||A||_inf ||X||_inf) = {berr:.4e}{extra}; "
              f"||R||_F = {nrm.item():.4e}; launches {lc}; "
              f"torch.linalg.lstsq (context) {lstsq_ms:.1f} ms")
        if m13 == n13:
            wall, by_name, count = device_profile(
                lambda: least_squares_step(a, b))
            busy = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
            print(f"LS step profile {label}, n={n13} f32: wall {wall:.1f} ms,"
                  f" device busy {busy:.1f} ms (idle "
                  f"{100 * (1 - busy / wall):.1f}%), {count} device kernels; "
                  + "; ".join(f"{k[:40]} {v:.1f} ms ({100 * v / wall:.1f}%)"
                              for k, v in top))
        del a, b, x

    nq = 8192
    a = randn(nq, nq)
    A13 = Et.DistMatrix.from_global(a, grid=Et.Grid(dev))
    (Q13, R13), first_ms, lc = counted(lambda: Et.ExplicitQR(A13))
    _, again_ms, _ = counted(lambda: Et.ExplicitQR(A13))
    ls_runs["(c) ExplicitQR"] = lc
    qd, rd = Q13.data.double(), R13.data.double()
    orth = ((qd.mT @ qd - torch.eye(nq, device=dev, dtype=torch.float64))
            .abs().max() / (eps * nq)).item()
    recon = ((a.double() - qd @ rd).abs().max()
             / (eps * nq * a.abs().max())).item()
    require(orth < 100 and recon < 100,
            f"ExplicitQR n={nq}: orthogonality {orth}, reconstruction {recon}")
    require(lc["K1"] > 0 and lc["cholqr"]["fast"] > 0,
            f"ExplicitQR n={nq}: launches {lc}")
    print(f"slice ExplicitQR n={nq} f32: {first_ms:.1f} ms (first run), "
          f"{again_ms:.1f} ms (second run); max|Q^TQ-I|/(eps n) = "
          f"{orth:.4f}; max|A-QR|/(eps n max|A|) = {recon:.4f}; launches {lc}")
    del a, A13, Q13, R13, qd, rd

    # the public level-1 operations that run on K9, at 16384^2 float32,
    # each against its plain version (bit for bit)
    g1 = Et.Grid(dev)
    xa, ya = randn(n, n), randn(n, n)
    X1 = Et.DistMatrix.from_global(xa, grid=g1)
    Y1 = Et.DistMatrix.from_global(ya, grid=g1)
    l1_calls = (
        ("Scale", lambda: Et.Scale(0.3, X1), lambda: k9.scale_plain(0.3, xa)),
        ("SafeScale", lambda: Et.SafeScale(3.0, 4.0, X1),
         lambda: k9.scale_plain(3.0, k9.scale_plain(0.25, xa))),
        ("Axpy", lambda: Et.Axpy(0.3, X1, Y1),
         lambda: k9.axpby_plain(0.3, xa, 1.0, ya)),
        ("Axpby", lambda: Et.Axpby(0.3, X1, -1.7, Y1),
         lambda: k9.axpby_plain(0.3, xa, -1.7, ya)),
        ("Add", lambda: Et.Add(X1, Y1), lambda: xa + ya),
        ("Subtract", lambda: Et.Subtract(X1, Y1), lambda: xa - ya),
        ("Hadamard", lambda: Et.Hadamard(X1, Y1), lambda: xa * ya),
        ("Zero", lambda: Et.Zero(X1), lambda: torch.zeros_like(xa)),
        ("Fill", lambda: Et.Fill(X1, 2.5), lambda: torch.full_like(xa, 2.5)),
        ("Transpose", lambda: Et.Transpose(X1), lambda: xa.mT.contiguous()),
        ("Adjoint", lambda: Et.Adjoint(X1), lambda: xa.mT.contiguous()))
    sync()
    k9_reset()
    t0 = time.perf_counter()
    outs = [call() for _, call, _ in l1_calls]
    sync()
    l1_ms = (time.perf_counter() - t0) * 1e3
    l1_launches = k9_counts()
    require(l1_launches == {"axpby": 4, "scale": 3, "hadamard": 1, "fill": 2,
                            "transpose": 2},
            f"level-1 K9 launches {l1_launches}")
    for (name, _, ref), out in zip(l1_calls, outs):
        require(torch.equal(out.data, ref()),
                f"level-1 {name} at {n}^2: not its plain result")
    print(f"level 1 ({', '.join(c[0] for c in l1_calls)}) at {n}^2 f32: "
          f"{l1_ms:.1f} ms together; K9 launches {l1_launches}; each equal "
          f"to its plain result bit for bit")
    del xa, ya, X1, Y1, outs
    # ---- 14. the distributed GEMM slice on virtual grids ----
    # Every position of these grids lies on cuda:0: a virtual grid, the
    # counterpart of the JAX package's virtual CPU mesh. The copies between
    # positions stay inside the card's HBM, so no time here says anything
    # of NVLink or of K8 across cards.
    print("phase 14: grids of several positions, every one on cuda:0 (a "
          "virtual grid); these times are on one card: the copies between "
          "positions stay inside its HBM and say nothing of NVLink")
    g22 = Et.Grid([dev] * 4, height=2)
    g42 = Et.Grid([dev] * 8, height=4)

    def ring_blocks(a_, b_, grid_):
        """A and B as [VC,*] blocks on ``grid_``: K8's operands."""
        return tuple([x.contiguous() for x in Et.Copy(
            Et.DistMatrix.from_global(t_, grid=grid_), Et.VC, Et.STAR).blocks]
            for t_ in (a_, b_))

    def blocks_err(out, ref):
        """(max|out - ref|, max|ref|) over lists of blocks, in float64."""
        return (max((o.double() - r.double()).abs().max().item()
                    for o, r in zip(out, ref)),
                max(r.double().abs().max().item() for r in ref))

    # K8 at the full width: M = K = N = 16384 on the 2x2 grid (p = 4, kb =
    # 4096), against its plain version on the same [VC,*] blocks.
    # Tolerance: max|C - C_plain| <= rtol * max|C_plain|. float32: both sum
    # 16384 FP32 terms, the kernel one after the other and cuBLAS in
    # blocks, so 2e-5 (the sequential sum's rounding error grows with K;
    # phase 2's 1e-5 is for K up to 7680); bfloat16 output: the two f32
    # accumulators may round to neighbouring bf16 values, 2^-7 relative
    # to the largest entry, so 1e-2. Timed with CUDA events in turns
    # against the plain version, and against the library yardstick: one
    # torch.matmul(A_r, B gathered) for each rank r.
    def k8_counts():
        return {core: getattr(ring_summa_kernel, f"launches_{core}")
                for core in K8_CORES}

    nk = 16384
    k8_main, k8_entry = {}, {}
    for dt, rtol, core, peak in ((torch.float32, 2e-5, "fma_async", PEAK_FP32),
                                 (torch.bfloat16, 1e-2, "wgmma", PEAK_BF16)):
        a_, b_ = randn(nk, nk, dtype=dt), randn(nk, nk, dtype=dt)
        # the DistMatrix entry a user calls, on the 2x2 grid: one launch,
        # on the core route() gives this type
        k8_reset()
        C8 = ring_summa(Et.DistMatrix.from_global(a_, grid=g22),
                        Et.DistMatrix.from_global(b_, grid=g22))
        sync()
        k8_entry[core] = k8_counts()
        require(k8_entry[core][core] == 1 and ring_summa_kernel.launches == 1,
                f"K8 ring_summa {dt}: launches {k8_entry[core]}, not one on "
                f"{core}")
        del C8
        av, bv = ring_blocks(a_, b_, g22)
        del a_, b_
        require(k8_route(av, bv) == core,
                f"K8 {dt}: route {k8_route(av, bv)}, not {core}")
        err, scale = blocks_err(ring_summa_kernel(av, bv),
                                ring_summa_plain(av, bv))
        require(err <= rtol * scale,
                f"K8 {nk}^3 {dt}: max_abs_err {err} > {rtol} * {scale}")
        ms, plain_ms = time_pair(lambda: ring_summa_kernel(av, bv),
                                 lambda: ring_summa_plain(av, bv), 2)
        b_all = torch.cat(bv)
        lib_ms = time_ms(lambda: [torch.matmul(x, b_all) for x in av], 2)
        bound = roofline(2 * nk ** 3, av[0].element_size() * 3 * nk * nk,
                         peak)
        print(f"K8 ring SUMMA {nk}^3 {str(dt)[6:]} on the 2x2 grid (p=4, "
              f"kb={nk // 4}) on {core}: max_abs_err {err:.3e} (tol {rtol} x "
              f"{scale:.3e})  kernel {ms:.4f} ms "
              f"({2 * nk ** 3 / ms / 1e9:.2f} TFLOP/s, {bound[0] / ms:.1%} of "
              f"the {bound[1]} bound {bound[0]:.4f} ms)  plain "
              f"{plain_ms:.4f} ms  library {lib_ms:.4f} ms (kernel / library "
              f"{ms / lib_ms:.3f}); ring_summa entry launches "
              f"{k8_entry[core]}")
        k8_main[core] = (err, ms, plain_ms, lib_ms, bound)
        del av, bv, b_all
    # ragged, float64, on the 4x2 grid (p = 8): float64 sums, 1e-12
    av, bv = ring_blocks(randn(1000, 777, dtype=torch.float64),
                         randn(777, 1001, dtype=torch.float64), g42)
    err, scale = blocks_err(ring_summa_kernel(av, bv),
                            ring_summa_plain(av, bv))
    require(err <= 1e-12 * scale,
            f"K8 ragged 1000x777x1001 f64 4x2: {err} > 1e-12 * {scale}")
    print(f"K8 ring SUMMA ragged (1000x777)x(777x1001) f64 on the 4x2 grid "
          f"(blocks {tuple(av[0].shape)} x {tuple(bv[0].shape)}): "
          f"max_abs_err {err:.3e} (tol 1e-12 x {scale:.3e})")
    del av, bv

    # The slice: dist_gemm_step at n = 16384, float32, on the 2x2 grid.
    # x solves a x = b (through the HPD solve), so R = B - A X would be
    # rounding noise; x is moved off the solution by a standard normal
    # step, so that R is of the size of B and each product of the chain
    # (SUMMA_A's (16384x16384)(16384x4), SUMMA_B's and SUMMA_C's skinny
    # K1 products) shows in R3. R3's blocks are held entry by entry
    # against a float64 chain in plain torch on the card (B - A X, A R,
    # A R2, cut into the same blocks): within 1e-5 of max|R3| (FP32 sums
    # over 16384 terms; a dropped k-panel moves R3 by a quarter of it).
    # ||R3|| and ||A G|| against the same step on a 1 x 1 grid: within
    # 1e-5 (FP32 sums in another order).
    nd = 16384
    a, b, x, gm = make_dist_problem(nd, g22, torch.float32, seed=0)
    x = x + randn(*x.shape)
    ref_r3, ref_cr, _ = dist_gemm_step(a, b, x, gm, Et.Grid(dev))
    sync()
    k1_reset()
    k8_reset()
    k9_reset()
    collectives.reset()
    t0 = time.perf_counter()
    nr3, ncr, r3_blocks = dist_gemm_step(a, b, x, gm, g22)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    dist_launches = {"K1": matmul.launches, "K1 cores": k1_counts(),
                     "K8": ring_summa_kernel.launches, "K8 cores": k8_counts(),
                     "K9": k9_counts()}
    dist_moved = dict(collectives.moved)
    t0 = time.perf_counter()
    dist_gemm_step(a, b, x, gm, g22)
    sync()
    again_ms = (time.perf_counter() - t0) * 1e3
    require(len(r3_blocks) == 4 and all(
        tuple(t_.shape) == (nd // 2, 2) and bool(torch.isfinite(t_).all())
        for t_ in r3_blocks), "dist step: R3's blocks misshapen or not finite")
    a64 = a.double()
    r64 = b.double() - a64 @ x.double()
    r64 = a64 @ (a64 @ r64)
    del a64
    r3_err, r3_scale = blocks_err(
        r3_blocks, Et.DistMatrix.from_global(r64, grid=g22).blocks)
    del r64
    require(r3_err <= 1e-5 * r3_scale,
            f"dist step: R3 against the float64 chain: max_abs_err {r3_err} "
            f"> 1e-5 * {r3_scale}")
    r3_rel = abs(nr3.item() - ref_r3.item()) / ref_r3.item()
    require(r3_rel <= 1e-5,
            f"dist step: ||R3|| {nr3.item()} on 2x2 against {ref_r3.item()} "
            "on 1 x 1")
    cr_rel = abs(ncr.item() - ref_cr.item()) / ref_cr.item()
    require(cr_rel <= 1e-5, f"dist step: ||A G|| differs by {cr_rel}")
    require(dist_launches["K1"] > 0 and dist_launches["K8"] == 1
            and dist_launches["K8 cores"]["fma_async"] == 1
            and dist_launches["K9"]["axpby"] == 4,
            f"dist step: the path did not launch its kernels: {dist_launches}")
    # the SUMMA products of two and four columns (SUMMA_C's 128 k-panels on
    # each of the four positions, SUMMA_A's and SUMMA_B's one a position)
    # take K1's skinny route, none the FMA core
    require(dist_launches["K1 cores"]["skinny"] >= 512
            and dist_launches["K1 cores"]["fma"] == 0,
            f"dist step: the SUMMA products left the skinny route: "
            f"{dist_launches}")
    wall, by_name, count = device_profile(
        lambda: dist_gemm_step(a, b, x, gm, g22))
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    print(f"slice dist_gemm_step n={nd} nrhs=4 f32 on the 2x2 grid: "
          f"{first_ms:.1f} ms (first run), {again_ms:.1f} ms (second run); "
          f"R3 max_abs_err {r3_err:.3e} against the float64 chain (tol "
          f"1e-5 x {r3_scale:.3e}); ||R3|| {nr3.item():.6e} (1 x 1: rel "
          f"diff {r3_rel:.3e}); ||A G|| {ncr.item():.6e} (1 x 1: rel diff "
          f"{cr_rel:.3e}); launches {dist_launches}; bytes moved "
          f"{sum(dist_moved.values())}: {dist_moved}")
    print(f"dist step profile: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"(idle {100 * (1 - busy / wall):.1f}%), {count} device kernels; "
          + "; ".join(f"{k[:40]} {v:.1f} ms ({100 * v / wall:.1f}%)"
                      for k, v in top))
    del a, b, x, gm, r3_blocks

    # Each explicit algorithm once at n = 16384 f32 on the 2x2 grid,
    # against K1 on the gathered operands, block by block: 2e-5 of
    # max|C| (FP32 sums over 16384 terms in another split).
    a, b = randn(nd, nd), randn(nd, nd)
    A14 = Et.DistMatrix.from_global(a, grid=g22)
    B14 = Et.DistMatrix.from_global(b, grid=g22)
    c_ref = matmul(a, b)
    del a, b

    def gemm(alg):
        return lambda: Et.Gemm(Et.NORMAL, Et.NORMAL, 1.0, A14, B14, alg=alg)

    for name, fn in (("GEMM_SUMMA_A", gemm(Et.GEMM_SUMMA_A)),
                     ("GEMM_SUMMA_B", gemm(Et.GEMM_SUMMA_B)),
                     ("GEMM_SUMMA_C", gemm(Et.GEMM_SUMMA_C)),
                     ("GEMM_SUMMA_DOT", gemm(Et.GEMM_SUMMA_DOT)),
                     ("GEMM_CANNON", gemm(Et.GEMM_CANNON)),
                     ("Gemm3D depth=2", lambda: Et.Gemm3D(A14, B14, depth=2))):
        sync()
        k1_reset()
        collectives.reset()
        t0 = time.perf_counter()
        C14 = fn()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        err, scale = blocks_err(C14.blocks, [
            c_ref[r0:r1, c0:c1] for (r0, r1), (c0, c1) in C14.block_ranges()])
        require(C14.dist == (Et.MC, Et.MR) and err <= 2e-5 * scale,
                f"{name} n={nd}: max_abs_err {err} > 2e-5 * {scale}")
        require(matmul.launches > 0, f"{name}: no K1 launch")
        print(f"{name} n={nd} f32 on the 2x2 grid: {ms:.1f} ms, max_abs_err "
              f"{err:.3e} (tol 2e-5 x {scale:.3e}) against K1 on the gathered "
              f"operands; K1 launches {matmul.launches}; bytes moved "
              f"{collectives.bytes_moved()}")
        del C14
    del A14, B14, c_ref

    # SUMMA_C on 2x3 and 3x2 grids (p = 6), where K//c and K//r are 2t and
    # 3t and a panel must divide their gcd: 3000x2400 times 2400x1800 f32
    # against the float64 product in plain torch, within 1e-5 of max|C|.
    a, b = randn(3000, 2400), randn(2400, 1800)
    c64 = a.double() @ b.double()
    for h in (2, 3):
        g6 = Et.Grid([dev] * 6, height=h)
        C6 = Et.Gemm(Et.NORMAL, Et.NORMAL, 1.0,
                     Et.DistMatrix.from_global(a, grid=g6),
                     Et.DistMatrix.from_global(b, grid=g6),
                     alg=Et.GEMM_SUMMA_C)
        err, scale = blocks_err([C6.replicated()[:3000, :1800]], [c64])
        require(err <= 1e-5 * scale,
                f"GEMM_SUMMA_C on {g6}: max_abs_err {err} > 1e-5 * {scale}")
        print(f"GEMM_SUMMA_C 3000x2400x1800 f32 on {g6}: max_abs_err "
              f"{err:.3e} (tol 1e-5 x {scale:.3e}) against float64")
    del a, b, c64, C6

    # The redistribution sweep: every ordered pair of ALL_DISTS at 1000 x
    # 777 f32 on the 2x2 grid; the target's global array equals the source
    # bit for bit, and each of its blocks is the one the target layout cuts.
    src = randn(1000, 777)
    want = {d: Et.DistMatrix.from_global(src, *d, grid=g22).blocks
            for d in Et.ALL_DISTS}
    for d1 in Et.ALL_DISTS:
        A14 = Et.DistMatrix.from_global(src, *d1, grid=g22)
        for d2 in Et.ALL_DISTS:
            B14 = A14.redistribute(*d2)
            require(torch.equal(B14.replicated()[:1000, :777], src)
                    and all(torch.equal(x_, w_) for x_, w_
                            in zip(B14.blocks, want[d2])),
                    f"redistribution {A14.dist_name()} -> "
                    f"{B14.dist_name()}: not bit for bit")
    print(f"redistributions: all {len(Et.ALL_DISTS) ** 2} ordered pairs of "
          f"the {len(Et.ALL_DISTS)} distributions at 1000x777 f32 on the 2x2 "
          "grid equal the source bit for bit, block by block")
    del src, want, A14, B14

    # A small float64 check: dist_gemm_step at n = 300 on the 2x2 and 4x2
    # grids against the same step on a CPU grid of the same shape (plain
    # versions). x is moved off a's solution so that R is no rounding
    # noise and the entries compare: within 1e-10 of max|R3|.
    for grid_ in (g22, g42):
        a, b, x, gm = make_dist_problem(300, grid_, torch.float64,
                                        seed=5)
        x = x + 1e-3 * randn(*x.shape, dtype=torch.float64)
        card = f64_run(f"dist step n=300 on {grid_}",
                       lambda: dist_gemm_step(a, b, x, gm, grid_))
        cpu_grid_ = Et.Grid(["cpu"] * grid_.size, height=grid_.height)
        host = dist_gemm_step(a.cpu(), b.cpu(), x.cpu(), gm.cpu(), cpu_grid_)
        err, scale = blocks_err([t_.cpu() for t_ in card[2]], host[2])
        norms = max(abs(card[i].item() - host[i].item()) / host[i].item()
                    for i in (0, 1))
        require(err <= 1e-10 * scale and norms <= 1e-10,
                f"dist step n=300 f64 {grid_}: card and CPU differ by {err} "
                f"(of {scale}), norms by {norms}")
        print(f"slice dist_gemm_step n=300 f64 on {grid_}: card vs CPU grid "
              f"max|dR3| {err:.3e} of {scale:.3e}, norms within {norms:.3e}")

    # each entry's launches on every path that reads K9's counts
    k9_paths = ([launches, lu_launches, fused_launches, gd_launches,
                 dist_launches]
                + list(eig_launches.values()) + list(ls_runs.values()))
    k9_launches = {name: sum(r["K9"][name] for r in k9_paths)
                   + l1_launches[name] for name in k9_entries}
    require(all(v > 0 for v in k9_launches.values()),
            f"a K9 entry never launched on the paths: {k9_launches}")

    def row(name, source, replaces, launches, main, lib_ms=None):
        err, ms, plain_ms = main[:3]
        (b_ms, b_by) = main[-1]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}

    # K1's launches by core over every main-path run that reads them (the
    # bf16 ones are the bf16-storage Cholesky's history products), K8's
    # over the dist step and the ring_summa entry. The float64 runs
    # against the CPU are off the main paths: their K1 launches are
    # printed apart and count in no row of the kernels line.
    k1_paths = ([launches, lu_launches, fused_launches, gd_launches,
                 dist_launches] + list(eig_launches.values())
                + list(ls_runs.values()))
    k1_launches = {core: sum(r["K1 cores"][core] for r in k1_paths)
                   + sum(c[core] for c in chol16.values())
                   for core in K1_CORES}
    k1_f64 = {core: sum(r["K1 cores"][core] for r in f64_k1.values())
              for core in K1_CORES}
    k8_launches = {core: dist_launches["K8 cores"][core]
                   + sum(c[core] for c in k8_entry.values())
                   for core in K8_CORES}
    require(k1_launches["wgmma"] > 0 and k1_launches["fma_async"] > 0
            and k1_launches["skinny"] > 0
            and k8_launches["wgmma"] > 0 and k8_launches["fma_async"] > 0,
            f"a K1 or K8 core never launched on the paths: K1 {k1_launches}"
            f", K8 {k8_launches}")
    print(f"K1 launches by core on the main paths: {k1_launches}; K8 "
          f"{k8_launches}")
    print(f"K1 launches by core in the float64 runs against the CPU (off "
          f"the main paths): {k1_f64} "
          f"({', '.join(f'{k}: {v}' for k, v in f64_k1.items())})")
    print(f"K1 launches on the FMA core from phase 4 on, by operands: "
          + ("; ".join(f"{k}: {v}" for k, v in fma_named.items())
             or "none"))
    k1_module._launch = k1_launch

    csrc = "elementalx_torch/kernels/csrc/"
    k1_rows = [
        ("fma_async", "matmul.cu",
         "K1 local GEMM f32 (matmul; FP32 FMA core on the cp.async "
         "pipeline, gemm_f32_pipe.cuh)"),
        ("wgmma", "matmul.cu", "K1 local GEMM bf16 (matmul; tensor-core "
                               "core, gemm_sm90.cuh)"),
        ("skinny", "gemm_skinny.cu",
         "K1 local GEMM, skinny route: f32/f64 C of at most 16 columns "
         "(matmul; A streamed once)"),
        ("fma", "matmul.cu",
         "K1 local GEMM, FMA core for float64 and operands the fast cores "
         "cannot read (matmul; gemm_tile.cuh)"),
    ]
    kernels = [
        row(name, csrc + src, "elementalx/kernels/matmul.py:39",
            k1_launches[core], k1_main[core], k1_main[core][3])
        for core, src, name in k1_rows if k1_launches[core] > 0
    ]
    # A K1 core that the main paths did not launch (the FMA core, where
    # only the float64 runs against the CPU reach it) keeps a row of its
    # own, with its phase 2 time, on a line apart from the kernels line.
    off_path = [
        row(f"{name}: off the main paths; the time of phase 2's "
            f"{k1_case[core]}", csrc + src,
            "elementalx/kernels/matmul.py:39", 0, k1_main[core],
            k1_main[core][3])
        for core, src, name in k1_rows if k1_launches[core] == 0
    ]
    kernels += [
        row("K2 masked rank-k update (masked_rank_k)", csrc + "trrk.cu",
            "elementalx/kernels/trrk.py:45", blas_launches["K2"], k2_main),
        row("K3a Cholesky diagonal block (potrf_block_inv)",
            csrc + "potrf.cu", "elementalx/kernels/potrf.py:263",
            launches["K3a"], k3_main),
        row("K3b fused Cholesky panel tail (potrf_panel_tail)",
            csrc + "potrf_tail.cu", "elementalx/kernels/potrf.py:289",
            fused_launches["K3b"], k3b_main),
        row("K3c full-height fused panel tail (potrf_panel_tail_full)",
            csrc + "potrf_tail.cu", "elementalx/kernels/potrf.py:208",
            k3c_launches, k3c_main),
        row("K4 pivoted LU panel (getrf_panel; cluster route)",
            csrc + "getrf.cu", "elementalx/kernels/getrf.py:210",
            lu_launches["K4 routes"]["cluster"], k4_main, k4_main[3]),
        row("K5 latrd panel (latrd_panel)", csrc + "latrd.cu",
            "elementalx/kernels/latrd.py:224", eig_launches["latrd"]["K5"],
            k5_main),
        row("K6 band to tridiagonal bulge chase (sb2tr; cluster route)",
            csrc + "sb2tr.cu", "elementalx/kernels/sb2tr.py:276",
            eig_launches["sbr"]["K6 routes"]["cluster"], k6_main),
    ] + [
        row(name, csrc + "symv.cu", "elementalx/kernels/symv.py:66",
            blas_launches["K7"][core], k7_main[core], k7_main[core][3])
        for core, name in (
            ("tma", "K7 lower-triangle symv (symv_lower; TMA tiles, "
                    "symv_unit.cuh SymvTiles)"),
            ("unit", "K7 lower-triangle symv (symv_lower; scalar unit for "
                     "rows not 16-byte multiples apart)"))
    ] + [
        row(name, csrc + "ring_summa.cu",
            "elementalx/kernels/ring_summa.py:93", k8_launches[core],
            k8_main[core], k8_main[core][3])
        for core, name in (
            ("fma_async", "K8 ring SUMMA f32 (ring_summa_kernel; FP32 FMA "
                          "core on the cp.async pipeline)"),
            ("wgmma", "K8 ring SUMMA bf16 (ring_summa_kernel; tensor-core "
                      "core)"))
    ] + [
        row(f"K9 {name}", csrc + "elementwise.cu",
            f"elementalx/kernels/elementwise.py:{line}", k9_launches[name],
            k9_main[name], k9_main[name][3])
        for name, line in (("axpby", 56), ("scale", 67), ("hadamard", 78),
                           ("fill", 88), ("transpose", 115))
    ]
    print(json.dumps({"off_path_kernels": off_path}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
