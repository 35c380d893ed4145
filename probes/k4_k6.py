"""K4 (pivoted LU panel) and K6 (bulge chase) on one card: the
synchronisation steps they are built from, and their design variants in
turns.

Usage, from the root of the repository, on a machine with an NVIDIA GPU:

    python3 probes/k4_k6.py

It prints, after the card's name and power limit:

1. nvcc's report (``-Xptxas -v``: registers, stack, spills, shared
   memory) for K4's and K6's kernels of the built library;
2. the microseconds of one synchronisation step (kernels/sync_probe.py):
   a grid.sync() over 132 and 16 CTAs (K4's grid route, one a column), a
   cluster barrier over 1 to 16 CTAs (K4's cluster route, one a column;
   K6, three an op) and a cluster barrier followed by a dependent DSMEM
   read (the round trip after each of K4's barriers);
3. K4 at (16384, 512) float32: the grid route (the first design) and the
   cluster route in turns (grid, cluster, cluster, grid; CUDA events),
   the cluster route at 8 and 16 CTAs in turns at (8192, 512), and the
   cluster route at the LU path's panel heights (Mt = 16384 down to 512)
   beside its chain floor (512 columns x one barrier and DSMEM read at
   the panel's cluster size);
4. K6 at n=8192, b=256 and b=128 float32: the l2 route (the first
   design) and the cluster route in turns, the cluster route at other
   cluster sizes in turns with the default, and the cluster route rebuilt
   with the first design's lag of three ops (ELX_SB2TR_LAG=3) in turns
   with the lag of two; each held to the spectrum of the band.
"""

import ctypes
import importlib
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from elementalx_torch.kernels import common  # noqa: E402
from elementalx_torch.lapack.sbr import chase_smax  # noqa: E402

k4 = importlib.import_module("elementalx_torch.kernels.getrf")
k6 = importlib.import_module("elementalx_torch.kernels.sb2tr")
sp = importlib.import_module("elementalx_torch.kernels.sync_probe")


def time_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def in_turns(a, b, iters):
    """(a ms, b ms) timed a, b, b, a."""
    a1, b1, b2, a2 = (time_ms(a, iters), time_ms(b, iters),
                      time_ms(b, iters), time_ms(a, iters))
    return (a1 + a2) / 2, (b1 + b2) / 2


def build_lag3():
    """csrc/sb2tr.cu with common.cu, built with ELX_SB2TR_LAG=3."""
    root = common.BUILD_ROOT / "probe_k4_k6"
    root.mkdir(parents=True, exist_ok=True)
    so = root / "lib_sb2tr_lag3.so"
    cmd = [common._nvcc(), *common.NVCC_FLAGS, "-shared",
           "-DELX_SB2TR_LAG=3", "-o", str(so), str(common.CSRC / "sb2tr.cu"),
           str(common.CSRC / "common.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc failed:\n{out.stdout[-3000:]}"
                         f"{out.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    fn = lib.elx_sb2tr
    fn.argtypes = (ctypes.c_int,) * 6 + (ctypes.c_void_p,) * 4
    fn.restype = ctypes.c_int
    return fn


def chase_with(fn, ab, b):
    """(vout, d, e) of the cluster route through another build's entry."""
    n = ab.shape[0]
    smax = chase_smax(n, b)
    work = ab.clone()
    vout = torch.zeros((n, smax, b), dtype=ab.dtype, device=ab.device)
    flags = torch.zeros((2 * n + 1,), dtype=torch.int32, device=ab.device)
    rc = fn(1, k6.cluster_size(b, ab.dtype), 0, n, b, smax, work.data_ptr(),
            vout.data_ptr(), flags.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    common.check_launch(rc, "elx_sb2tr (lag 3)")
    return vout, torch.diagonal(work).clone(), torch.diagonal(work, -1).clone()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes/k4_k6.py needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    common.kernel_library()
    lag3 = build_lag3()
    dev = torch.device("cuda", 0)

    # ---- 1. nvcc's report
    log = (common.library_path().parent / "build.log").read_text()
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m and any(k in m.group(1) for k in (
                "chase_cluster", "chase_l2", "group_cluster", "group_kernel",
                "u12_kernel")):
            report = " | ".join(x.split("info    :")[-1].strip()
                                for x in lines[i + 1:i + 4]
                                if "ptxas info" in x)
            print(f"ptxas {m.group(1)}: {report}")

    # ---- 2. synchronisation steps
    steps = {c: (sp.step_us("cluster barrier", c),
                 sp.step_us("cluster barrier + DSMEM read", c))
             for c in (1, 2, 4, 8, 16)}
    for ctas in (132, 16):
        print(f"grid.sync over {ctas} CTAs: "
              f"{sp.step_us('grid.sync', ctas):.3f} us")
    for c, (bar, rt) in steps.items():
        print(f"cluster of {c}: barrier {bar:.3f} us, barrier + DSMEM read "
              f"{rt:.3f} us")

    # ---- 3. K4
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((16384, 512), generator=gen, device=dev)
    g_ms, c_ms = in_turns(lambda: k4._launch("grid", a),
                          lambda: k4._launch("cluster", a), 5)
    print(f"K4 (16384, 512) f32: grid route {g_ms:.4f} ms, cluster route "
          f"(16 CTAs) {c_ms:.4f} ms")
    # (16384 rows fit in 16 CTAs only; at 8192 rows 8 and 16 both fit)
    half = a[:8192].contiguous()
    ref = k4._launch("cluster", half, 8)
    out = k4._launch("cluster", half, 16)
    same = all(torch.equal(x, y) for x, y in zip(out, ref))
    t8, t16 = in_turns(lambda: k4._launch("cluster", half, 8),
                       lambda: k4._launch("cluster", half, 16), 5)
    print(f"K4 (8192, 512): cluster of 8 {t8:.4f} ms, of 16 {t16:.4f} ms; "
          f"same bits {same}")
    for Mt in range(16384, 0, -2048):
        Mt = max(Mt, 512)
        sub = a[:Mt].contiguous()
        c = k4.cluster_ctas(Mt, sub.dtype)
        ms = time_ms(lambda: k4._launch("cluster", sub), 5)
        floor = 512 * steps[c][1] / 1e3
        print(f"K4 ({Mt}, 512): cluster of {c}, {ms:.4f} ms, chain floor "
              f"{floor:.4f} ms (512 x {steps[c][1]:.3f} us)")
    del a, sub, half

    # ---- 4. K6
    for b in (256, 128):
        n = 8192
        x = torch.randn((n, n), generator=gen, device=dev,
                        dtype=torch.float64)
        i = torch.arange(n, device=dev)
        ab = torch.where((i[:, None] - i[None, :]).abs() <= b, (x + x.mT) / 2,
                         torch.zeros((), dtype=torch.float64, device=dev))
        ev = torch.linalg.eigvalsh(ab)
        ab = ab.float()
        bound = 100 * n * torch.finfo(torch.float32).eps * ev.abs().max()

        def spec_err(out):
            _, d, e = out
            T = torch.diag(d.double()) + torch.diag(e.double(), -1) \
                + torch.diag(e.double(), 1)
            return (torch.linalg.eigvalsh(T) - ev).abs().max().item()

        c0 = k6.cluster_size(b, ab.dtype)
        l2_ms, cl_ms = in_turns(lambda: k6._launch("l2", ab, b),
                                lambda: k6._launch("cluster", ab, b), 1)
        print(f"K6 n={n} b={b} f32: l2 route {l2_ms:.1f} ms, cluster route "
              f"({c0} CTAs) {cl_ms:.1f} ms; spectrum error "
              f"{spec_err(k6._launch('cluster', ab, b)):.3e} (bound "
              f"{bound:.3e})")
        for c in sorted({max(c0 // 2, 1), min(c0 * 2, 16)} - {c0}):
            t0, tc = in_turns(lambda: k6._launch("cluster", ab, b),
                              lambda c=c: k6._launch("cluster", ab, b, c), 1)
            print(f"K6 b={b} cluster of {c}: {tc:.1f} ms against {c0}: "
                  f"{t0:.1f} ms; spectrum error "
                  f"{spec_err(k6._launch('cluster', ab, b, c)):.3e}")
        t2, t3 = in_turns(lambda: k6._launch("cluster", ab, b),
                          lambda: chase_with(lag3, ab, b), 1)
        print(f"K6 b={b}: lag 2 {t2:.1f} ms, lag 3 {t3:.1f} ms "
              f"(critical path {k6.chain_ops(n, b, 2)} and "
              f"{k6.chain_ops(n, b, 3)} ops); lag 3 spectrum error "
              f"{spec_err(chase_with(lag3, ab, b)):.3e}")
        del x, ab


if __name__ == "__main__":
    main()
