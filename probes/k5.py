"""K5 (latrd panel) on one card: where a column's time goes.

Usage, from the root of the repository, on a machine with an NVIDIA GPU:

    python3 probes/k5.py

It builds ``csrc/latrd.cu`` a second time with ``-DELX_LATRD_PROBE``: the
same kernel, with thread 0 of every block stamping ``clock64()`` after a
block barrier at each phase boundary of every column (the labels come
from the build, ``elx_latrd_probe_labels``). Then, after the card's name
and power limit, for (M, k0, w) = (8192, 0, 128) and (8192, 4096, 128)
float32 (the HermitianEig path's panels at n = 8192):

1. K5 of the kernel library and of the probe's build in turns (CUDA
   events), and whether the two give the same bits;
2. each segment's time a column: the mean over blocks and columns, and
   the mean over columns of the slowest block's (for a phase between two
   grid barriers, the slowest block is the critical path; a barrier's
   segment is the block's wait there, imbalance included); block by
   block, the symv walk and the segment whose slowest block lags its mean
   the most. Cycles are turned into microseconds by the probe build's own
   clock: the stamped span of block 0 over the CUDA-event time of the
   launch;
3. the column's time beside the floor of its algorithm (its trailing
   triangle at 3.35 TB/s);
4. K5's accuracy in float32: the kernel and the plain version (both
   float32) against the plain version in float64 on the same input, and
   against each other, max|difference| over max|reference| for P, W and
   tau, at (1000, 37, 100) and (8192, 0, 128).
"""

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from elementalx_torch.kernels import common  # noqa: E402
from elementalx_torch.kernels import latrd as k5  # noqa: E402

SHAPES = ((8192, 0, 128), (8192, 4096, 128))


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


def build():
    """The probe build of latrd.cu (with common.cu) and nvcc's report."""
    root = common.BUILD_ROOT / "probe_k5"
    root.mkdir(parents=True, exist_ok=True)
    so = root / "libelx_k5_probe.so"
    cmd = [common._nvcc(), *common.NVCC_FLAGS, "-shared", "-DELX_LATRD_PROBE",
           "-o", str(so), str(common.CSRC / "latrd.cu"),
           str(common.CSRC / "common.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"probe build failed:\n{proc.stderr[-4000:]}")
    report = [ln for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(so)), report


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes/k5.py: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    common.kernel_library()
    lib, report = build()
    print("probe build, nvcc -Xptxas -v:\n  " + "\n  ".join(report))
    lib.elx_latrd_probe_labels.restype = ctypes.c_char_p
    labels = lib.elx_latrd_probe_labels().decode().split("|")
    nstamps = lib.elx_latrd_probe_stamps()
    lib.elx_latrd_probe_set.argtypes = (ctypes.c_void_p,)
    # K5's entry, bound to the probe build's function of the same name
    panel = common.Entry(k5.PANEL.name, k5.PANEL.argtypes)
    panel.fn = getattr(lib, panel.name)
    panel.fn.argtypes, panel.fn.restype = panel.argtypes, ctypes.c_int
    grid_fn = lib.elx_latrd_grid
    grid_fn.argtypes = (ctypes.c_int, ctypes.c_void_p)
    grid_fn.restype = ctypes.c_int
    G = ctypes.c_int(0)
    common.check_launch(grid_fn(0, ctypes.byref(G)), "elx_latrd_grid")
    G = G.value
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for M, k0, w in SHAPES:
        x = torch.randn((M, M), generator=gen, device=dev,
                        dtype=torch.float64)
        a = ((x + x.mT) / 2).float()
        del x
        stamps = torch.zeros((G, w, nstamps), dtype=torch.int64, device=dev)
        common.check_launch(lib.elx_latrd_probe_set(stamps.data_ptr()),
                            "elx_latrd_probe_set")

        def lib_call():
            return k5._launch(a, k0, w, 128)

        def probe_call():
            return k5._launch(a, k0, w, 128, panel, G)

        same = all(torch.equal(u, v) for u, v in zip(lib_call(), probe_call()))
        t_lib = [time_ms(lib_call, 3)]
        t_probe = [time_ms(probe_call, 3)]
        t_probe.append(time_ms(probe_call, 3))
        t_lib.append(time_ms(lib_call, 3))
        ms_lib, ms_probe = sum(t_lib) / 2, sum(t_probe) / 2
        stamps.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        probe_call()
        e1.record()
        e1.synchronize()
        one_ms = e0.elapsed_time(e1)
        st = stamps.double().cpu()
        seg = st[:, :, 1:] - st[:, :, :-1]            # (G, w, segments)
        span = (st[0, -1, -1] - st[0, 0, 0]).item()
        per_us = span / (one_ms * 1e3)                # cycles a microsecond
        col_us = (st[:, :, -1] - st[:, :, 0]).mean().item() / per_us
        m0 = M - k0
        tri = sum((m0 - j - 1) * (m0 - j) / 2 for j in range(w)) * 4
        floor_us = tri / 3.35e12 * 1e6 / w
        print(f"\nK5 ({M}, {k0}, {w}) f32, {G} blocks: kernel library "
              f"{ms_lib:.4f} ms, probe build {ms_probe:.4f} ms (in turns); "
              f"same bits: {same}; probe launch {one_ms:.4f} ms, "
              f"{per_us:.1f} cycles/us; a column {col_us:.2f} us against "
              f"{floor_us:.2f} us of its trailing triangle at 3.35 TB/s")
        print(f"  {'segment':40s} {'mean us':>9s} {'slowest us':>11s} "
              f"{'share':>7s}")
        mean = seg.mean(dim=(0, 1)) / per_us
        slow = seg.max(dim=0).values.mean(dim=0) / per_us
        total = mean.sum().item()
        for i, name in enumerate(labels):
            print(f"  {name:40s} {mean[i].item():9.3f} "
                  f"{slow[i].item():11.3f} {mean[i].item() / total:7.1%}")
        # the segment whose slowest block lags its mean the most, block by
        # block (mean over columns)
        # and the symv walk's
        lag = int((slow - mean).argmax())
        for k in sorted({lag} | {i for i, name in enumerate(labels)
                                 if name.startswith("symv walk")}):
            by_block = seg[:, :, k].mean(dim=1) / per_us
            order = by_block.argsort()
            print(f"  {labels[k]} by block (mean us over columns): slowest "
                  + ", ".join(f"#{int(i)} {by_block[i].item():.1f}"
                              for i in order[-8:].flip(0))
                  + "; fastest " + ", ".join(
                      f"#{int(i)} {by_block[i].item():.1f}"
                      for i in order[:8]))
        first = seg[:, 0, :].mean(dim=0) / per_us
        last = seg[:, -1, :].mean(dim=0) / per_us
        print("  first / last column, mean us: " + "; ".join(
            f"{name} {first[i].item():.2f} / {last[i].item():.2f}"
            for i, name in enumerate(labels)))
        del a, stamps

    print()
    for M, k0, w in ((1000, 37, 100), (8192, 0, 128)):
        g = torch.Generator(device=dev).manual_seed(6)
        x = torch.randn((M, M), generator=g, device=dev, dtype=torch.float64)
        a64 = (x + x.mT) / 2
        del x
        a = a64.float()
        out = k5.latrd_panel(a, k0, w, 128)
        plain = k5.latrd_panel_plain(a, k0, w, 128)
        ref = k5.latrd_panel_plain(a.double(), k0, w, 128)

        def rel(u, v):
            return ", ".join(
                f"{name} {((p.double() - q.double()).abs().max() / q.double().abs().max()).item():.2e}"
                for name, p, q in zip(("P", "W", "tau"), u, v))

        print(f"K5 ({M}, {k0}, {w}) float32 against float64 (the plain "
              f"version on the float32 input in float64): kernel {rel(out, ref)}"
              f"; plain {rel(plain, ref)}; kernel against plain "
              f"{rel(out, plain)}")
        del a, a64, out, plain, ref


if __name__ == "__main__":
    main()
