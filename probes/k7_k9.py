"""K7 (lower-triangle symv), K5 (latrd panel) and K9 (level 1) on one card:
what holds each, at the main paths' shapes.

Usage, from the root of the repository, on a machine with an NVIDIA GPU:

    python3 probes/k7_k9.py

It prints, after the card's name and power limit:

1. nvcc's report (``-Xptxas -v``: registers, stack, spills, shared
   memory) for the K5, K7 and K9 kernels of the built library;
2. K7 at n=16384 float32: the "unit" and "tma" cores in turns (unit,
   tma, tma, unit; CUDA events) with their GB/s of the lower triangle
   (n^2/2 words), against torch.mv on the full symmetric matrix; then
   the "tma" core rebuilt with other ring sizes (ELX_SYMV_RING, bytes a
   block) and blocks per SM (ELX_SYMV_BLOCKS_PER_SM), each variant in
   turns with torch.mv and held against the plain version;
3. K5 at (M, k0, w) = (8192, 0, 128) float32 against its bound, the
   trailing triangle read once per column;
4. K9: the host's time per call (1000 calls without a synchronisation,
   perf_counter around them, then one synchronisation) of axpby with
   Python-number scalars at 16384 x 256 against torch.add, then each
   step of such a call alone (20000 calls each), the device kernels of
   one call (torch.profiler), and the device time (CUDA events) of axpby
   and fill at 16384 x 256 and of scale and hadamard at 16384^2 against
   torch.add, fill_ and torch.mul; then scale and hadamard at 16384^2
   rebuilt with 1, 2, 4 and 8 16-byte vectors a thread (ELX_EW_UNROLL),
   each in turns with torch.mul.
"""

import ctypes
import os
import re
import struct
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from elementalx_torch.kernels import common  # noqa: E402
from elementalx_torch.kernels import elementwise as k9  # noqa: E402
from elementalx_torch.kernels.latrd import latrd_panel  # noqa: E402
from elementalx_torch.kernels.symv import _launch as k7  # noqa: E402
from elementalx_torch.kernels.symv import symv_lower_plain  # noqa: E402

K7_VARIANTS = ((65536, 1), (65536, 2), (65536, 3), (98304, 2))
K9_VARIANTS = (1, 2, 4, 8)


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


def build_variants():
    """Compile csrc/symv.cu once for each K7 variant (ELX_SYMV_RING,
    ELX_SYMV_BLOCKS_PER_SM) and csrc/elementwise.cu once for each K9
    variant (ELX_EW_UNROLL: 16-byte vectors a thread), each with
    common.cu, all nvcc processes started together."""
    root = common.BUILD_ROOT / "probe_k7_k9"
    root.mkdir(parents=True, exist_ok=True)
    jobs = [(("K7",) + v, "symv.cu",
             ("-DELX_SYMV_RING=%d" % v[0],
              "-DELX_SYMV_BLOCKS_PER_SM=%d" % v[1]))
            for v in K7_VARIANTS]
    jobs += [(("K9", v), "elementwise.cu", ("-DELX_EW_UNROLL=%d" % v,))
             for v in K9_VARIANTS]
    procs = {}
    for key, src, defs in jobs:
        so = root / ("lib_" + "_".join(map(str, key)) + ".so")
        cmd = [common._nvcc(), *common.NVCC_FLAGS, "-shared", *defs, "-o",
               str(so), str(common.CSRC / src), str(common.CSRC / "common.cu")]
        procs[key] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            print(f"variant {key}: nvcc failed\n{out[-3000:]}")
            continue
        libs[key] = ctypes.CDLL(str(so))
    return libs


def variant_call(lib, A, v, y, ws, G):
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.elx_symv_lower_tma
    fn.argtypes = (I, I, P, I, L, P, P, P, I, P)
    fn.restype = I
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(0, A.shape[0], A.data_ptr(), 0, A.stride(0), v.data_ptr(),
            y.data_ptr(), ws.data_ptr(), G, stream)
    if rc:
        raise RuntimeError(f"elx_symv_lower_tma: CUDA error {rc}")


def host_parts(x, y):
    """The host's time of each step of a K9 axpby call at x's shape, and of
    the whole call, each repeated 20000 times (no synchronisation; the
    kernel launches of the whole call queue behind one another)."""
    def per_call(fn, reps=20000):
        for _ in range(100):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return t

    m, n = y.shape
    dev, dt = y.device, y.dtype
    out = torch.empty_like(y)
    parts = {
        "torch.empty((m, n), dtype=, device=)":
            lambda: torch.empty((m, n), dtype=dt, device=dev),
        "torch.empty_like(y)": lambda: torch.empty_like(y),
        "_check": lambda: k9._check("axpby", x, y),
        "_scalar (a Python float)": lambda: k9._scalar(0.3, y),
        "x.stride(); y.stride()": lambda: (x.stride(), y.stride()),
        "3 data_ptr()": lambda: (x.data_ptr(), y.data_ptr(),
                                 out.data_ptr()),
        "launch of an empty call (pack, ctypes, stream, device)":
            lambda: common.launch(k9._EW, y, 0, 0, 0, 0, 0, 0, 0, 0.3, 0, 0,
                                  0, 0, 1.0, 0, 0, 0, 0),
        "the whole axpby": lambda: k9.axpby(0.3, x, 1.0, y),
        "torch.add(y, x, alpha=0.3)": lambda: torch.add(y, x, alpha=0.3),
        "the whole fill": lambda: k9.fill((m, n), 0.3, dt, dev),
        "buf.fill_(0.3)": lambda: out.fill_(0.3),
        "torch.full((m, n), 0.3)": lambda: torch.full((m, n), 0.3,
                                                      dtype=dt, device=dev),
    }
    for name, fn in parts.items():
        print(f"host {name}: {per_call(fn):.2f} us")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes/k7_k9.py: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    common.kernel_library()
    log = (common.library_path().parent / "build.log").read_text()
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m and re.search(r"symv|latrd|ew_flat_kernelIfLi0", m.group(1)):
            info = [x.strip() for x in lines[i + 1:i + 3]]
            print(m.group(1)[-60:], "|", " | ".join(info))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 16384
    A = torch.randn((n, n), generator=gen, device=dev)
    v = torch.randn((n,), generator=gen, device=dev)
    H = torch.tril(A) + torch.tril(A, -1).mT
    ref = symv_lower_plain(A, v)
    scale = ref.abs().max().item()
    gbs = 2 * n * n / 1e6  # bytes of the triangle / 1e9, per ms
    unit, tma = in_turns(lambda: k7("unit", A, v), lambda: k7("tma", A, v),
                         20)
    mv = time_ms(lambda: torch.mv(H, v), 20)
    print(f"K7 n={n} f32: unit {unit:.4f} ms ({gbs / unit:.1f} GB/s), tma "
          f"{tma:.4f} ms ({gbs / tma:.1f} GB/s); torch.mv on the full "
          f"matrix {mv:.4f} ms; bound {n * n * 2 / 3.35e9:.4f} ms (the "
          f"triangle's bytes)")

    libs = build_variants()
    y = torch.empty_like(v)
    ws = torch.empty((4 * 132 * n,), device=dev)
    for key, lib in libs.items():
        if key[0] != "K7":
            continue
        ring, blocks = key[1:]
        G = ctypes.c_int(0)
        lib.elx_symv_tma_grid.argtypes = (ctypes.c_int, ctypes.c_void_p)
        if lib.elx_symv_tma_grid(0, ctypes.byref(G)):
            print(f"variant {(ring, blocks)}: no grid")
            continue
        G = G.value
        variant_call(lib, A, v, y, ws, G)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        t_mv, t_var = in_turns(lambda: torch.mv(H, v),
                               lambda: variant_call(lib, A, v, y, ws, G), 20)
        print(f"K7 variant ring={ring} blocks/SM={blocks} (G={G}): "
              f"{t_var:.4f} ms ({gbs / t_var:.1f} GB/s) against torch.mv "
              f"{t_mv:.4f} ms; max|y - plain| {err:.3e} of {scale:.3e}")
    del A, H, ws

    M, k0, w = 8192, 0, 128
    x = torch.randn((M, M), generator=gen, device=dev, dtype=torch.float64)
    a = ((x + x.mT) / 2).float()
    del x
    ms = time_ms(lambda: latrd_panel(a, k0, w, 128), 3)
    m0 = M - k0
    nbytes = 4 * (sum((m0 - j - 1) * (m0 - j) / 2 for j in range(w))
                  + 2 * m0 * w)
    print(f"K5 ({M}, {k0}, {w}) f32: {ms:.4f} ms; bound {nbytes / 3.35e9:.4f}"
          f" ms ({nbytes / 1e9:.2f} GB: the trailing triangle once a "
          f"column)")
    del a

    rows, cols = 16384, 256
    x = torch.randn((rows, cols), generator=gen, device=dev)
    yv = torch.randn((rows, cols), generator=gen, device=dev)
    for name, fn in (("K9 axpby", lambda: k9.axpby(0.3, x, 1.0, yv)),
                     ("torch.add", lambda: torch.add(yv, x, alpha=0.3)),
                     ("K9 axpby", lambda: k9.axpby(0.3, x, 1.0, yv)),
                     ("torch.add", lambda: torch.add(yv, x, alpha=0.3))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        print(f"{name} {rows}x{cols}: host {(t1 - t0) * 1e3:.2f} us a call "
              f"(1000 calls unsynchronised)")
    host_parts(x, yv)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        k9.axpby(0.3, x, 1.0, yv)
        torch.cuda.synchronize()
    kern = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"K9 axpby with Python-number scalars: {len(kern)} device "
          f"kernel(s) a call: {kern}")
    buf = torch.empty((rows, cols), device=dev)
    for name, kern_fn, lib_fn in (
            ("axpby", lambda: k9.axpby(0.3, x, 1.0, yv),
             lambda: torch.add(yv, x, alpha=0.3)),
            ("fill", lambda: k9.fill((rows, cols), 0.3, torch.float32, dev),
             lambda: buf.fill_(0.3))):
        lib_ms, ms = in_turns(lib_fn, kern_fn, 50)
        print(f"K9 {name} {rows}x{cols}: {ms:.4f} ms against {lib_ms:.4f}")
    del x, yv, buf
    x = torch.randn((n, n), generator=gen, device=dev)
    yv = torch.randn((n, n), generator=gen, device=dev)
    for name, kern_fn, lib_fn in (
            ("scale", lambda: k9.scale(0.3, x), lambda: torch.mul(x, 0.3)),
            ("hadamard", lambda: k9.hadamard(x, yv),
             lambda: torch.mul(x, yv))):
        lib_ms, ms = in_turns(lib_fn, kern_fn, 10)
        print(f"K9 {name} {n}^2: {ms:.4f} ms against torch.mul {lib_ms:.4f}")
    pack = struct.Struct("<6qQdQ2qQdQ2q2Q").pack
    out = torch.empty_like(x)
    for key, lib in libs.items():
        if key[0] != "K9":
            continue
        fn = lib.elx_ew
        fn.argtypes = (ctypes.c_char_p,)
        fn.restype = ctypes.c_int

        def call(op, fn=fn):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(pack(op, 0, n, n, 0, 0, 0, 0.3, x.data_ptr(), n, 1, 0,
                         1.0, yv.data_ptr(), n, 1, out.data_ptr(), stream))
            if rc:
                raise RuntimeError(f"elx_ew: CUDA error {rc}")
        for op, name, lib_fn in ((1, "scale", lambda: torch.mul(x, 0.3)),
                                 (2, "hadamard", lambda: torch.mul(x, yv))):
            lib_ms, ms = in_turns(lib_fn, lambda: call(op), 10)
            ok = torch.equal(out, k9.scale(0.3, x) if op == 1
                             else k9.hadamard(x, yv))
            print(f"K9 variant unroll={key[1]} {name} {n}^2:"
                  f" {ms:.4f} ms against torch.mul {lib_ms:.4f} (equal to "
                  f"the wrapper's: {ok})")


if __name__ == "__main__":
    main()
