"""The FP64 tensor cores' rate by mma.sync shape on this card, beside K1's
float64 core ("dmma", csrc/gemm_dmma.cuh): what bounds that core.

Usage, from the root of the repository, on a machine with an NVIDIA GPU:

    python3 probes/dmma_rate.py [--variants] [--out DIR]

It builds probes/dmma_rate.cu (a loop of independent mma.sync f64 on
registers, no memory traffic) with nvcc into DIR (by default
elementalx_torch/kernels/_build/probe_dmma/, which .gitignore lists) and
prints, after the card's name and power limit:

1. TFLOP/s of each shape (m8n8k4, m16n8k4, m16n8k8, m16n8k16) with 8,
   16 and 32 warps an SM;
2. the SASS instruction mix of the "dmma" core's main loop (the longest
   backward branch of gemm<K-major A, N-major B, 128>) and nvcc's report
   (registers, spills) of each of its instances;
3. the "dmma" core, the FMA core and torch.matmul in turns at 2048^3,
   the history shape (8192 x 7680)(7680 x 512) and the ragged (1000 x
   777)(777 x 1001), float64, with the TFLOP/s;
4. variants of the "dmma" core built on their own from
   probes/dmma_variant.cu and its copy of the core with build knobs,
   probes/dmma_variant.cuh (``--variants``: ELX_DMMA_BK, the k of a
   stage, ELX_DMMA_STAGES, ELX_DMMA_SWAP, and the diagnostics
   ELX_DMMA_PROBE, which leave out the copies or the mma and so give
   wrong results), each in turns with the library's build at 2048^3 and
   the history shape, with whether the two give the same bits.

The main loop's SASS goes to DIR/dmma_main_loop.sass.
"""

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from elementalx_torch.kernels import common  # noqa: E402
from elementalx_torch.kernels.matmul import _launch as k1  # noqa: E402

sys.path.insert(0, HERE)
from k1_cores import in_turns, loop_mix, time_ms  # noqa: E402

SHAPES = ("m8n8k4", "m16n8k4", "m16n8k8", "m16n8k16")
VARIANTS = {
    "row-major A and B as they come (no C^T = B^T A^T)": (
        "-DELX_DMMA_SWAP=0",),
    "BK 16, 4 stages": ("-DELX_DMMA_BK=16", "-DELX_DMMA_STAGES=4"),
    # diagnostics, wrong results: what the loop costs without its copies
    # (shared reads and mma alone) and without its mma
    "no copies after the first stages": ("-DELX_DMMA_PROBE=1",),
    "no mma": ("-DELX_DMMA_PROBE=2",),
}


def build_variants(out_dir):
    """Each variant of probes/dmma_variant.cu, all nvcc processes started
    together: {name: ctypes function}."""
    procs = {}
    for name, defs in VARIANTS.items():
        so = os.path.join(out_dir, f"libdmma_{len(procs)}.so")
        cmd = [common._nvcc(), *common.NVCC_FLAGS, "-shared", *defs,
               "-I", str(common.CSRC), "-o", so,
               os.path.join(HERE, "dmma_variant.cu")]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        regs = re.findall(r"Used (\d+) registers", out)
        print(f"variant {name}: nvcc rc {proc.returncode}, registers {regs}")
        if proc.returncode:
            print(out[-3000:])
            continue
        fn = ctypes.CDLL(so).dmma_variant
        fn.argtypes = ((ctypes.c_int,) * 3 + (ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int) * 2
                       + (ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p))
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def variant_launch(fn, a, b):
    """C = A B (row-major float64 A and B) on a variant's build."""
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=torch.float64, device=a.device)
    rc = fn(M, N, K, a.data_ptr(), a.stride(0), a.stride(1), 0,
            b.data_ptr(), b.stride(0), b.stride(1), 1, c.data_ptr(),
            c.stride(0), c.stride(1), 0,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc:
        raise RuntimeError(f"dmma_variant: CUDA error {rc}")
    return c


def main():
    if not torch.cuda.is_available():
        raise SystemExit("dmma_rate: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    out_dir = str(common.BUILD_ROOT / "probe_dmma")
    if "--out" in sys.argv:
        out_dir = sys.argv[sys.argv.index("--out") + 1]
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libdmma_rate.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so,
                    os.path.join(HERE, "dmma_rate.cu")], check=True)
    lib = ctypes.CDLL(so)
    lib.dmma_rate.argtypes = (ctypes.c_int,) * 4 + (ctypes.c_void_p,) * 2
    lib.dmma_rate.restype = ctypes.c_double
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    for shape, name in enumerate(SHAPES):
        row = []
        for warps in (8, 16, 32):
            blocks, threads, iters = sms * warps // 8, 256, 4096
            out = torch.empty(blocks * threads, dtype=torch.float64,
                              device=dev)
            flop = lib.dmma_rate(shape, blocks, threads, iters, None, stream)
            ms = time_ms(lambda: lib.dmma_rate(shape, blocks, threads, iters,
                                               out.data_ptr(), stream), 5)
            row.append(f"{warps} warps/SM {flop / ms / 1e9:.2f}")
        print(f"mma.sync {name} f64: " + ", ".join(row) + " TFLOP/s")

    lib_path = common.library_path()
    common.kernel_library()
    log = (lib_path.parent / "build.log").read_text().splitlines()
    for i, line in enumerate(log):
        m = re.search(r"Compiling entry function '(\S*dmma\S*)'", line)
        if m:
            rep = " ".join(x.split(":", 1)[-1].strip()
                           for x in log[i + 1:i + 4] if "ptxas" in x)
            print(f"{m.group(1)}: {rep}")
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    n, ops = loop_mix(sass, r"dmma.*gemmILb1ELb0ELi128ELi2E",
                      os.path.join(out_dir, "dmma_main_loop.sass"))
    print(f"dmma core main loop (A K-major, B N-major, 128 x 128): {n} SASS "
          f"instructions, DMMA {ops['DMMA']}; {dict(ops.most_common(10))}")

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float64)

    for M, K, N in ((2048, 2048, 2048), (8192, 7680, 512),
                    (1000, 777, 1001)):
        a, b = randn(M, K), randn(K, N)
        dm, fm = in_turns(lambda: k1("dmma", a, b, torch.float64),
                          lambda: k1("fma", a, b, torch.float64), 10)
        lib_ms = time_ms(lambda: torch.matmul(a, b), 10)
        tf = 2 * M * N * K / 1e9
        print(f"K1 f64 ({M}x{K})x({K}x{N}): dmma {dm:.4f} ms "
              f"({tf / dm:.2f} TFLOP/s), FMA core {fm:.4f} ms, torch.matmul "
              f"{lib_ms:.4f} ms ({tf / lib_ms:.2f} TFLOP/s)")

    if "--variants" not in sys.argv:
        return
    for name, fn in build_variants(out_dir).items():
        for M, K, N in ((2048, 2048, 2048), (8192, 7680, 512)):
            a, b = randn(M, K), randn(K, N)
            same = torch.equal(variant_launch(fn, a, b),
                               k1("dmma", a, b, torch.float64))
            lib_ms, var_ms = in_turns(
                lambda: k1("dmma", a, b, torch.float64),
                lambda: variant_launch(fn, a, b), 10)
            tf = 2 * M * N * K / 1e9
            print(f"variant {name} ({M}x{K})x({K}x{N}): {var_ms:.4f} ms "
                  f"({tf / var_ms:.2f} TFLOP/s) against the library's "
                  f"{lib_ms:.4f} ms, in turns; the same bits: {same}")


if __name__ == "__main__":
    main()
