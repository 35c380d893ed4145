"""K1's and K8's cores side by side on one card: what holds the FMA core,
and each core's time at the main paths' shapes, in turns.

Usage, from the root of the repository, on a machine with an NVIDIA GPU:

    python probes/k1_cores.py

It prints, after the card's name and power limit:

1. the SASS instruction mix of the main loop (the longest backward
   branch) of K1's float32 FMA core (``gemm_kernel<float>``,
   gemm_tile.cuh) and of its cp.async pipeline (``matmul_pipe``,
   gemm_f32_pipe.cuh), from ``cuobjdump -sass`` of the built library,
   with the registers nvcc gave each (``-Xptxas -v``): an FFMA share of
   the loop's instruction slots below one bounds the FP32 rate by that
   share;
2. float32 K1 at the Cholesky history shape (8192 x 7680)(7680 x 512)
   and the L21 shape (15872 x 512)(512 x 512), and K8 at 16384^3 on a 2x2
   virtual grid: the FMA core against the pipeline in turns (FMA,
   pipeline, pipeline, FMA; CUDA events), with whether the two agree bit
   for bit, and torch.matmul;
3. bfloat16 K1 at the history shape (B a .mH view, float32 out): the FMA
   core against the tensor cores in turns, and torch.matmul.

Each core is launched through the wrappers' ``_launch``, the same C
entries that ``route`` picks from.
"""

import os
import re
import subprocess
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import elementalx_torch as Et  # noqa: E402
from elementalx_torch.core.redistribute import Copy  # noqa: E402
from elementalx_torch.core.types import STAR, VC  # noqa: E402
from elementalx_torch.kernels import common  # noqa: E402
from elementalx_torch.kernels.matmul import _launch as k1  # noqa: E402
from elementalx_torch.kernels.ring_summa import _launch as k8  # noqa: E402


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
    """(a, b) mean times, run a, b, b, a."""
    a1, b1, b2, a2 = (time_ms(a, iters), time_ms(b, iters),
                      time_ms(b, iters), time_ms(a, iters))
    return (a1 + a2) / 2, (b1 + b2) / 2


def loop_mix(sass: str, pattern: str, dump: str = ""):
    """(instructions, Counter of opcodes) of the longest backward-branch
    loop of the first function whose name matches ``pattern`` (its text
    written to the file ``dump`` when one is named)."""
    for body in re.split(r"\n\s+Function : ", sass):
        name = body.split("\n", 1)[0]
        if not re.search(pattern, name):
            continue
        ins = [(int(a, 16), i) for a, i in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", body)]
        best = []
        for addr, text in ins:
            m = re.search(r"BRA .*?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                lo = int(m.group(1), 16)
                loop = [t for a, t in ins if lo <= a <= addr]
                best = max(best, loop, key=len)
        ops = Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
                      for t in best)
        if dump:
            with open(dump, "w") as f:
                f.write("\n".join(best) + "\n")
        return len(best), ops
    return 0, Counter()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k1_cores: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    lib = common.library_path()
    common.kernel_library()
    log = (lib.parent / "build.log").read_text().splitlines()
    regs = {}
    for i, line in enumerate(log):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m and "matmul_cu" in m.group(1):
            for later in log[i:i + 6]:
                if "Used" in later:
                    regs[m.group(1)] = later.split("Used")[1].split(",")[0]
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    for label, pattern in (("FMA core gemm_kernel<float>",
                            r"matmul_cu.*gemm_kernelIfffE"),
                           ("pipeline matmul_pipe<K-major, K-major>",
                            r"matmul_pipeILb1ELb1E")):
        n, ops = loop_mix(sass, pattern)
        reg = next((r for k, r in regs.items() if re.search(pattern, k)), "?")
        print(f"{label}: main loop {n} SASS instructions, FFMA {ops['FFMA']} "
              f"({100 * ops['FFMA'] / max(n, 1):.1f}% of the instruction slots); "
              f"{reg.strip()}; {dict(ops.most_common(8))}")

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dt=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    buf = randn(16384, 16384)
    cases = (("history", buf[8192:, :7680], buf[8192:8704, :7680].mH),
             ("L21", randn(15872, 512), randn(512, 512)))
    for name, a, b in cases:
        same = torch.equal(k1("fma", a, b, torch.float32),
                           k1("fma_async", a, b, torch.float32))
        fma, pipe = in_turns(lambda: k1("fma", a, b, torch.float32),
                             lambda: k1("fma_async", a, b, torch.float32), 20)
        lib_ms = time_ms(lambda: torch.matmul(a, b), 20)
        print(f"K1 f32 {name} {tuple(a.shape)} x {tuple(b.shape)}: FMA core "
              f"{fma:.4f} ms, pipeline {pipe:.4f} ms, torch.matmul "
              f"{lib_ms:.4f} ms; bit for bit {same}")
    del buf, cases

    grid = Et.Grid([dev] * 4, height=2)
    blocks = [[x.contiguous() for x in Copy(Et.DistMatrix.from_global(
        randn(16384, 16384), grid=grid), VC, STAR).blocks] for _ in range(2)]
    same = all(torch.equal(x, y) for x, y in zip(k8("fma", *blocks),
                                                 k8("fma_async", *blocks)))
    fma, pipe = in_turns(lambda: k8("fma", *blocks),
                         lambda: k8("fma_async", *blocks), 2)
    print(f"K8 f32 16384^3 on the 2x2 grid: FMA core {fma:.4f} ms, pipeline "
          f"{pipe:.4f} ms; bit for bit {same}")
    del blocks

    buf = randn(16384, 16384, dt=torch.bfloat16)
    a, b = buf[8192:, :7680], buf[8192:8704, :7680].mH
    fma, tc = in_turns(lambda: k1("fma", a, b, torch.float32),
                       lambda: k1("wgmma", a, b, torch.float32), 20)
    lib_ms = time_ms(lambda: torch.matmul(a, b), 20)
    print(f"K1 bf16 history into f32: FMA core {fma:.4f} ms, tensor cores "
          f"{tc:.4f} ms, torch.matmul (bf16 out) {lib_ms:.4f} ms")


if __name__ == "__main__":
    main()
