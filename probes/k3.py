"""K3a and K3b on their routes, in turns, on one card.

Usage, from the root of the repository, on a machine with an NVIDIA GPU:

    python3 probes/k3.py

Prints the card's name and power limit, nvcc's report (registers, shared
memory, spills) for the cluster kernel, then, float32, blocks of
g g^T / w + 2 I:

- K3a at w = 200, 512, 2048 on every route that takes the width (the
  cluster route up to 512, the blocked route) and its plain version,
  timed in turns (A B C C B A, CUDA events), beside cholesky_ex +
  solve_triangular and the chain floor (two cluster barriers a 32-wide
  step, ``kernels/sync_probe.py``);
- K3b at (16384, 512) and (8192, 2048) likewise;
- the HPD step at n = 16384 (``entry()``), default and fused tail, best of
  three warm runs on the host clock;
- where one cluster launch spends its time: the kernel's %globaltimer
  stamps (``elx_potrf_stamps``) at every phase boundary of every step of
  every factor CTA and at each column block of the apply's first strip
  (whichever CTA takes it), for K3a at w = 512 and K3b at (16384, 512),
  as the mean over steps of each phase's slowest CTA.

About a minute with the build.
"""

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from elementalx_torch.entry import entry  # noqa: E402
from elementalx_torch.kernels import common  # noqa: E402
from elementalx_torch.kernels import potrf as k3  # noqa: E402
from elementalx_torch.kernels.sync_probe import step_us  # noqa: E402


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


def in_turns(fns, iters):
    names = list(fns)
    out = dict.fromkeys(names, 0.0)
    for k in names + names[::-1]:
        out[k] += time_ms(fns[k], iters) / 2
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("probes/k3.py needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    common.kernel_library()
    lines = (common.library_path().parent / "build.log").read_text()
    lines = lines.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "chol_kernel" in line:
            print("\n".join(x.strip() for x in lines[i:i + 4]))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bar = {}

    def floor(w):
        total = 0.0
        for b0 in range(0, w, 512):
            nt = -(-min(512, w - b0) // 32)
            if nt not in bar:
                bar[nt] = step_us("cluster barrier", nt)
            total += 2 * nt * bar[nt]
        return total / 1e3

    def block(w):
        g = torch.randn((w, w), generator=gen, device=dev, dtype=torch.float64)
        return (g @ g.mT / w + 2 * torch.eye(w, device=dev,
                                            dtype=torch.float64)).float()

    for w in (200, 512, 2048):
        s = block(w)
        routes = [r for r in k3.ROUTES if r != "cluster" or w <= 512]
        fns = {r: (lambda r=r: k3._launch(r, s)) for r in routes}
        fns["plain"] = lambda: k3.potrf_block_inv_plain(s)
        ms = in_turns(fns, 20)

        def pair():
            lo, _ = torch.linalg.cholesky_ex(s)
            return torch.linalg.solve_triangular(
                lo, torch.eye(w, device=dev), upper=False)

        print(f"K3a w={w}: " + ", ".join(f"{r} {ms[r]:.4f} ms" for r in ms)
              + f"; cholesky_ex + solve_triangular {time_ms(pair, 20):.4f} "
              f"ms; chain floor {floor(w):.4f} ms", flush=True)
    for Mt, w in ((16384, 512), (8192, 2048)):
        s = block(w)
        pan = torch.randn((Mt, w), generator=gen, device=dev)
        routes = [r for r in k3.TAIL_ROUTES if r != "cluster" or w <= 512]
        fns = {r: (lambda r=r: k3._tail_launch(r, s, pan, 0, False))
               for r in routes}
        fns["plain"] = lambda: k3.potrf_panel_tail_plain(s, pan)
        ms = in_turns(fns, 10)
        print(f"K3b ({Mt}, {w}): "
              + ", ".join(f"{r} {ms[r]:.4f} ms" for r in ms)
              + f"; chain floor {floor(w):.4f} ms", flush=True)
    for label in ("default", "fused tail"):
        if label == "fused tail":
            os.environ["ELX_PALLAS_POTRF"] = "1"
        step, (a, b) = entry(n=16384, nrhs=256, dtype=torch.float32,
                             device=dev)
        best = float("inf")
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(a, b)
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        print(f"HPD n=16384 nrhs=256 f32 ({label}): best warm step "
              f"{best:.1f} ms", flush=True)
        del a, b
    os.environ.pop("ELX_PALLAS_POTRF", None)
    phases(block, gen, dev)


def phases(block, gen, dev):
    """One stamped launch each of K3a (w = 512) and K3b ((16384, 512)) on
    the cluster route."""
    import ctypes

    buf = torch.zeros((2200,), dtype=torch.int64, device=dev)
    fn = common.kernel_function("elx_potrf_stamps", (ctypes.c_void_p,))
    s = block(512)
    pan = torch.randn((16384, 512), generator=gen, device=dev)
    for label, run in (("K3a w=512", lambda: k3._launch("cluster", s)),
                       ("K3b (16384, 512)",
                        lambda: k3._tail_launch("cluster", s, pan, 0,
                                                False))):
        run()
        torch.cuda.synchronize()
        common.check_launch(fn(buf.data_ptr()), "elx_potrf_stamps")
        buf.zero_()
        run()
        torch.cuda.synchronize()
        common.check_launch(fn(None), "elx_potrf_stamps")
        st = buf.cpu().tolist()
        nt = 16
        t = [[st[16 + (q * 16 + k) * 8: 24 + (q * 16 + k) * 8]
              for k in range(nt)] for q in range(nt)]
        t0 = min(t[q][0][0] for q in range(nt))
        seg = {"barrier 1 to phase B end": (0, 1), "barrier 2": (1, 2),
               "phase C (stores, updates, look-ahead)": (2, 3),
               "fence": (3, 4)}
        out = []
        for name, (a, b) in seg.items():
            vals = [max(t[q][k][b] - t[q][k][a] for q in range(nt))
                    for k in range(nt - 1)]
            out.append(f"{name} {sum(vals) / len(vals) / 1e3:.2f}")
        # barrier 1's wait: from the last CTA's end of phase C to the
        # first CTA's exit from barrier 1 of the next step
        waits = [min(t[q][k + 1][0] for q in range(nt))
                 - max(t[q][k][4] for q in range(nt)) for k in range(nt - 1)]
        out.append(f"barrier 1 {sum(waits) / len(waits) / 1e3:.2f}")
        diag = [t[p][p][6] - t[p][p][5] for p in range(1, nt)]
        push = [t[p][p][7] - t[p][p][6] for p in range(1, nt)]
        out.append(f"(within phase C of the owner: the warp's factor and "
                   f"inverse {sum(diag) / len(diag) / 1e3:.2f}, the write of "
                   f"X_kk^T {sum(push) / len(push) / 1e3:.2f})")
        end = max(t[q][nt - 1][4] for q in range(nt))
        print(f"{label}: {st[0]} CTAs; factor {(end - t0) / 1e3:.1f} us from "
              f"the first barrier; per step, us (mean over steps of the "
              f"slowest CTA): " + ", ".join(out), flush=True)
        if label.startswith("K3b"):
            ap = [st[2064 + 3 * j: 2067 + 3 * j] for j in range(nt)]
            print("  the apply's first strip, us from the factor's first "
                  "barrier (published, staged, computed) by column block: "
                  + "; ".join(f"{(a - t0) / 1e3:.1f}/{(b - t0) / 1e3:.1f}/"
                              f"{(c - t0) / 1e3:.1f}" for a, b, c in ap),
                  flush=True)


if __name__ == "__main__":
    main()
