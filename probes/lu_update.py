"""LU's trailing update three ways, on one NVIDIA GPU, at the update
shapes of ``LinearSolve`` at n = 16384 in float32 (nb = 1024): slabs
k = 0, 7 and 14 by default.

After slab k the Mt = M - k0 rows in ``tail`` hold the slab's factor
``lu`` (Mt x nb, in ``tail`` order: the nb elected rows, then the rows not
yet elected, ascending), and U12 (nb x Nt, Nt = N - k0 - nb) is known.
The update takes the product of ``lu[nb:]`` and U12 off the trailing
columns of the rows not yet elected:

- ``full``: the full-height update of the JAX package's layout: an
  (M, nb) zero L with ``lu[nb:]`` scattered into the rows not yet
  elected, one (M, nb) x (nb, Nt) K1 product, and ``right -= P`` over
  all M rows;
- ``A`` (scatter-add): one (Mt - nb, nb) x (nb, Nt) K1 product, then
  ``right.index_add_(0, tail[nb:], P, alpha=-1)``;
- ``B`` (a compact trailing buffer): the trailing columns of the Mt rows
  kept in ``tail`` order in a buffer T; the rows not yet elected are
  gathered into a new buffer (``T[rest, nb:]``), and that buffer less P
  in place.

Each is timed by CUDA events around ``--reps`` calls, in turns (full, A,
B, B, A, full) ``--rounds`` times, after a warm call; the product alone
(full height and tail rows) and each variant's other passes are timed
the same way. Before timing, each variant's result is compared with the
full-height one: A's rows and B's buffer, bit for bit and as the largest
difference.

Prints one JSON line a slab, the card's name and power limit first.

Usage, from the root of the repository, on a machine with the card:
``python3 probes/lu_update.py [--n 16384] [--nb 1024] [--slabs 0 7 14]``
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from elementalx_torch.blas.gemm import local_gemm  # noqa: E402


def _event_ms(fn, reps: int) -> float:
    """Device ms a call: CUDA events around ``reps`` calls."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def _slab(n: int, nb: int, k: int, gen: torch.Generator, dev):
    """The state after slab k's factorization: the matrix ``a`` (n x n)
    and its trailing columns ``right``; ``tail0``, the Mt rows not elected
    before slab k; ``lp``, the slab's row order (its nb elected positions
    first, the others ascending), so that ``tail = tail0[lp]``; the
    slab's factor ``lu`` in that order, and U12."""
    k0 = k * nb
    Mt = n - k0
    a = torch.randn((n, n), generator=gen, device=dev) / 32
    right = a[:, k0 + nb:]
    tail0 = torch.randperm(n, generator=gen, device=dev)[:Mt]
    lp = torch.randperm(Mt, generator=gen, device=dev)
    lp = torch.cat([lp[:nb], torch.sort(lp[nb:]).values])
    lu = torch.randn((Mt, nb), generator=gen, device=dev) / 32
    u12 = torch.randn((nb, Mt - nb), generator=gen, device=dev) / 32
    return a, right, tail0, lp, lu, u12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--nb", type=int, default=1024)
    ap.add_argument("--slabs", type=int, nargs="+", default=[0, 7, 14])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip(), "torch": torch.__version__}),
          flush=True)
    dev = torch.device("cuda", 0)
    n, nb = args.n, args.nb
    gen = torch.Generator(device=dev).manual_seed(22)
    for k in args.slabs:
        a, right, tail0, lp, lu, u12 = _slab(n, nb, k, gen, dev)
        tail = tail0[lp]
        rest, L = tail[nb:], lu[nb:]
        # B's buffer: the trailing columns of the slab's Mt rows (the
        # panel's nb columns and the Nt to their right) in the order of
        # tail before the slab
        T = a[tail0, k * nb:]

        def full():
            lphys = a.new_zeros((n, nb))
            lphys[rest] = L
            right.sub_(local_gemm(lphys, u12))

        def scatter_add():
            right.index_add_(0, rest, local_gemm(L, u12), alpha=-1)

        def compact():
            t = torch.index_select(T[:, nb:], 0, lp[nb:])  # T[rest, nb:]
            t.sub_(local_gemm(L, u12))
            return t

        # each variant against the full-height update, from one state
        r0 = right.clone()
        full()
        want = right[rest].clone()
        right.copy_(r0)
        scatter_add()
        got_a = right[rest]
        got_b = compact()
        check = {
            "A_equal_bits": bool(torch.equal(got_a, want)),
            "A_max_diff": float((got_a - want).abs().max()),
            "B_equal_bits": bool(torch.equal(got_b, want)),
            "B_max_diff": float((got_b - want).abs().max()),
            "elected_rows_untouched": bool(torch.equal(
                right[tail[:nb]], r0[tail[:nb]])),
        }
        del r0, want, got_a, got_b

        p_full = torch.empty((n, nb), device=dev)
        p_tail = torch.empty((L.shape[0], u12.shape[1]), device=dev)
        p_height = torch.empty((n, u12.shape[1]), device=dev)
        t_b = torch.empty_like(p_tail)
        parts = {
            "full": full,
            "A": scatter_add,
            "B": compact,
            "K1_full_height": lambda: local_gemm(p_full, u12),
            "K1_tail_rows": lambda: local_gemm(L, u12),
            "sub_full_height": lambda: right.sub_(p_height),
            "index_add_tail": lambda: right.index_add_(0, rest, p_tail,
                                                       alpha=-1),
            "gather_B": lambda: torch.index_select(T[:, nb:], 0, lp[nb:]),
            "sub_B": lambda: t_b.sub_(p_tail),
        }
        times = {name: [] for name in parts}
        for fn in parts.values():
            fn()
        torch.cuda.synchronize()
        order = ["full", "A", "B", "B", "A", "full"]
        for _ in range(args.rounds):
            for name in order:
                times[name].append(_event_ms(parts[name], args.reps))
            for name in list(parts)[3:]:
                times[name].append(_event_ms(parts[name], args.reps))
        Mt, Nt = n - k * nb, n - k * nb - nb
        print(json.dumps({
            "slab": k, "M": n, "Mt": Mt, "rows_updated": Mt - nb,
            "Nt": Nt, "nb": nb,
            "gflop_full": 2 * n * nb * Nt / 1e9,
            "gflop_tail": 2 * (Mt - nb) * nb * Nt / 1e9,
            "ms_median": {name: statistics.median(v)
                          for name, v in times.items()},
            "ms_all": times, **check}), flush=True)
        del a, right, tail0, lp, tail, rest, L, lu, u12, T
        del p_full, p_tail, p_height, t_b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
