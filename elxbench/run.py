"""The benchmark of elementalx_torch: dense solves on an NVIDIA GPU, timed
call by call.

Usage, from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 elxbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of a cell (``workloads/<cell>.json``, see cells.py):

1. set-up: makes the cell's P distinct problems on the card from the seed
   (the configuration's ``reference/<config>.py``), checks whether the
   port writes into the tensors it is given (if it does, every timed call
   copies them first, as a caller who keeps A would), and warms up with
   calls of the cell's own shapes (the first run of a checkout builds the
   port's kernels here, into ``elementalx_torch/kernels/_build/``);
2. the window: a closed loop of one caller for ``--seconds``, each call
   ``DistMatrix.from_global`` of the inputs the configuration's call names
   (A, and B where it names B) on a 1 x 1 Grid of cuda:0, the
   configuration's public entry, and a synchronize, cycling through the P
   problems; each call timed by CUDA events around it, and the infinity
   norm of every part of its answer (X, or a tuple such as (w, Q)) taken
   after it to count non-finite answers. After each
   call the caller collects Python's garbage (``gc.collect()``, cheap
   since set-up's objects are frozen): each solve of the port leaves
   reference cycles that hold n x n device buffers, and a caller that
   waits for Python's own collections runs out of device memory at
   n = 16384. The collection's time counts in the window, and the device
   memory it frees a call is the per-layer metric
   ``blas.cycle_garbage_mib``;
3. with ``--trace 1``, a scheduled profiler window of whole calls
   (trace.py), read by every per-layer metric's reader (``metrics/``);
4. the judge (judge.py): a sample of the window's answers, drawn from the
   seed, against the plain reference, once the window has closed, its
   memory peak has been read and the program's state is freed.

Stdout carries the card's name, power limit and clocks, the call count
and the launch counters per call, and ends in one JSON line with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``breakdown`` with ``--trace 1``) and, last, ``checks``: each number
compared, with its limit, as the last lines of stderr also give them.
Without a CUDA card (or with fewer than the cell asks for), or if JAX or
the JAX package is loaded when the window has closed, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import ctypes  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional, Tuple, Union  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import elementalx_torch as Et  # noqa: E402
from elxbench import cells, stats, trace  # noqa: E402
from elxbench.judge import judge  # noqa: E402

#: top-level module names that no run may load
FOREIGN = ("jax", "jaxlib", "flax", "elementalx")
#: answers of the window kept for the judge (a reservoir drawn from the seed)
SAMPLES = 16
#: the traced step: at least 1 call, about a second of them, at most 100
TRACE_CALLS = (1, 1.0, 100)
#: cache directories inside the checkout, at fixed paths
CACHE_VARS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor",
              "CUDA_CACHE_PATH": "nv"}
SMI_FIELDS = ("name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,"
              "temperature.gpu,power.draw")

#: a call's answer: X, or a tuple of tensors such as (w, Q)
Answer = Union[torch.Tensor, Tuple[torch.Tensor, ...]]
Solver = Callable[..., Answer]


def no_span(name: str):
    return contextlib.nullcontext()


def resolve_call(call: list) -> Tuple[Callable, list]:
    """(entry, arguments) of a configuration's ``call`` (checked by
    ``cells.check_call``): the port's public entry by its name, then each
    argument: "A" and "B" kept as the names of the inputs, any other string
    the package's constant of that name, a number as it is."""
    name, *args = call
    return getattr(Et, name), [
        getattr(Et, s) if isinstance(s, str) and s not in cells.INPUTS else s
        for s in args]


def _local(x):
    """A DistMatrix replicated and cut to its logical shape; a tensor as it
    is."""
    return x.replicated()[:x.m, :x.n] if isinstance(x, Et.DistMatrix) else x


def port_solver(config: dict, grid) -> Solver:
    """solve(a, b, span) -> the answer through the configuration's public
    entry of the port (``config["call"]``, see ``resolve_call``), "A" and
    "B" the DistMatrices of a and b, each built only where the call names
    it. A DistMatrix result is X; a tuple result stays a tuple, each
    DistMatrix in it replicated and cut to its logical shape, each tensor
    kept as it is."""
    entry, args = resolve_call(config["call"])
    named = [s for s in config["call"][1:] if s in cells.INPUTS]

    def solve(a, b, span=no_span):
        with span("elxbench.from_global"):
            mats = {s: Et.DistMatrix.from_global(t, grid=grid)
                    for s, t in (("A", a), ("B", b)) if s in named}
        with span("elxbench.solve"):
            out = entry(*[mats[s] if s in cells.INPUTS else s for s in args])
        if isinstance(out, tuple):
            return tuple(_local(x) for x in out)
        return _local(out)

    return solve


def control_solver(cell, precision: Optional[str] = None) -> Solver:
    """The plain reference in the program's place, at the precision below
    the traffic's that the configuration names (or at ``precision``, a
    fault of another kind that its reference computes), every part of its
    answer cast to the traffic's dtype."""
    dtype = getattr(torch, cell.traffic["dtype"])
    precision = precision or cell.config["control"][cell.traffic["dtype"]]

    def solve(a, b, span=no_span):
        x = cell.reference.solve(a, b, precision)
        if isinstance(x, tuple):
            return tuple(t.to(dtype) for t in x)
        return x.to(dtype)

    return solve


def traced_calls(per_call_s: float) -> int:
    """The calls of the traced step (``TRACE_CALLS``) at ``per_call_s``
    seconds a call."""
    lo, target_s, hi = TRACE_CALLS
    return max(lo, min(hi, math.ceil(target_s / per_call_s)))


def launch_counts() -> Dict[str, int]:
    """Every launch counter of the port's kernel wrappers
    (``<wrapper>.launches`` and ``.launches_<core or route>``)."""
    out = {}
    for modname, mod in list(sys.modules.items()):
        if not modname.startswith("elementalx_torch.kernels.") or mod is None:
            continue
        for attr, fn in vars(mod).items():
            if (callable(fn) and hasattr(fn, "launches")
                    and getattr(fn, "__module__", None) == modname):
                for k, v in vars(fn).items():
                    if k.startswith("launches") and isinstance(v, int):
                        out[f"{modname.rsplit('.', 1)[1]}.{attr}.{k}"] = v
    return out


def smi() -> Optional[str]:
    """The card's name, power limit, clocks, temperature and draw."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def foreign_modules() -> List[str]:
    """The FOREIGN top-level names loaded in this process."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def run(cell, seed: int, seconds: float, traced: bool, dev: torch.device,
        solver: Optional[Solver] = None, t0: Optional[float] = None,
        log: Callable[[str], None] = print,
        readings: Optional[dict] = None) -> dict:
    """One run of ``cell`` on ``dev``: the result's fields, ``checks`` last.
    ``solver`` replaces the port (the control, the harness's tests); ``t0``
    is when set-up began (this module's import by default); ``readings``,
    if given, receives every number the judge read, compared or not."""
    t0 = _T0 if t0 is None else t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    tr = cell.traffic
    dtype = getattr(torch, tr["dtype"])
    n, nrhs, P = tr["n"], tr["nrhs"], tr["problems"]
    if cuda:
        log(f"elxbench: card {smi()}; {torch.cuda.get_device_name(dev)}; "
            f"torch {torch.__version__} cuda {torch.version.cuda}")
    gen = torch.Generator(device=dev).manual_seed(seed % 2 ** 63)
    problems = [cell.reference.make_problem(n, nrhs, dtype, gen)
                for _ in range(P)]
    solver = solver or port_solver(cell.config, Et.Grid(dev))

    # Does the solver write into the tensors it is given?
    kept0 = tuple(t.clone() for t in problems[0])
    solver(*problems[0])
    sync()
    writes = not all(torch.equal(k, t) for k, t in zip(kept0, problems[0]))
    if writes:
        problems[0] = kept0
    del kept0

    if cuda:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    norms: List[torch.Tensor] = []

    def call(p: int):
        """(the answer or None, ms by the device's clock, ms by the
        host's)."""
        a, b = problems[p]
        h0 = time.perf_counter()
        if cuda:
            e0.record()
        if writes:
            a, b = a.clone(), b.clone()
        try:
            x = solver(a, b)
        except Exception:  # a failed call counts; the window goes on
            traceback.print_exc(limit=4)
            x = None
        if cuda:
            e1.record()
        if isinstance(x, tuple):
            norms.append(sum(torch.linalg.vector_norm(t, math.inf).double()
                             for t in x))
        elif x is not None:
            norms.append(torch.linalg.vector_norm(x, math.inf))
        sync()
        host_ms = (time.perf_counter() - h0) * 1e3
        return x, (e0.elapsed_time(e1) if cuda else host_ms), host_ms

    def collect() -> Tuple[int, int]:
        """(objects, device bytes) that a collection frees."""
        m0 = torch.cuda.memory_allocated(dev) if cuda else 0
        found = gc.collect()
        return found, m0 - (torch.cuda.memory_allocated(dev) if cuda else 0)

    for i in range(max(3, P)):
        call(i % P)
        collect()
    norms.clear()
    gc.freeze()  # set-up's objects: later collections skip them

    # The window.
    rng = random.Random(seed)
    samples: List[tuple] = []
    call_ms: List[float] = []
    host_ms: List[float] = []
    raised = returned = 0
    freed = [0, 0]
    before = launch_counts()
    w0 = time.perf_counter()
    while not call_ms or time.perf_counter() < w0 + seconds:
        p = len(call_ms) % P
        x, ms, hms = call(p)
        call_ms.append(ms)
        host_ms.append(hms)
        if x is None:
            raised += 1
        else:
            if returned < SAMPLES:
                samples.append((p, x))
            else:
                j = rng.randrange(returned + 1)
                if j < SAMPLES:
                    samples[j] = (p, x)
            returned += 1
            del x
        objs, nbytes = collect()
        freed[0] += objs
        freed[1] += nbytes
    window_s = time.perf_counter() - w0
    calls = len(call_ms)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    after = launch_counts()
    nonfinite = (int((~torch.isfinite(torch.stack(norms))).sum())
                 if norms else 0)
    norms.clear()
    failed = raised + nonfinite
    if cuda:
        torch.cuda.empty_cache()
    log(f"elxbench: {calls} calls in {window_s:.3f} s over {P} problems "
        f"(n={n}, nrhs={nrhs}, {tr['dtype']}); inputs written by the "
        f"solver: {'yes, copied in every call' if writes else 'no'}; "
        f"{raised} raised, {nonfinite} non-finite")
    log(f"elxbench: garbage a call: {freed[0] / calls!r} objects in "
        f"reference cycles, {freed[1] / calls / 2 ** 30!r} GiB of device "
        f"memory freed by the collection")
    log("elxbench: launches per call " + json.dumps(
        {k: (v - before.get(k, 0)) / calls for k, v in sorted(after.items())
         if v != before.get(k, 0)}))
    log(f"elxbench: host-clock ms a call: median "
        f"{statistics.median(host_ms)!r} p90 "
        f"{stats.nearest_rank(host_ms, 0.9)!r}; device-clock median "
        f"{statistics.median(call_ms)!r}")

    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": False, "attempted": calls, "failed": failed}
    if traced:
        from torch.profiler import record_function

        per_call_s = statistics.median(call_ms) / 1e3
        k = [0]

        def one():
            a, b = problems[k[0] % P]
            k[0] += 1
            if writes:
                a, b = a.clone(), b.clone()
            solver(a, b, span=record_function)

        spans = trace.profile_calls(one, traced_calls(per_call_s), sync,
                                    collect)
        summary = trace.summarize(*spans)
        peaks = cells.load_json(cells.HERE / "peaks.json")
        ctx = dict(summary, dtype=tr["dtype"],
                   flops_per_call=cell.work.flops(n, nrhs),
                   bytes_per_call=cell.work.nbytes(
                       n, nrhs, torch.finfo(dtype).bits // 8),
                   peak_flops_per_s=peaks["flops_per_s"].get(tr["dtype"]),
                   peak_bytes_per_s=peaks["bytes_per_s"])
        if cuda:
            ctx["cycle_bytes_per_call"] = freed[1] / calls
        metrics = {}
        for name, reader in cells.readers().items():
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result.update(metrics=metrics, device=device,
                      breakdown=summary["breakdown"])
        log(f"elxbench: traced {summary['calls']} calls: busy "
            f"{summary['busy_s']!r} s of {summary['window_s']!r} s, "
            f"{summary['kernels']} kernels")
    else:
        metrics = dict(stats.window_metrics(window_s, call_ms),
                       setup_s=w0 - t0)
        units = {"solve_ms": "ms", "solve_ms_p90": "ms", "setup_s": "s"}
        result.update(metrics={k: {"value": v, "unit": units[k]}
                               for k, v in metrics.items()}, device=device)
    if cuda:
        log(f"elxbench: card after the window {smi()}")

    checks, read, correct = judge(cell, problems, samples, failed)
    log(f"elxbench: judged {len(samples)} answers: {json.dumps(read)}")
    if readings is not None:
        readings.update(read)
    result["correct"] = correct
    result["checks"] = checks
    gc.unfreeze()
    return result


def emit(result: dict) -> None:
    """The checks as the last lines of stderr, then the result as the last
    line of stdout (after anything a library left in C's stdout buffer)."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    sys.stdout.flush()
    ctypes.CDLL(None).fflush(None)
    print(json.dumps(result, allow_nan=False), flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"elxbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no run", file=sys.stderr)
        return 2
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(ROOT / ".elxbench_cache" / sub)
    torch.set_num_threads(1)
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0))
    found = foreign_modules()
    if found:
        print(f"elxbench: the run loaded {found}: no result", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
