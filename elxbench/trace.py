"""The traced run: a scheduled torch.profiler window of whole calls, and its
reduction to the device's busy time, its idle gaps and its kernels.

A profiler window that opens just before the launches can lose some or all
of them (CUPTI starts late), which makes the idle share read high. So the
calls run in the second step of a scheduled window, after a warm-up step
of one call, with 20 ms of idle host time around each step. The traced
window is the recorded calls' own time (each call ends in a synchronize;
what the harness does between calls is left out); the device is busy
where any device operation (kernel, copy or fill) runs.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence, Tuple

Span = Tuple[str, float, float]  # (name, start, end), in microseconds

CALL = "elxbench.call"
ANNOTATIONS = ("elxbench.", "ProfilerStep")
TOP = 10
NAME_CHARS = 200


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: Sequence[Tuple[float, float]], w0: float,
         w1: float) -> List[Tuple[float, float]]:
    """The parts of [w0, w1] that the disjoint sorted ``busy`` leaves."""
    out, t = [], w0
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if w1 > t:
        out.append((t, w1))
    return out


def host_ops(cpu: Sequence[Span], times: Sequence[float]) -> List[str]:
    """For each time, the innermost host operation running then: of the
    spans that hold it, the last to start (spans of one thread nest), or
    "no host op" where none does. One sweep over spans and times."""
    spans = sorted(cpu, key=lambda sp: (sp[1], -sp[2]))
    order = sorted(range(len(times)), key=lambda k: times[k])
    out = ["no host op"] * len(times)
    stack: List[Span] = []
    i = 0
    for k in order:
        t = times[k]
        while i < len(spans) and spans[i][1] <= t:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        if stack:
            out[k] = stack[-1][0]
    return out


def _top(totals: Dict[str, float]) -> List[list]:
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:NAME_CHARS], seconds] for name, seconds in ranked]


def summarize(device: Sequence[Span], cpu: Sequence[Span]) -> dict:
    """Busy and window seconds, the number of kernels, and the breakdown
    (device operations by time, idle gaps by the host operation running
    during them) of the traced calls: the ``CALL`` spans of ``cpu``. The
    window is the calls' own time, what the harness does between them
    left out."""
    calls = merge([(s, e) for name, s, e in cpu if name == CALL])
    if not calls:
        raise ValueError("the trace holds no call")
    # the profiler mirrors host annotations onto the device's timeline:
    # they are no device operations
    ops: Dict[str, float] = {}
    busy, holes = [], []
    n_kernels = 0
    for w0, w1 in calls:
        inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device
                  if e > w0 and s < w1 and not n.startswith(ANNOTATIONS)]
        for name, s, e in inside:
            ops[name] = ops.get(name, 0.0) + (e - s) * 1e-6
        n_kernels += sum(1 for n, _, _ in inside
                         if not n.startswith(("Memcpy", "Memset")))
        spans = merge([(s, e) for _, s, e in inside])
        busy += spans
        holes += gaps(spans, w0, w1)
    host = [sp for sp in cpu if not sp[0].startswith(ANNOTATIONS[1])]
    idle: Dict[str, float] = {}
    for (s, e), name in zip(holes, host_ops(host, [(s + e) / 2
                                                   for s, e in holes])):
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    return {
        "calls": len(calls),
        "window_s": sum(e - s for s, e in calls) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": n_kernels,
        "breakdown": {"device_ops": _top(ops), "idle_gaps": _top(idle)},
    }


def profile_calls(call: Callable[[], None], n_calls: int,
                  sync: Callable[[], None], after: Callable[[], None]
                  ) -> Tuple[List[Span], List[Span]]:
    """(device spans, host spans) of ``n_calls`` calls of ``call`` (each
    wrapped in a ``CALL`` span and ended by ``sync``; ``after`` runs
    between the spans) in the recorded step of a scheduled profiler
    window."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for count in (1, n_calls):
            time.sleep(0.02)
            for _ in range(count):
                with record_function(CALL):
                    call()
                    sync()
                after()
            time.sleep(0.02)
            prof.step()
    cuda = torch.autograd.DeviceType.CUDA
    device, cpu = [], []
    for ev in prof.events():
        span = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == cuda:
            device.append(span)
        else:
            cpu.append((ev.thread, span))
    # the host spans of the thread that ran the calls, which nest
    threads = {th for th, sp in cpu if sp[0] == CALL}
    return device, [sp for th, sp in cpu if th in threads]
