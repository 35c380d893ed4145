"""Spans at the port's layer boundaries, and the kernel wrappers' launch
counters.

**Spans.** ``span(name, device)`` marks one stage of the program (``with
span("lapack.Cholesky", A.device): ...``); ``traced(name)`` is its
decorator form. Names run from the layer down: ``lapack.*``, ``blas.*``,
``core.*``.

Recording follows a running ``torch.profiler`` and has no switch of its
own. With no profiler recording, ``span`` makes one check and returns a
shared null context. While one records, a span

1. is a CPU-op span ``elx.<name>`` on the profiler's clock
   (``_RecordFunctionFast``, function scope: it is not mirrored onto the
   device's timeline), so an exported trace shows each stage beside the
   kernels it launched and an idle gap of the device can be put down to
   the stage the host was in;
2. appends a record: its name, the index of its parent span and of its
   outermost span, and its host start and end (``time.perf_counter_ns``);
3. given a CUDA ``device``, records a CUDA timing event on the device's
   current stream at entry and at exit, so its device time runs from the
   stream reaching the first to reaching the second.

The first span that finds a profiler recording after a span that found
none starts the record afresh, so the record holds the spans of one
profiler session (in a scheduled window: of its recorded step).
``summary()`` reduces the record by span name. The record and the stack of
open spans belong to the process; spans nest on one thread.

**Launch counters.** Each kernel wrapper counts its launches in
attributes of its own function object: ``<wrapper>.launches`` and, by
core or route, ``<wrapper>.launches_<key>`` (``count``, ``reset_counts``).
They count whether or not a profiler runs.

This module imports only torch and the standard library, so every layer
of the port can import it.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, Iterable, List, Optional

import torch

_enabled = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
PREFIX = "elx."


class _Record:
    """One span: name, parent and outermost span (indices into the
    record, -1 for none), host start and end in ns, and the CUDA events at
    entry and exit (None for a span without a CUDA device)."""

    __slots__ = ("name", "parent", "root", "t0", "t1", "e0", "e1")

    def __init__(self, name: str, parent: int, root: int):
        self.name, self.parent, self.root = name, parent, root
        self.t0 = self.t1 = self.e0 = self.e1 = None


_RECORDS: List[_Record] = []
_OPEN: List[int] = []  # indices of the open recorded spans, innermost last
_fresh = True  # a span found no profiler since the record was last begun


class _Span:
    """A span while a profiler records (see the module's docstring)."""

    __slots__ = ("name", "device", "rf", "rec", "idx", "stream")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        global _fresh
        if _fresh:
            _RECORDS.clear()
            _OPEN.clear()
            _fresh = False
        self.rf = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self.rf.__enter__()
        parent = _OPEN[-1] if _OPEN else -1
        self.idx = len(_RECORDS)
        root = _RECORDS[parent].root if parent >= 0 else self.idx
        self.rec = _Record(self.name, parent, root)
        _RECORDS.append(self.rec)
        _OPEN.append(self.idx)
        dev = self.device
        self.stream = (torch.cuda.current_stream(dev)
                       if dev is not None and dev.type == "cuda" else None)
        if self.stream is not None:
            self.rec.e0 = torch.cuda.Event(enable_timing=True)
            self.rec.e0.record(self.stream)
        self.rec.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec.t1 = time.perf_counter_ns()
        if self.stream is not None:
            self.rec.e1 = torch.cuda.Event(enable_timing=True)
            self.rec.e1.record(self.stream)
        if _OPEN and _OPEN[-1] == self.idx:
            _OPEN.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A context manager that records the stage ``name`` while a torch
    profiler records, and is a shared null context otherwise. Given a CUDA
    ``device``, the span's device time is taken on its current stream."""
    if not _enabled():
        global _fresh
        _fresh = True
        return _NULL
    return _Span(name, device)


def traced(name: str) -> Callable:
    """Decorator form of ``span(name)`` (no device time)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def records() -> List[_Record]:
    """The spans recorded in the last profiler session, in entry order."""
    return list(_RECORDS)


def reset() -> None:
    """Forget every recorded span."""
    global _fresh
    _RECORDS.clear()
    _OPEN.clear()
    _fresh = True


def summary(recs: Optional[List[_Record]] = None) -> dict:
    """``{"solves": n, "spans": {name: {"count", "host_ms", "self_ms",
    "device_ms"}}}`` of the closed spans of ``recs`` (the last profiler
    session's record by default): ``self_ms`` is the host time less that
    of the span's direct children; ``device_ms`` sums the device times of
    the name's spans that took one (None where none did); ``solves``
    counts the outermost ``lapack.*`` spans. Synchronizes on the spans'
    exit events."""
    recs = _RECORDS if recs is None else recs
    child_ns = [0] * len(recs)
    for r in recs:
        if r.parent >= 0 and r.t1 is not None:
            child_ns[r.parent] += r.t1 - r.t0
    out: Dict[str, dict] = {}
    solves = 0
    for i, r in enumerate(recs):
        if r.t1 is None:
            continue
        if r.parent < 0 and r.name.startswith("lapack."):
            solves += 1
        s = out.setdefault(r.name, {"count": 0, "host_ms": 0.0,
                                    "self_ms": 0.0, "device_ms": None})
        s["count"] += 1
        s["host_ms"] += (r.t1 - r.t0) * 1e-6
        s["self_ms"] += (r.t1 - r.t0 - child_ns[i]) * 1e-6
        if r.e0 is not None and r.e1 is not None:
            r.e1.synchronize()
            s["device_ms"] = (s["device_ms"] or 0.0) + r.e0.elapsed_time(r.e1)
    return {"solves": solves, "spans": out}


def count(fn: Callable, key: Optional[str] = None) -> None:
    """Count one launch of the kernel wrapper ``fn``: ``fn.launches`` and,
    given a core or route ``key``, ``fn.launches_<key>``."""
    fn.launches += 1
    if key is not None:
        name = "launches_" + key
        setattr(fn, name, getattr(fn, name) + 1)


def reset_counts(fn: Callable, keys: Iterable[str] = ()) -> None:
    """Zero ``fn.launches`` and ``fn.launches_<key>`` for every key."""
    fn.launches = 0
    for key in keys:
        setattr(fn, "launches_" + key, 0)
