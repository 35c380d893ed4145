"""Shared kernel utilities: device dispatch, the CUDA build, launch checks.

The port's kernels are CUDA C++ under ``csrc/`` with a plain C interface.
They are compiled with ``nvcc`` for ``sm_90a`` into one shared library on
first use, into ``_build/<hash of the sources>/`` beside this file, and
loaded with ``ctypes``. Nothing here runs at import: the CPU tests import
every module on machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libelx_kernels.so"

#: kernel dtype codes shared with csrc/*.cu
DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU (the counterpart of the JAX package's ``on_tpu``).
    Kernel wrappers branch on it: CPU tensors take the plain version, CUDA
    tensors the kernel. A mix, or another device type, raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on unsupported or mixed devices: {kinds}")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library. Every source is
    compiled by its own nvcc, all started together, and the objects are
    linked into one library. The build goes to a temporary name and is
    renamed into place, so concurrent first uses do not see a half-written
    file; nvcc's report (registers, shared memory, spills from -Xptxas -v)
    is kept beside it as build.log."""
    so = library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        nvcc = _nvcc()
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = so.parent / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        tmp = so.with_name(f"{LIB_NAME}.{tag}")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                *[str(o) for o in objs]]
        log, failed = [], []
        for cmd, proc in procs:
            out = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(out)
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.stderr)
        (so.parent / "build.log").write_text("\n".join(log))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-8000:])
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.elx_error_string.argtypes = [ctypes.c_int]
    lib.elx_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def kernel_function(name: str, argtypes: tuple):
    """One C entry of the kernel library with its ctypes signature; every
    entry returns a cudaError_t as int."""
    fn = getattr(kernel_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(rc: int, name: str) -> None:
    """Raise when a C entry reports a CUDA error (launch refused, bad
    configuration, or a fault surfaced by an earlier call)."""
    if rc != 0:
        msg = kernel_library().elx_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def current_stream(t: torch.Tensor) -> int:
    """The raw cudaStream_t of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


class Entry:
    """One C entry of the kernel library, named with its ctypes argument
    types where a module is imported and bound on its first call (the
    library is built then, never at import). With ``packed`` (a ``struct``
    format) the entry takes one pointer to its arguments packed in that
    layout: a call then converts one argument instead of one each."""

    __slots__ = ("name", "argtypes", "fn", "pack")

    def __init__(self, name: str, argtypes: tuple = (),
                 packed: Optional[str] = None):
        self.name, self.fn = name, None
        self.pack = struct.Struct(packed).pack if packed else None
        self.argtypes = (ctypes.c_char_p,) if packed else argtypes

    def bind(self):
        """The ctypes function (the library is built on the first call)."""
        if self.fn is None:
            self.fn = kernel_function(self.name, self.argtypes)
        return self.fn

    def __call__(self, *args) -> int:
        fn = self.fn or self.bind()
        return fn(self.pack(*args)) if self.pack else fn(*args)


#: (current device index, raw current stream of a device index), bound on
#: the first launch: PyTorch's own C bindings where the build has them,
#: else the public calls (which build a Stream object each time)
_queries: list = []


def _bind_queries() -> None:
    get_device = getattr(torch._C, "_cuda_getDevice",
                         torch.cuda.current_device)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        def raw(index):
            return torch.cuda.current_stream(index).cuda_stream
    _queries.extend((get_device, raw))


def raw_stream(t: torch.Tensor) -> int:
    """The raw cudaStream_t of PyTorch's current stream on t's device,
    without building a Stream object."""
    if not _queries:
        _bind_queries()
    return _queries[1](t.get_device())


def launch(entry: Entry, t: torch.Tensor, *args) -> None:
    """Call ``entry(*args, stream)`` on PyTorch's current stream of t's
    device and raise on a CUDA error. The lean path of the host-bound
    kernels: no device guard when t's device is already current, the raw
    stream handle without a Stream object, the argument types set once."""
    if not _queries:
        _bind_queries()
    get_device, raw = _queries
    index = t.get_device()
    if get_device() == index:
        rc = entry(*args, raw(index))
    else:
        with torch.cuda.device(index):
            rc = entry(*args, raw(index))
    if rc:
        check_launch(rc, entry.name)


def cooperative_grid(entry: str, t: torch.Tensor) -> int:
    """Blocks of a cooperative launch on t's device for t's dtype, as the
    C entry ``entry`` (``int entry(int dtype, int* grid)``) sizes it so
    that every block is resident at once. The kernel checks the grid it is
    given against the same query, so scratch sized by it fits the launch."""
    dev = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return _cooperative_grid(entry, dev, t.dtype)


@functools.cache
def _cooperative_grid(entry: str, device_index: int,
                      dtype: torch.dtype) -> int:
    fn = kernel_function(entry, (ctypes.c_int, ctypes.c_void_p))
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check_launch(fn(DTYPE_CODE[dtype], ctypes.byref(out)), entry)
    return out.value
