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
import subprocess
from pathlib import Path

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
