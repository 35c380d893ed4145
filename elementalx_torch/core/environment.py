"""Runtime environment: the blocksize stack and the exceptions the slice
raises.

Counterpart of ``elementalx/core/environment.py`` (reference:
src/core/environment.cpp:114-360, include/El/core/environment/decl.hpp),
reduced to what the HPD-solve path uses.
"""

from __future__ import annotations

import contextlib
from typing import List


class ElError(RuntimeError):
    pass


class LogicError(ElError):
    pass


class NonHPDMatrixException(ElError):
    """Reference: environment/decl.hpp:226 (thrown by unblocked Cholesky)."""

    def __init__(self, msg: str = "Matrix was not numerically HPD"):
        super().__init__(msg)


# Algorithmic blocksize stack (reference: src/blas_like/blocksizes.cpp:16-60;
# default 128 pushed at Initialize, environment.cpp:312-313).
_blocksize_stack: List[int] = [128]


def Blocksize() -> int:
    return _blocksize_stack[-1]


def SetBlocksize(nb: int) -> None:
    _blocksize_stack[-1] = int(nb)


def PushBlocksizeStack(nb: int) -> None:
    _blocksize_stack.append(int(nb))


def PopBlocksizeStack() -> None:
    if len(_blocksize_stack) <= 1:
        raise LogicError("Attempted to pop the base of the blocksize stack")
    _blocksize_stack.pop()


@contextlib.contextmanager
def blocksize(nb: int):
    """Scoped blocksize override (pythonic form of Push/PopBlocksizeStack)."""
    PushBlocksizeStack(nb)
    try:
        yield
    finally:
        PopBlocksizeStack()
