"""What the plain references share: the precisions they compute in, and
the product that each precision takes.

Plain PyTorch only: nothing here imports the port, the JAX package or JAX.
A precision is one of

- ``"float64"``: every step in float64;
- ``"float32"``: every step in float32, products in full FP32;
- ``"tf32"``: float32 whose products take their operands rounded to TF32
  (a 10-bit mantissa, round to nearest) and sum in FP32, as the tensor
  cores' TF32 mode does. The rounding is explicit, so it reads the same on
  the CPU and on any GPU.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float64", "float32", "tf32")


def compute_dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa, to nearest, ties to
    even, kept as float32 (infinities and NaN stay)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def sub_product(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                precision: str) -> None:
    """c -= a @ b in place, the product at ``precision``."""
    if precision == "tf32":
        a, b = tf32_round(a), tf32_round(b)
    c.addmm_(a, b, alpha=-1.0)


@contextlib.contextmanager
def full_fp32():
    """Products in full FP32 inside (TF32 off), the flags restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
