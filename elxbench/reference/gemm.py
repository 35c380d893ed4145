"""Plain reference of the ``gemm`` configuration: X = A B (BLAS xGEMM with
TRANSA = TRANSB = 'N', alpha = 1, beta = 0).

``make_problem`` draws A (n x n) and B (n x nrhs) standard normal in the
cell's dtype from the generator. ``solve`` is the product in plain
PyTorch at one of these precisions:

- ``"float64"``, ``"float32"``: the plain product in that dtype (float32
  in full FP32, TF32 off);
- ``"fp8"``: the control one precision below bfloat16: A and B rounded to
  float8 e4m3 (3 mantissa bits, to nearest), their product summed in full
  FP32, as an FP8 tensor-core product would take them;
- ``"bf16_sum"``: the product over K-slabs of ``SLAB`` columns, each
  slab's FP32 partial added into a bfloat16 accumulator, as a kernel that
  keeps C in bfloat16 between its K tiles would.

Returned in float64 for ``"float64"`` and in float32 otherwise (the
bfloat16 accumulator of ``"bf16_sum"`` widened exactly).
"""

from __future__ import annotations

from typing import Tuple

import torch

from elxbench.reference.common import full_fp32

PRECISIONS = ("float64", "float32", "fp8", "bf16_sum")
#: the K-slab of ``"bf16_sum"``
SLAB = 256


def make_problem(n: int, nrhs: int, dtype: torch.dtype,
                 gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, B) drawn on gen's device from ``gen``."""
    a = torch.randn((n, n), generator=gen, device=gen.device, dtype=dtype)
    b = torch.randn((n, nrhs), generator=gen, device=gen.device, dtype=dtype)
    return a, b


def solve(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """A B for ``a`` (n x k) and ``b`` (k x nrhs) at ``precision``."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "float64":
        return a.to(torch.float64) @ b.to(torch.float64)
    with full_fp32():
        if precision == "float32":
            return a.float() @ b.float()
        if precision == "fp8":
            f8 = torch.float8_e4m3fn
            return a.to(f8).float() @ b.to(f8).float()
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.bfloat16,
                          device=a.device)
        for k0 in range(0, a.shape[1], SLAB):
            part = a[:, k0:k0 + SLAB].float() @ b[k0:k0 + SLAB].float()
            acc = (acc.float() + part).to(torch.bfloat16)
        return acc.float()
