"""Whether what the window produced is correct.

Each sampled call's X is held against the plain reference's X, worked out
again in float64 from the same A and B (``reference/<config>.py``). The
numbers, each evaluated in float64 and scaled by the traffic dtype's eps:

- ``gap``: ||A (X - X_ref)||_inf / (||A||_inf ||X_ref||_inf n eps), the gap
  between the program's answer and the reference's, weighted by A so that
  it reads alike for any conditioning;
- ``fwd``: max|X - X_ref| / (max|X_ref| eps), the same gap entry by entry;
- ``resid``: ||B - A X||_inf / (||A||_inf ||X||_inf n eps), the normwise
  backward error.

A number is compared where the cell (``workloads/<cell>.json``, set from
the program's and the control's readings) or the configuration (the
accuracy it states) gives it a limit, the smaller where both do, and is
the worst over the sampled answers. Beside them ``failed_calls``: calls that raised or returned a
non-finite X (limit 0). A number that is not finite reads as NONFINITE.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

NONFINITE = 1e300


def _inf_norm(m: torch.Tensor) -> float:
    return float(m.abs().sum(dim=1).max())


def _ratio(num: float, den: float) -> float:
    """num / den, NONFINITE where that is not a finite number."""
    v = num / den if den > 0 else (0.0 if num == 0 else math.inf)
    return v if math.isfinite(v) else NONFINITE


def numbers(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
            x_ref: torch.Tensor, eps: float) -> Dict[str, float]:
    """gap, fwd and resid of one answer x (any dtype) for float64 a, b,
    x_ref."""
    n = a.shape[0]
    x = x.to(torch.float64)
    anorm = _inf_norm(a)
    return {"gap": _ratio(_inf_norm(a @ (x - x_ref)),
                          anorm * _inf_norm(x_ref) * n * eps),
            "fwd": _ratio(float((x - x_ref).abs().max()),
                          float(x_ref.abs().max()) * eps),
            "resid": _ratio(_inf_norm(b - a @ x),
                            anorm * _inf_norm(x) * n * eps)}


def judge(cell, problems: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          samples: List[Tuple[int, torch.Tensor]], failed: int
          ) -> Tuple[Dict[str, dict], Dict[str, float], bool]:
    """(the numbers compared, each with its value and limit; every number
    read; correct) for the sampled (problem index, X) answers of a
    window."""
    eps = torch.finfo(getattr(torch, cell.traffic["dtype"])).eps
    limits = dict(cell.config["accuracy"])
    for k, lim in cell.limits.items():
        limits[k] = min(lim, limits.get(k, math.inf))
    worst: Dict[str, float] = {}
    refs: Dict[int, tuple] = {}
    for p, x in samples:
        if p not in refs:
            a, b = (t.to(torch.float64) for t in problems[p])
            refs[p] = (a, b, cell.reference.solve(a, b, "float64"))
        for k, v in numbers(*refs[p][:2], x, refs[p][2], eps).items():
            worst[k] = max(worst.get(k, 0.0), v)
    checks = {k: {"value": worst.get(k, NONFINITE), "limit": lim}
              for k, lim in limits.items()}
    checks["failed_calls"] = {"value": failed, "limit": 0}
    correct = bool(samples) and all(c["value"] <= c["limit"]
                                    for c in checks.values())
    return checks, worst, correct
