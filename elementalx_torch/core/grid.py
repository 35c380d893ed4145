"""Process grid over one device.

Counterpart of ``elementalx/core/grid.py`` (reference:
include/El/core/Grid.hpp:15-146). The JAX grid is a 2-D device mesh; this
one holds a single ``torch.device`` and is 1 x 1, so every distribution
places the whole matrix on that device. A grid over several GPUs (a
``torch.distributed`` mesh) is ROADMAP queue 1 item 11.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


class Grid:
    """A 1 x 1 grid: the device every matrix on it lives on."""

    _default: Optional["Grid"] = None

    def __init__(self, device: Union[torch.device, str, None] = None):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)

    # ---- shape queries (reference: Grid.hpp Height/Width/Size) ----
    @property
    def height(self) -> int:
        return 1

    @property
    def width(self) -> int:
        return 1

    @property
    def size(self) -> int:
        return 1

    def __eq__(self, other) -> bool:
        return isinstance(other, Grid) and self.device == other.device

    def __hash__(self) -> int:
        return hash(self.device)

    def __repr__(self) -> str:
        return f"Grid(1x1, {self.device})"

    # ---- default grid (reference: Grid::Default, environment.cpp:309) ----
    @classmethod
    def default(cls) -> "Grid":
        """A grid on the first CUDA device when there is one, else the CPU."""
        if cls._default is None:
            cls._default = cls()
        return cls._default
