"""Process grid: an r x c array of positions, each on a ``torch.device``.

Counterpart of ``elementalx/core/grid.py`` (reference:
include/El/core/Grid.hpp:15-146). The JAX grid is a 2-D device mesh with
axes ('mc', 'mr') that one Python process drives; this one is the same
single-controller design over torch devices. Position (i, j) sits on
``devices[i * c + j]``, the JAX mesh order. A device may appear at several
positions: that is a *virtual grid*, the counterpart of JAX's virtual CPU
mesh, and it lets one card run every redistribution and every SUMMA
variant. A torch.distributed process group could not: NCCL refuses two
ranks on one GPU.

The axis groups map as in the JAX package:

  MC   -> the grid's rows index i        (r parts)
  MR   -> the grid's columns index j     (c parts)
  VC   -> i * c + j, mc-major            (p parts)
  VR   -> j * r + i, mr-major            (p parts)
  MD   -> carried as VC
  STAR, CIRC -> replicated               (1 part)

``Grid(device)`` is the 1 x 1 grid every single-device path runs on.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from .types import CIRC, Dist, MC, MD, MR, STAR, VC, VR

DeviceLike = Union[torch.device, str]


def default_grid_height(p: int) -> int:
    """Largest divisor of p that is <= sqrt(p), biased upward like the
    reference's Grid::DefaultHeight (src/core/Grid.cpp)."""
    h = int(math.isqrt(p))
    while h > 1 and p % h != 0:
        h -= 1
    return max(h, 1)


# The mesh axes each distribution splits over ('mc' then 'mr' for VC).
_AXES = {
    MC: ("mc",),
    MR: ("mr",),
    MD: ("mc", "mr"),  # physically VC, as in the JAX package
    VC: ("mc", "mr"),
    VR: ("mr", "mc"),
    STAR: (),
    CIRC: (),  # replicated physically; root-owned semantically
}


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "Grid(): no CUDA device. The port runs on the card unless the "
            "caller asks for the CPU: pass Grid('cpu') or device='cpu'")
    return torch.device("cuda", 0)


class Grid:
    """An r x c grid of positions; position (i, j) on devices[i*c + j]."""

    _default: Optional["Grid"] = None

    def __init__(self, devices: Union[DeviceLike, Sequence[DeviceLike],
                                      None] = None,
                 height: Optional[int] = None):
        if devices is None:
            devices = [_default_device()]
        elif isinstance(devices, (str, torch.device)):
            devices = [devices]
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("Grid needs at least one device")
        p = len(devs)
        r = height if height is not None else default_grid_height(p)
        if r < 1 or p % r != 0:
            raise ValueError(f"grid height {r} does not divide p={p}")
        self._devices = tuple(devs)
        self._height = r

    # ---- shape queries (reference: Grid.hpp Height/Width/Size) ----
    @property
    def height(self) -> int:
        return self._height

    @property
    def width(self) -> int:
        return len(self._devices) // self._height

    @property
    def size(self) -> int:
        return len(self._devices)

    @property
    def gcd(self) -> int:
        return math.gcd(self.height, self.width)

    @property
    def lcm(self) -> int:
        return self.height * self.width // self.gcd

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The device of each position, in mc-major (VC) order."""
        return self._devices

    @property
    def device(self) -> torch.device:
        """The device of position (0, 0): on a 1 x 1 grid, the device every
        matrix on it lives on."""
        return self._devices[0]

    def coords(self, q: int) -> Tuple[int, int]:
        """(i, j) of the position at mc-major index q."""
        return divmod(q, self.width)

    # ---- axis groups (reference: the MC/MR/VC/VR/MD communicators) ----
    def parts(self, d: Dist) -> int:
        """How many parts distribution d cuts its axis into."""
        if d == MC:
            return self.height
        if d == MR:
            return self.width
        if d in (VC, VR, MD):
            return self.size
        return 1

    def part(self, d: Dist, q: int) -> int:
        """The part of an axis distributed as d that position q holds."""
        i, j = self.coords(q)
        if d == MC:
            return i
        if d == MR:
            return j
        if d in (VC, MD):
            return i * self.width + j
        if d == VR:
            return j * self.height + i
        return 0

    def group(self, axis: str, q: int) -> List[int]:
        """The positions of q's communicator over ``axis``, in the order of
        that axis's index: 'mc' (q's grid column, by row index i), 'mr'
        (q's grid row, by column index j), 'vc' (all, mc-major) or 'vr'
        (all, mr-major)."""
        i, j = self.coords(q)
        r, c = self.height, self.width
        if axis == "mc":
            return [ii * c + j for ii in range(r)]
        if axis == "mr":
            return [i * c + jj for jj in range(c)]
        if axis == "vc":
            return list(range(r * c))
        if axis == "vr":
            return [ii * c + jj for jj in range(c) for ii in range(r)]
        raise ValueError(f"unknown grid axis {axis!r}")

    def check_pair(self, col_dist: Dist, row_dist: Dist) -> None:
        """Raise for a pair whose two axes claim the same mesh axis (pairs
        the reference never instantiates), as the JAX ``Grid.spec`` does."""
        if set(_AXES[col_dist]) & set(_AXES[row_dist]):
            raise ValueError(
                f"invalid distribution pair [{col_dist!r},{row_dist!r}]")

    # Grids compare by their layout of positions to devices.
    def __eq__(self, other) -> bool:
        return (isinstance(other, Grid) and self._height == other._height
                and self._devices == other._devices)

    def __hash__(self) -> int:
        return hash((self._height, self._devices))

    def __repr__(self) -> str:
        if self.size == 1:
            return f"Grid(1x1, {self.device})"
        devs = sorted({str(d) for d in self._devices})
        return f"Grid({self.height}x{self.width}, {', '.join(devs)})"

    # ---- default grid (reference: Grid::Default, environment.cpp:309) ----
    @classmethod
    def default(cls) -> "Grid":
        """The grid set by ``set_default``, else a 1 x 1 grid on cuda:0;
        raises RuntimeError where there is no CUDA device."""
        if cls._default is None:
            cls._default = cls()
        return cls._default

    @classmethod
    def set_default(cls, grid: Optional["Grid"]) -> None:
        cls._default = grid


def DefaultGrid() -> Grid:
    """Reference: El::DefaultGrid()."""
    return Grid.default()
