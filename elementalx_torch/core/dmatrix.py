"""DistMatrix: a dense matrix on a Grid, as a padded tensor plus tags.

Counterpart of ``elementalx/core/dmatrix.py`` (reference:
include/El/core/DistMatrix/AbstractDistMatrix.hpp:20-368). As there, a
``DistMatrix`` wraps one globally shaped array, padded in both dimensions
to a multiple of the grid size, with the logical extent (m, n) and the
(col_dist, row_dist) tags as static metadata. Invariant: **the padding
region is always zero**; every op that could break it re-masks.

On the port's 1 x 1 grid the padding quantum is 1, so the padded shape is
(max(m, 1), max(n, 1)) and a redistribution only changes the tags. The
tensor may be a strided view (a transpose is ``.mT``); nothing in the port
writes into a DistMatrix's data in place, so views are safe to share.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .grid import Grid
from .types import Dist, DistWrap, ELEMENT, MC, MR


def pad_quantum(grid: Grid) -> int:
    """Both matrix dimensions are padded to a multiple of this."""
    return grid.size


def padded_extent(extent: int, grid: Grid) -> int:
    q = pad_quantum(grid)
    return max(((extent + q - 1) // q) * q, q)


def pad_array(arr: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Zero-pad a logical (m, n) tensor to the grid-aligned shape."""
    m, n = arr.shape
    pm, pn = padded_extent(m, grid), padded_extent(n, grid)
    if (pm, pn) == (m, n):
        return arr
    out = arr.new_zeros((pm, pn))
    out[:m, :n] = arr
    return out


def _as_tensor(array, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` from a tensor (not copied if it is already
    there) or a host array (copied). numpy has no native bfloat16, so an
    ml_dtypes bfloat16 array goes through float32."""
    if isinstance(array, torch.Tensor):
        return array.to(device)
    array = np.asarray(array)
    if array.dtype.name == "bfloat16":
        return torch.tensor(array.astype(np.float32),
                            device=device).to(torch.bfloat16)
    return torch.tensor(array, device=device)


@dataclasses.dataclass(frozen=True)
class DistMatrix:
    """An m x n matrix: padded tensor + distribution tags on a grid."""

    data: torch.Tensor
    m: int = 0
    n: int = 0
    col_dist: Dist = MC
    row_dist: Dist = MR
    grid: Optional[Grid] = None
    wrap: DistWrap = ELEMENT

    # ---- basic queries (reference: AbstractDistMatrix Height/Width/...) ----
    @property
    def height(self) -> int:
        return self.m

    @property
    def width(self) -> int:
        return self.n

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.n)

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def dist(self) -> Tuple[Dist, Dist]:
        return (self.col_dist, self.row_dist)

    def dist_name(self) -> str:
        return f"[{self.col_dist!r},{self.row_dist!r}]"

    # ---- construction ----
    @staticmethod
    def from_global(array, col_dist: Dist = MC, row_dist: Dist = MR,
                    grid: Optional[Grid] = None,
                    wrap: DistWrap = ELEMENT) -> "DistMatrix":
        """A DistMatrix holding the logical (m, n) array (numpy or torch),
        moved to the grid's device and zero-padded."""
        g = grid or Grid.default()
        arr = _as_tensor(array, g.device)
        if arr.dim() != 2:
            raise ValueError("DistMatrix is 2-D")
        m, n = arr.shape
        return DistMatrix(pad_array(arr, g), m, n, col_dist, row_dist, g, wrap)

    @staticmethod
    def from_padded(data: torch.Tensor, m: int, n: int, col_dist: Dist = MC,
                    row_dist: Dist = MR, grid: Optional[Grid] = None,
                    wrap: DistWrap = ELEMENT) -> "DistMatrix":
        """Wrap an already grid-aligned tensor (padding must be zero)."""
        g = grid or Grid.default()
        return DistMatrix(data.to(g.device), m, n, col_dist, row_dist, g, wrap)

    @staticmethod
    def from_reference(data: np.ndarray, m: int, n: int, col_dist: Dist = MC,
                       row_dist: Dist = MR, grid: Optional[Grid] = None,
                       wrap: DistWrap = ELEMENT) -> "DistMatrix":
        """The port's DistMatrix for a JAX package DistMatrix, given its
        padded ``data`` read through numpy and its metadata. The reference
        pads to its own grid's quantum; the result is cut or padded to the
        port's canonical shape. Raises if the given padding is not zero."""
        g = grid or Grid.default()
        dm = DistMatrix(_as_tensor(data, g.device), m, n, col_dist, row_dist,
                        g, wrap)
        dm.check_valid()
        return dm.canonical()

    def with_data(self, data: torch.Tensor, m: Optional[int] = None,
                  n: Optional[int] = None) -> "DistMatrix":
        """Same distribution/grid, new padded contents."""
        return dataclasses.replace(
            self, data=data, m=self.m if m is None else m,
            n=self.n if n is None else n)

    def canonical(self) -> "DistMatrix":
        """Slice/pad ``data`` to the canonical padded shape for (m, n)."""
        pm, pn = padded_extent(self.m, self.grid), padded_extent(self.n, self.grid)
        if tuple(self.data.shape) == (pm, pn):
            return self
        d = self.data[: min(pm, self.data.shape[0]),
                      : min(pn, self.data.shape[1])]
        if tuple(d.shape) != (pm, pn):
            full = d.new_zeros((pm, pn))
            full[: d.shape[0], : d.shape[1]] = d
            d = full
        return self.with_data(self.mask_like(d))

    def mask_like(self, data: torch.Tensor) -> torch.Tensor:
        """Zero entries outside the logical (m, n) region of ``data``
        (shape-agnostic variant of mask_padding)."""
        P, Q = data.shape
        i = torch.arange(P, device=data.device)[:, None]
        j = torch.arange(Q, device=data.device)[None, :]
        return torch.where((i < self.m) & (j < self.n), data,
                           torch.zeros((), dtype=data.dtype, device=data.device))

    # ---- padding helpers ----
    def row_mask(self) -> torch.Tensor:
        """(P, 1) bool: rows < m."""
        return torch.arange(self.data.shape[0], device=self.device)[:, None] < self.m

    def col_mask(self) -> torch.Tensor:
        return torch.arange(self.data.shape[1], device=self.device)[None, :] < self.n

    def pad_mask(self) -> torch.Tensor:
        """(P, Q) bool mask of the logical region."""
        return self.row_mask() & self.col_mask()

    def mask_padding(self, data: torch.Tensor) -> torch.Tensor:
        """Zero the padding region of a padded-shape tensor."""
        return torch.where(self.pad_mask(), data,
                           torch.zeros((), dtype=data.dtype, device=data.device))

    # ---- redistribution (reference: the operator= table, MC_MR.cpp:111-177) --
    def redistribute(self, col_dist: Dist, row_dist: Dist) -> "DistMatrix":
        """On a 1 x 1 grid every distribution holds the whole matrix on the
        one device, so a redistribution only re-tags."""
        if (self.col_dist, self.row_dist) == (col_dist, row_dist):
            return self
        return dataclasses.replace(self, col_dist=col_dist, row_dist=row_dist)

    def check_valid(self) -> None:
        """Validate the library invariant: the padding region of ``data``
        is identically zero."""
        bad = float(torch.sum(torch.abs(torch.where(
            self.pad_mask(), torch.zeros((), dtype=self.dtype,
                                         device=self.device),
            self.data))))
        if bad != 0:
            raise AssertionError(
                f"DistMatrix padding invariant violated: |pad| sum = {bad}")

    # ---- materialisation ----
    def global_array(self) -> np.ndarray:
        """The logical matrix as a host numpy array (bfloat16 comes back as
        float32, which numpy can hold)."""
        d = self.data[: self.m, : self.n]
        if d.dtype == torch.bfloat16:
            d = d.float()
        return d.cpu().resolve_conj().numpy()

    def __repr__(self) -> str:
        return (f"DistMatrix({self.m}x{self.n}, {self.dist_name()}, "
                f"{self.dtype}, grid={self.grid}, "
                f"padded={tuple(self.data.shape)})")


def check_same_grid(*mats: DistMatrix) -> Grid:
    """Conformality check (reference: EL_DEBUG_ONLY AssertSameGrids)."""
    g = mats[0].grid
    for m in mats[1:]:
        if m.grid != g:
            raise ValueError("DistMatrices live on different grids")
    return g
