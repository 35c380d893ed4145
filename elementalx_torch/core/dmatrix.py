"""DistMatrix: a dense matrix on a Grid, as padded tensors plus tags.

Counterpart of ``elementalx/core/dmatrix.py`` (reference:
include/El/core/DistMatrix/AbstractDistMatrix.hpp:20-368). As there, the
matrix is padded in both dimensions to a multiple of the grid size p, with
the logical extent (m, n) and the (col_dist, row_dist) tags as static
metadata. Invariant: **the padding region is always zero**; every op that
could break it re-masks.

On a 1 x 1 grid the padding quantum is 1, so the padded shape is
(max(m, 1), max(n, 1)); the matrix is one tensor, ``data``, and a
redistribution only changes the tags. That tensor may be a strided view (a
transpose is ``.mT``); nothing in the port writes into a DistMatrix's data
in place, so views are safe to share.

On a grid of size > 1 the matrix is ``blocks``: one local tensor per
position (mc-major), on that position's device, cut from the padded
global array exactly as the JAX ``NamedSharding`` of ``grid.spec(col,
row)`` cuts it: contiguous blocks, MC over the grid's rows, MR over its
columns, VC in mc-major and VR in mr-major order, STAR and CIRC
replicated. (This is the JAX package's layout, not Elemental's
element-cyclic one.) Such a matrix has no global tensor: ``data`` raises,
so every operation that has no distributed form yet raises
NotImplementedError instead of gathering behind the caller's back.
``replicated`` and ``global_array`` gather explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import trace
from .grid import Grid
from .types import Dist, DistWrap, ELEMENT, MC, MR

#: Where an operation without a distributed form says so.
NOT_DISTRIBUTED = ("{what} has no distributed form in the port yet "
                   "(ROADMAP queue 1 item 11): {dm!r} is sharded over "
                   "{dm.grid!r}")

Range = Tuple[Tuple[int, int], Tuple[int, int]]


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


def block_ranges(grid: Grid, col_dist: Dist, row_dist: Dist, P: int,
                 Q: int) -> List[Range]:
    """The ((row0, row1), (col0, col1)) of the padded P x Q array that each
    position holds under [col_dist, row_dist] (the JAX NamedSharding cut)."""
    pa, pb = grid.parts(col_dist), grid.parts(row_dist)
    out = []
    for q in range(grid.size):
        a, b = grid.part(col_dist, q), grid.part(row_dist, q)
        out.append(((a * P // pa, (a + 1) * P // pa),
                    (b * Q // pb, (b + 1) * Q // pb)))
    return out


def cut_blocks(padded: torch.Tensor, grid: Grid, col_dist: Dist,
               row_dist: Dist) -> Tuple[torch.Tensor, ...]:
    """Each position's block of a padded global tensor, a fresh contiguous
    tensor on that position's device (the scatter of ``from_global``)."""
    P, Q = padded.shape
    out = []
    for q, ((r0, r1), (c0, c1)) in enumerate(
            block_ranges(grid, col_dist, row_dist, P, Q)):
        blk = torch.empty((r1 - r0, c1 - c0), dtype=padded.dtype,
                          device=grid.devices[q])
        out.append(blk.copy_(padded[r0:r1, c0:c1]))
    return tuple(out)


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


def _canonical_tensor(d: torch.Tensor, m: int, n: int,
                      grid: Grid) -> torch.Tensor:
    """``d`` sliced/zero-padded to the canonical padded shape for (m, n),
    with everything outside (m, n) zeroed."""
    pm, pn = padded_extent(m, grid), padded_extent(n, grid)
    if tuple(d.shape) == (pm, pn):
        return d
    d = d[: min(pm, d.shape[0]), : min(pn, d.shape[1])]
    if tuple(d.shape) != (pm, pn):
        full = d.new_zeros((pm, pn))
        full[: d.shape[0], : d.shape[1]] = d
        d = full
    return _mask(d, m, n, 0, 0)


def _mask(d: torch.Tensor, m: int, n: int, r0: int, c0: int) -> torch.Tensor:
    """Zero the entries of d (whose (0, 0) is global (r0, c0)) that lie
    outside the logical m x n region."""
    P, Q = d.shape
    i = torch.arange(r0, r0 + P, device=d.device)[:, None]
    j = torch.arange(c0, c0 + Q, device=d.device)[None, :]
    return torch.where((i < m) & (j < n), d,
                       torch.zeros((), dtype=d.dtype, device=d.device))


@dataclasses.dataclass(frozen=True)
class DistMatrix:
    """An m x n matrix: padded tensor(s) + distribution tags on a grid."""

    _data: Optional[torch.Tensor]
    m: int = 0
    n: int = 0
    col_dist: Dist = MC
    row_dist: Dist = MR
    grid: Optional[Grid] = None
    wrap: DistWrap = ELEMENT
    blocks: Optional[Tuple[torch.Tensor, ...]] = None

    def __post_init__(self):
        if self.grid is not None and self.grid.size > 1:
            if self.blocks is None or len(self.blocks) != self.grid.size:
                raise ValueError(
                    f"a DistMatrix on {self.grid!r} holds one block per "
                    "position: build it with from_global or from_padded")

    # ---- basic queries (reference: AbstractDistMatrix Height/Width/...) ----
    @property
    def sharded(self) -> bool:
        """True on a grid of size > 1 (the matrix is ``blocks``)."""
        return self.blocks is not None

    @property
    def data(self) -> torch.Tensor:
        """The padded tensor on a 1 x 1 grid; raises on a sharded matrix."""
        if self.blocks is not None:
            raise NotImplementedError(NOT_DISTRIBUTED.format(
                what="An operation on the global tensor", dm=self))
        return self._data

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
        if self.blocks is not None:
            return (padded_extent(self.m, self.grid),
                    padded_extent(self.n, self.grid))
        return tuple(self._data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return (self.blocks[0] if self.blocks is not None else self._data).dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def dist(self) -> Tuple[Dist, Dist]:
        return (self.col_dist, self.row_dist)

    def dist_name(self) -> str:
        return f"[{self.col_dist!r},{self.row_dist!r}]"

    def block_ranges(self) -> List[Range]:
        """The global ((row0, row1), (col0, col1)) of each position's block."""
        return block_ranges(self.grid, self.col_dist, self.row_dist,
                            *self.padded_shape)

    # ---- construction ----
    @staticmethod
    @trace.traced("core.from_global")
    def from_global(array, col_dist: Dist = MC, row_dist: Dist = MR,
                    grid: Optional[Grid] = None,
                    wrap: DistWrap = ELEMENT) -> "DistMatrix":
        """A DistMatrix holding the logical (m, n) array (numpy or torch),
        zero-padded and placed on the grid: on a 1 x 1 grid moved to its
        device, on a larger one cut into per-position blocks."""
        g = grid or Grid.default()
        if g.size == 1:
            arr = _as_tensor(array, g.device)
        else:
            arr = (array if isinstance(array, torch.Tensor)
                   else _as_tensor(array, torch.device("cpu")))
        if arr.dim() != 2:
            raise ValueError("DistMatrix is 2-D")
        m, n = arr.shape
        return DistMatrix.from_padded(pad_array(arr, g), m, n, col_dist,
                                      row_dist, g, wrap)

    @staticmethod
    def from_padded(data: torch.Tensor, m: int, n: int, col_dist: Dist = MC,
                    row_dist: Dist = MR, grid: Optional[Grid] = None,
                    wrap: DistWrap = ELEMENT) -> "DistMatrix":
        """Wrap an already grid-aligned tensor (padding must be zero). On a
        grid of size > 1 it is cut to the canonical shape, then into
        blocks."""
        g = grid or Grid.default()
        if g.size == 1:
            return DistMatrix(data.to(g.device), m, n, col_dist, row_dist, g,
                              wrap)
        g.check_pair(col_dist, row_dist)
        blocks = cut_blocks(_canonical_tensor(data, m, n, g), g, col_dist,
                            row_dist)
        return DistMatrix(None, m, n, col_dist, row_dist, g, wrap, blocks)

    @staticmethod
    def from_reference(data: np.ndarray, m: int, n: int, col_dist: Dist = MC,
                       row_dist: Dist = MR, grid: Optional[Grid] = None,
                       wrap: DistWrap = ELEMENT) -> "DistMatrix":
        """The port's DistMatrix for a JAX package DistMatrix, given its
        padded ``data`` read through numpy and its metadata. The reference
        pads to its own grid's quantum; the result is cut or padded to the
        port's canonical shape, and on a grid of size > 1 sharded as the
        JAX matrix is on a mesh of the same shape. Raises if the given
        padding is not zero."""
        g = grid or Grid.default()
        host = g.device if g.size == 1 else torch.device("cpu")
        full = DistMatrix(_as_tensor(data, host), m, n, col_dist, row_dist,
                          Grid(host), wrap)
        full.check_valid()
        if g.size == 1:
            return dataclasses.replace(full, grid=g).canonical()
        return DistMatrix.from_padded(full.data, m, n, col_dist, row_dist,
                                      g, wrap)

    def with_data(self, data: torch.Tensor, m: Optional[int] = None,
                  n: Optional[int] = None) -> "DistMatrix":
        """Same distribution/grid, new padded contents (1 x 1 grids)."""
        if self.blocks is not None:
            raise NotImplementedError(NOT_DISTRIBUTED.format(
                what="with_data", dm=self))
        return dataclasses.replace(
            self, _data=data, m=self.m if m is None else m,
            n=self.n if n is None else n)

    def with_blocks(self, blocks, m: Optional[int] = None,
                    n: Optional[int] = None) -> "DistMatrix":
        """Same distribution/grid, new per-position blocks."""
        return dataclasses.replace(
            self, blocks=tuple(blocks), m=self.m if m is None else m,
            n=self.n if n is None else n)

    def canonical(self) -> "DistMatrix":
        """Slice/pad ``data`` to the canonical padded shape for (m, n). A
        sharded matrix is canonical by construction."""
        if self.blocks is not None:
            return self
        d = _canonical_tensor(self._data, self.m, self.n, self.grid)
        return self if d is self._data else self.with_data(d)

    def mask_like(self, data: torch.Tensor) -> torch.Tensor:
        """Zero entries outside the logical (m, n) region of ``data``
        (shape-agnostic variant of mask_padding)."""
        return _mask(data, self.m, self.n, 0, 0)

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
        """B = A as [col_dist, row_dist], through ``redistribute.Copy``: on
        a 1 x 1 grid a re-tag, on a larger one the data movement."""
        from .redistribute import Copy

        return Copy(self, col_dist, row_dist)

    def check_valid(self) -> None:
        """Validate the library invariant: the padding region is
        identically zero (on every block of a sharded matrix)."""
        if self.blocks is None:
            parts = [(self._data, 0, 0)]
        else:
            parts = [(b, r0, c0) for b, ((r0, _), (c0, _))
                     in zip(self.blocks, self.block_ranges())]
        bad = 0.0
        for d, r0, c0 in parts:
            inside = _mask(torch.ones_like(d, dtype=torch.bool), self.m,
                           self.n, r0, c0)
            bad += float(torch.sum(torch.abs(torch.where(
                inside, torch.zeros((), dtype=d.dtype, device=d.device), d))))
        if bad != 0:
            raise AssertionError(
                f"DistMatrix padding invariant violated: |pad| sum = {bad}")

    # ---- materialisation ----
    @trace.traced("core.replicated")
    def replicated(self) -> torch.Tensor:
        """The padded data as every process sees it ([*,*]): on a 1 x 1
        grid the data itself; on a larger one an explicit AllGather, and
        position (0, 0)'s copy."""
        if self.blocks is None:
            return self._data
        from .redistribute import AllGather

        return AllGather(self).blocks[0]

    def global_array(self) -> np.ndarray:
        """The logical matrix as a host numpy array (bfloat16 comes back as
        float32, which numpy can hold); on a grid of size > 1 through an
        explicit AllGather."""
        d = self.replicated()[: self.m, : self.n]
        if d.dtype == torch.bfloat16:
            d = d.float()
        return d.cpu().resolve_conj().numpy()

    def __repr__(self) -> str:
        return (f"DistMatrix({self.m}x{self.n}, {self.dist_name()}, "
                f"{self.dtype}, grid={self.grid}, "
                f"padded={tuple(self.padded_shape)})")


def check_same_grid(*mats: DistMatrix) -> Grid:
    """Conformality check (reference: EL_DEBUG_ONLY AssertSameGrids)."""
    g = mats[0].grid
    for m in mats[1:]:
        if m.grid != g:
            raise ValueError("DistMatrices live on different grids")
    return g
