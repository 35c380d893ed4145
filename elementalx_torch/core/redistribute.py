"""The redistribution engine: the ``copy::`` layer.

Counterpart of ``elementalx/core/redistribute.py`` (reference:
include/El/blas_like/level1/Copy/, 25 headers). There every change of
distribution is a sharding re-annotation and XLA emits the collective;
here ``Copy`` moves the blocks itself.

Each position's target block is a rectangle of the padded global array
(``dmatrix.block_ranges``). ``Copy`` cuts it along the source blocks'
edges into pieces; a piece the position already holds is read in place,
and every other piece is copied from one position that holds it
(``collectives.put``, counted under "copy [U,V]->[W,X]", so the
counter shows what each redistribution moved). So a redistribution moves
only what the target layout needs: ColFilter, RowFilter, Filter,
PartialColFilter and Scatter move 0 bytes, and a target block that lies
inside the position's own source block is a view of it. On a 1 x 1 grid
every distribution holds the whole matrix, so ``Copy`` only re-tags.

The named paths keep the JAX package's dist-tag checks and go through
``Copy``, as the JAX ones go through one resharding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import torch

from . import collectives
from .dmatrix import DistMatrix, Range, block_ranges, padded_extent
from .grid import Grid
from .types import (
    CIRC,
    Collect,
    Dist,
    MC,
    MR,
    Partial,
    STAR,
    VC,
    VR,
)


def _cuts(lo: int, hi: int, edges: Sequence[int]) -> List[int]:
    return sorted({lo, hi} | {e for e in edges if lo < e < hi})


def assemble(src_blocks: Sequence[torch.Tensor], src_ranges: Sequence[Range],
             dst_ranges: Sequence[Range], dst_devices: Sequence[torch.device],
             local: Callable[[int, int], bool],
             kind: str = "copy") -> List[torch.Tensor]:
    """The target blocks (global rectangles ``dst_ranges``) from source
    blocks that hold ``src_ranges``. ``local(s, t)`` says whether source
    position s is target position t; a piece is read from t itself where
    it can be, else from the first holder on t's device, else from the
    first holder, and only the last two count as moved, under ``kind``."""
    row_edges = [e for (r, _) in src_ranges for e in r]
    col_edges = [e for (_, c) in src_ranges for e in c]
    out = []
    for t, ((r0, r1), (c0, c1)) in enumerate(dst_ranges):
        own = [s for s in range(len(src_ranges)) if local(s, t)]
        whole = [s for s in own
                 if src_ranges[s][0][0] <= r0 and r1 <= src_ranges[s][0][1]
                 and src_ranges[s][1][0] <= c0 and c1 <= src_ranges[s][1][1]]
        if whole:
            (sr, _), (sc, _) = src_ranges[whole[0]]
            out.append(src_blocks[whole[0]][r0 - sr:r1 - sr, c0 - sc:c1 - sc])
            continue
        dst = torch.empty((r1 - r0, c1 - c0), dtype=src_blocks[0].dtype,
                          device=dst_devices[t])
        rows, cols = _cuts(r0, r1, row_edges), _cuts(c0, c1, col_edges)
        for a0, a1 in zip(rows, rows[1:]):
            for b0, b1 in zip(cols, cols[1:]):
                holders = [s for s, ((sr0, sr1), (sc0, sc1))
                           in enumerate(src_ranges)
                           if sr0 <= a0 and a1 <= sr1
                           and sc0 <= b0 and b1 <= sc1]
                target = dst[a0 - r0:a1 - r0, b0 - c0:b1 - c0]
                if not holders:      # padding the source grid does not have
                    target.zero_()
                    continue
                mine = [s for s in holders if local(s, t)]
                near = [s for s in holders
                        if src_blocks[s].device == dst.device]
                s = (mine or near or holders)[0]
                (sr, _), (sc, _) = src_ranges[s]
                piece = src_blocks[s][a0 - sr:a1 - sr, b0 - sc:b1 - sc]
                if mine:
                    target.copy_(piece)
                else:
                    collectives.put(target, piece, kind)
        out.append(dst)
    return out


def Copy(A: DistMatrix, col_dist: Dist, row_dist: Dist) -> DistMatrix:
    """B = A with B distributed [col_dist, row_dist].

    General operator= dispatch (reference: ElementalMatrix::operator=,
    MC_MR.cpp:165-177)."""
    if (A.col_dist, A.row_dist) == (col_dist, row_dist):
        return A
    if A.grid is None:
        raise ValueError("DistMatrix has no grid")
    if not A.sharded:
        return dataclasses.replace(A, col_dist=col_dist, row_dist=row_dist)
    g = A.grid
    g.check_pair(col_dist, row_dist)
    dst = block_ranges(g, col_dist, row_dist, *A.padded_shape)
    blocks = assemble(A.blocks, A.block_ranges(), dst, g.devices,
                      lambda s, t: s == t,
                      f"copy {A.dist_name()}->[{col_dist!r},{row_dist!r}]")
    return dataclasses.replace(A, col_dist=col_dist, row_dist=row_dist,
                               blocks=tuple(blocks))


# ---------------------------------------------------------------------------
# Named redistribution paths. Each validates the dist-tag contract of its
# reference counterpart, then goes through Copy.
# ---------------------------------------------------------------------------


def ColAllGather(A: DistMatrix) -> DistMatrix:
    """[U,V] -> [Collect(U),V]: gather the column distribution
    (reference: Copy/ColAllGather.hpp:17-181)."""
    return Copy(A, Collect(A.col_dist), A.row_dist)


def RowAllGather(A: DistMatrix) -> DistMatrix:
    """[U,V] -> [U,Collect(V)] (reference: Copy/RowAllGather.hpp)."""
    return Copy(A, A.col_dist, Collect(A.row_dist))


def ColFilter(A: DistMatrix, col_dist: Dist) -> DistMatrix:
    """[STAR,V] -> [U,V]: keep only locally-owned rows, no communication
    (reference: Copy/ColFilter.hpp)."""
    if A.col_dist != STAR:
        raise ValueError("ColFilter requires a [STAR,V] source")
    return Copy(A, col_dist, A.row_dist)


def RowFilter(A: DistMatrix, row_dist: Dist) -> DistMatrix:
    """[U,STAR] -> [U,V] (reference: Copy/RowFilter.hpp)."""
    if A.row_dist != STAR:
        raise ValueError("RowFilter requires a [U,STAR] source")
    return Copy(A, A.col_dist, row_dist)


def PartialColAllGather(A: DistMatrix) -> DistMatrix:
    """[VC,V] -> [MC,V] / [VR,V] -> [MR,V]
    (reference: Copy/PartialColAllGather.hpp)."""
    return Copy(A, Partial(A.col_dist), A.row_dist)


def PartialRowAllGather(A: DistMatrix) -> DistMatrix:
    """[U,VC] -> [U,MC] / [U,VR] -> [U,MR]."""
    return Copy(A, A.col_dist, Partial(A.row_dist))


def PartialColFilter(A: DistMatrix, col_dist: Dist) -> DistMatrix:
    """[MC,V] -> [VC,V] etc. (reference: Copy/PartialColFilter.hpp)."""
    if Partial(col_dist) != A.col_dist:
        raise ValueError("PartialColFilter: target must refine the source")
    return Copy(A, col_dist, A.row_dist)


def ColAllToAllPromote(A: DistMatrix) -> DistMatrix:
    """[VC,STAR] -> [MC,MR] style promote via all-to-all
    (reference: Copy/ColAllToAllPromote.hpp, used by MC_MR.cpp:111-147)."""
    if A.col_dist == VC:
        return Copy(A, MC, MR)
    if A.col_dist == VR:
        return Copy(A, MR, MC)
    raise ValueError("ColAllToAllPromote requires a [VC/VR,*] source")


def ColAllToAllDemote(A: DistMatrix) -> DistMatrix:
    """[MC,MR] -> [VC,STAR] style demote (reference: Copy/ColAllToAllDemote.hpp)."""
    if (A.col_dist, A.row_dist) == (MC, MR):
        return Copy(A, VC, STAR)
    if (A.col_dist, A.row_dist) == (MR, MC):
        return Copy(A, VR, STAR)
    raise ValueError("ColAllToAllDemote requires [MC,MR] or [MR,MC]")


def Exchange(A: DistMatrix) -> DistMatrix:
    """[MC,MR] <-> [MR,MC] pairwise exchange
    (reference: Copy/Exchange.hpp, MC_MR.cpp:64-83)."""
    pairs = {(MC, MR): (MR, MC), (MR, MC): (MC, MR), (VC, STAR): (VR, STAR),
             (VR, STAR): (VC, STAR), (STAR, VC): (STAR, VR),
             (STAR, VR): (STAR, VC)}
    tgt = pairs.get((A.col_dist, A.row_dist))
    if tgt is None:
        raise ValueError(f"Exchange undefined for {A.dist_name()}")
    return Copy(A, *tgt)


def TransposeDist(A: DistMatrix) -> DistMatrix:
    """[U,V] -> [V,U] of the same matrix (reference: Copy/TransposeDist.hpp)."""
    return Copy(A, A.row_dist, A.col_dist)


def AllGather(A: DistMatrix) -> DistMatrix:
    """[U,V] -> [*,*] full replication (reference: Copy/AllGather.hpp)."""
    return Copy(A, STAR, STAR)


def Filter(A: DistMatrix, col_dist: Dist, row_dist: Dist) -> DistMatrix:
    """[*,*] -> [U,V] (reference: Copy/Filter.hpp)."""
    if (A.col_dist, A.row_dist) != (STAR, STAR):
        raise ValueError("Filter requires a [*,*] source")
    return Copy(A, col_dist, row_dist)


def Gather(A: DistMatrix) -> DistMatrix:
    """[U,V] -> [CIRC,CIRC]: everything to the root (reference:
    Copy/Gather.hpp). Physically replicated here, as in the JAX package:
    the root distinction has no meaning with a single controller."""
    return Copy(A, CIRC, CIRC)


def Scatter(A: DistMatrix, col_dist: Dist = MC, row_dist: Dist = MR) -> DistMatrix:
    """[CIRC,CIRC] -> [U,V] (reference: Copy/Scatter.hpp)."""
    if (A.col_dist, A.row_dist) != (CIRC, CIRC):
        raise ValueError("Scatter requires a [CIRC,CIRC] source")
    return Copy(A, col_dist, row_dist)


def Translate(A: DistMatrix) -> DistMatrix:
    """Alignment translation (reference: Copy/Translate.hpp). The JAX
    layout has no alignments, so this is the identity."""
    return A


def TranslateBetweenGrids(A: DistMatrix, grid: Grid,
                          col_dist: Dist = MC, row_dist: Dist = MR) -> DistMatrix:
    """Copy a matrix onto a *different* grid (reference:
    Copy/TranslateBetweenGrids.hpp:18-369, tested by
    tests/core/DifferentGrids.cpp). Every piece moves between the grids,
    so all of it counts as moved; padding rows and columns that the new
    grid adds are zero."""
    if grid == A.grid:
        return Copy(A, col_dist, row_dist)
    grid.check_pair(col_dist, row_dist)
    A = A.canonical()
    dst = block_ranges(grid, col_dist, row_dist, padded_extent(A.m, grid),
                       padded_extent(A.n, grid))
    out = assemble(A.blocks if A.sharded else (A.data,), A.block_ranges(),
                   dst, grid.devices, lambda s, t: False,
                   "TranslateBetweenGrids")
    if grid.size == 1:
        return DistMatrix(out[0], A.m, A.n, col_dist, row_dist, grid, A.wrap)
    return DistMatrix(None, A.m, A.n, col_dist, row_dist, grid, A.wrap,
                      tuple(out))
