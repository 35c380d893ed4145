"""Collectives between the positions of a grid.

The JAX package never writes a collective: XLA emits them behind
``apply_sharding`` (``elementalx/core/dmatrix.py:66-77``) and inside
``shard_map`` bodies (all_gather, psum, psum_scatter, ppermute). The port
has no SPMD partitioner, so these helpers are those collectives, written
out over grid-indexed blocks: ``blocks[q]`` is position q's tensor (q in
mc-major order), on ``grid.devices[q]``.

Every helper moves real tensors between positions: a device-local copy
where both positions share a device (a virtual grid), ``.to(device)``
across devices. A position never copies what it already holds. Each adds
the bytes it moved to ``moved`` under its own name, which the tests and
``chip_smoke.py`` read (``reset()``, ``bytes_moved()``).

Axes are the grid's communicators (``Grid.group``): 'mc' (a grid column),
'mr' (a grid row), 'vc' and 'vr' (every position, mc- or mr-major); or a
function from a position to its group, for the axes of a mesh reshaped
over the same positions (Gemm3D's depth axis).
"""

from __future__ import annotations

import collections
from typing import Callable, List, Sequence, Union

import torch

from .grid import Grid

#: a grid axis name, or a function from a position to its group
Axis = Union[str, Callable[[int], List[int]]]

#: bytes moved between positions, by helper name
moved: collections.Counter = collections.Counter()


def reset() -> None:
    moved.clear()


def bytes_moved() -> int:
    return sum(moved.values())


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def send(x: torch.Tensor, device: torch.device, kind: str) -> torch.Tensor:
    """A copy of x on ``device``, counted under ``kind``: the one transfer
    every other helper is built on."""
    moved[kind] += _nbytes(x)
    if x.device == device:
        return x.clone()
    return x.to(device)


def put(dst: torch.Tensor, src: torch.Tensor, kind: str) -> None:
    """dst.copy_(src) where src lies at another position, counted under
    ``kind``."""
    moved[kind] += _nbytes(src)
    dst.copy_(src)


def transfer(x: torch.Tensor, grid: Grid, src: int, dst: int,
             kind: str) -> torch.Tensor:
    """x, held at position src, as a tensor at position dst (x itself when
    src == dst)."""
    if src == dst:
        return x
    return send(x, grid.devices[dst], kind)


def _group(grid: Grid, axis: Axis, q: int) -> List[int]:
    return axis(q) if callable(axis) else grid.group(axis, q)


def _first(x: torch.Tensor, own: bool) -> torch.Tensor:
    """The first term of a sum: a fresh tensor to accumulate into (a
    position's own block is copied, a transferred one already is one)."""
    return x.clone() if own else x


def all_gather(blocks: Sequence[torch.Tensor], grid: Grid, axis: Axis,
               dim: int) -> List[torch.Tensor]:
    """Each position gets its group's blocks concatenated along ``dim`` in
    the axis's order (jax.lax.all_gather(..., tiled=True))."""
    out = []
    for q in range(grid.size):
        group = _group(grid, axis, q)
        parts = [blocks[g] for g in group]
        shape = list(parts[0].shape)
        shape[dim] = sum(p.shape[dim] for p in parts)
        full = torch.empty(shape, dtype=parts[0].dtype,
                           device=grid.devices[q])
        off = 0
        for g, p in zip(group, parts):
            piece = full.narrow(dim, off, p.shape[dim])
            if g == q:
                piece.copy_(p)
            else:
                put(piece, p, "all_gather")
            off += p.shape[dim]
        out.append(full)
    return out


def psum(blocks: Sequence[torch.Tensor], grid: Grid,
         axis: Axis) -> List[torch.Tensor]:
    """Each position gets the sum of its group's blocks, added in the
    axis's order, so every member holds the same bits (jax.lax.psum)."""
    out = []
    for q in range(grid.size):
        acc = None
        for g in _group(grid, axis, q):
            x = transfer(blocks[g], grid, g, q, "psum")
            acc = _first(x, g == q) if acc is None else acc.add_(x)
        out.append(acc)
    return out


def psum_scatter(blocks: Sequence[torch.Tensor], grid: Grid, axis: Axis,
                 dim: int) -> List[torch.Tensor]:
    """The member at index k of a group gets the k-th of its group's
    equal slices along ``dim``, summed over the group
    (jax.lax.psum_scatter(..., tiled=True))."""
    out = []
    for q in range(grid.size):
        group = _group(grid, axis, q)
        k = group.index(q)
        w = blocks[q].shape[dim] // len(group)
        acc = None
        for g in group:
            x = transfer(blocks[g].narrow(dim, k * w, w), grid, g, q,
                         "psum_scatter")
            acc = _first(x, g == q) if acc is None else acc.add_(x)
        out.append(acc)
    return out


def permute(blocks: Sequence[torch.Tensor], grid: Grid,
            source: Callable[[int], int]) -> List[torch.Tensor]:
    """Position q gets the block of position source(q)
    (jax.lax.ppermute with any permutation)."""
    return [transfer(blocks[source(q)], grid, source(q), q, "ppermute")
            for q in range(grid.size)]


def ppermute(blocks: Sequence[torch.Tensor], grid: Grid, axis: Axis,
             shift: int) -> List[torch.Tensor]:
    """The member at index k of a group gets the block of the member at
    index (k + shift) mod n: shift 1 moves every block one step towards
    index 0 (jax.lax.ppermute with perm [(i, (i - 1) % n)])."""
    def source(q):
        group = _group(grid, axis, q)
        return group[(group.index(q) + shift) % len(group)]

    return permute(blocks, grid, source)


def broadcast(blocks: Sequence[torch.Tensor], grid: Grid, axis: Axis,
              owner: int) -> List[torch.Tensor]:
    """Every member of a group gets the block of the member at index
    ``owner`` of that group."""
    out = []
    for q in range(grid.size):
        src = _group(grid, axis, q)[owner]
        out.append(transfer(blocks[src], grid, src, q, "broadcast"))
    return out
