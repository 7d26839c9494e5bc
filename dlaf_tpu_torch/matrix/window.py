"""Windows at any element origin, copied out of and back into a matrix
(counterpart of ``dlaf_tpu/matrix/window.py``).

The JAX package realigns a window whose origin lies inside a tile by
neighbour ``ppermute`` shifts on each mesh axis (``_axis_extract``,
``_axis_update``).  Every rank of the port's grid lies on one device, so
the port copies by index on the stacked tensor instead: each element of
the window is read from, or written to, its owner's tile at its local
index, O(window) elements and no unpacking of the whole matrix.  Both are
pure copies, so the results are the JAX package's bit for bit.  Ranks on
several cards will need the ring form (ROADMAP.md §A, item 10).
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch.matrix import layout
from dlaf_tpu_torch.matrix.distribution import Distribution
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix


def _axis_index(dist: Distribution, axis: int, start: int, count: int, device):
    """(rank, local slot, element in the tile) of the global rows
    (``axis`` 0) or columns (1) ``start .. start + count - 1``."""
    blk = dist.block_size[axis]
    p = dist.grid_size[axis]
    src = dist.source_rank[axis]
    g = torch.arange(start, start + count, device=device)
    tile = g // blk
    return (tile + src) % p, tile // p, g % blk


def window_index(dist: Distribution, origin, size, device):
    """The stacked-tensor index of the window ``origin + size`` of a matrix
    of ``dist``: six broadcastable index tensors, ``x[window_index(...)]``
    being the window as a dense ``[m, n]`` tensor."""
    (rr, sr, er), (rc, sc, ec) = (_axis_index(dist, ax, origin[ax], size[ax], device)
                                  for ax in (0, 1))
    return rr[:, None], rc[None, :], sr[:, None], sc[None, :], er[:, None], ec[None, :]


def _check_bounds(mat: DistributedMatrix, origin, size) -> None:
    r0, c0 = origin
    m, n = size
    if r0 < 0 or c0 < 0 or r0 + m > mat.size.rows or c0 + n > mat.size.cols:
        raise ValueError(f"window {tuple(origin)}+{tuple(size)} out of bounds {tuple(mat.size)}")


def window_global(mat: DistributedMatrix, origin, size) -> torch.Tensor:
    """The window ``mat[r0:r0+m, c0:c0+n]`` as a dense tensor on the
    matrix's device (an index copy of the window's elements)."""
    origin = tuple(int(v) for v in origin)
    size = tuple(int(v) for v in size)
    _check_bounds(mat, origin, size)
    if not (size[0] and size[1]):
        return torch.zeros(size, dtype=mat.dtype, device=mat.data.device)
    return mat.data[window_index(mat.dist, origin, size, mat.data.device)]


def window_extract(mat: DistributedMatrix, origin, size) -> DistributedMatrix:
    """``mat[r0:r0+m, c0:c0+n]`` as a new matrix of source rank (0, 0) on
    the same grid and block size, at any element origin and any source
    rank of ``mat``."""
    origin = tuple(int(v) for v in origin)
    size = tuple(int(v) for v in size)
    _check_bounds(mat, origin, size)
    out_dist = Distribution(size, tuple(mat.dist.block_size), tuple(mat.dist.grid_size))
    if not all(DistributedMatrix.stacked_shape(out_dist)):
        return DistributedMatrix.zeros(mat.grid, size, tuple(mat.dist.block_size), mat.dtype)
    w = window_global(mat, origin, size)
    return DistributedMatrix(out_dist, mat.grid, layout.pack(layout.pad_global(w, out_dist),
                                                             out_dist))


def window_put(mat: DistributedMatrix, origin, w: torch.Tensor) -> DistributedMatrix:
    """Write the dense tensor ``w`` into ``mat``'s window at ``origin``, in
    place of ``mat``'s data; returns ``mat``."""
    origin = tuple(int(v) for v in origin)
    size = tuple(w.shape)
    _check_bounds(mat, origin, size)
    if size[0] and size[1]:
        mat.data[window_index(mat.dist, origin, size, mat.data.device)] = w.to(mat.dtype)
    return mat._inplace(mat.data)


def window_update(mat: DistributedMatrix, origin, win: DistributedMatrix) -> DistributedMatrix:
    """Write the matrix ``win`` into the window of ``mat`` at ``origin``
    (the write-through half of a view), in place of ``mat``'s data;
    elements outside the window keep their values.  Returns ``mat``."""
    if (tuple(win.grid.grid_size) != tuple(mat.grid.grid_size)
            or win.grid.device != mat.grid.device):
        raise ValueError("window_update: win and mat must live on the same grid")
    if tuple(win.dist.block_size) != tuple(mat.dist.block_size):
        raise ValueError("window_update: block sizes must match")
    _check_bounds(mat, tuple(int(v) for v in origin), tuple(win.size))
    return window_put(mat, origin, window_global(win, (0, 0), tuple(win.size)))
