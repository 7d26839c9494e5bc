"""Distributed matrix on a 2D grid (counterpart of
``dlaf_tpu/matrix/matrix.py``).

A matrix is ``Distribution`` + one stacked tensor
``data[Pr, Pc, ltr, ltc, mb, nb]`` on the grid's device, in the JAX
package's layout (``matrix/layout.py``).  The JAX package's algorithms
donate their input buffer and repoint the matrix at the result; the port's
algorithms update ``data`` in place where that saves memory and repoint it
the same way (:meth:`DistributedMatrix._inplace`).

:meth:`from_stacked` / :meth:`to_stacked` carry state across packages: the
first takes the JAX package's stacked array as numpy
(``np.asarray(jax_matrix.data)``), the second returns numpy in the same
layout.  :func:`carry` builds any pipeline stage's input from the JAX
package's numpy output (a stacked matrix with its distribution, or a bare
array such as ``taus`` or the compact band storage).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dlaf_tpu_torch.comm.grid import Grid
from dlaf_tpu_torch.common.index import Index2D, Size2D
from dlaf_tpu_torch.matrix import layout
from dlaf_tpu_torch.matrix.distribution import Distribution


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


class DistributedMatrix:
    """A dense ``m x n`` matrix, 2D block-cyclic over ``grid``.

    ``data[r, c, li, lj]`` is the ``mb x nb`` tile with global tile index
    ``dist.global_tile_from_local((li, lj), (r, c))``; slots past the edge
    are zero-padded."""

    def __init__(self, dist: Distribution, grid: Grid, data: torch.Tensor):
        if dist.grid_size != grid.grid_size:
            raise ValueError(f"distribution grid {dist.grid_size} != device grid {grid.grid_size}")
        expect = self.stacked_shape(dist)
        if tuple(data.shape) != expect:
            raise ValueError(f"data shape {tuple(data.shape)}, expected {expect}")
        if data.device != grid.device:
            raise ValueError(f"data on {data.device}, grid on {grid.device}")
        self.dist = dist
        self.grid = grid
        self.data = data

    # --- geometry -----------------------------------------------------------
    @staticmethod
    def stacked_shape(dist: Distribution):
        pr, pc = dist.grid_size
        ltr, ltc = dist.local_slots
        mb, nb = dist.block_size
        return (pr, pc, ltr, ltc, mb, nb)

    @property
    def size(self) -> Size2D:
        return self.dist.size

    @property
    def block_size(self) -> Size2D:
        return self.dist.block_size

    @property
    def nr_tiles(self) -> Size2D:
        return self.dist.nr_tiles

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    # --- constructors --------------------------------------------------------
    @classmethod
    def zeros(cls, grid: Grid, size, block_size, dtype=torch.float32) -> "DistributedMatrix":
        dist = Distribution(Size2D(*size), Size2D(*block_size), grid.grid_size)
        data = torch.zeros(cls.stacked_shape(dist), dtype=_torch_dtype(dtype), device=grid.device)
        return cls(dist, grid, data)

    @classmethod
    def from_global(cls, grid: Grid, a, block_size, source_rank=(0, 0)) -> "DistributedMatrix":
        """Distribute a global (m, n) numpy array or tensor (pads, packs,
        moves to the grid's device)."""
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        dist = Distribution(
            Size2D(*a.shape), Size2D(*block_size), grid.grid_size, Index2D(*source_rank)
        )
        x = layout.pack(layout.pad_global(a.to(grid.device), dist), dist)
        return cls(dist, grid, x)

    @classmethod
    def from_stacked(cls, x, dist: Distribution, grid: Grid) -> "DistributedMatrix":
        """Wrap a stacked ``[Pr, Pc, ltr, ltc, mb, nb]`` array (numpy, e.g.
        ``np.asarray(jax_matrix.data)``) as a matrix of this package.
        ``dist`` may be either package's ``Distribution``: its fields are
        copied into this package's."""
        dist = Distribution(Size2D(*dist.size), Size2D(*dist.block_size),
                            Size2D(*dist.grid_size), Index2D(*dist.source_rank))
        data = torch.from_numpy(np.array(x, copy=True)).to(grid.device)
        return cls(dist, grid, data)

    def to_stacked(self) -> np.ndarray:
        """The stacked tensor as numpy, in the JAX package's layout."""
        return self.data.detach().cpu().numpy()

    def like(self, data: Optional[torch.Tensor] = None) -> "DistributedMatrix":
        return DistributedMatrix(self.dist, self.grid, self.data if data is None else data)

    def astype(self, dtype) -> "DistributedMatrix":
        """Copy with the data cast to ``dtype``; always a fresh tensor."""
        return self.like(self.data.to(_torch_dtype(dtype), copy=True))

    def to_origin(self) -> "DistributedMatrix":
        """The same matrix under source rank (0, 0): the stacked tensor's two
        rank axes rolled by ``(-sr, -sc)``, so that global tile (0, 0) sits at
        rank (0, 0), where the distributed kernels expect it
        (``_spmd.Geometry``).  The JAX package relabels its mesh instead at
        no cost; every rank of the port shares one device, so the roll is
        one device copy of the matrix (the matrix itself when its source
        rank is (0, 0) already)."""
        sr, sc = self.dist.source_rank
        if (sr, sc) == (0, 0):
            return self
        dist0 = Distribution(self.dist.size, self.dist.block_size, self.dist.grid_size)
        return DistributedMatrix(dist0, self.grid, torch.roll(self.data, (-sr, -sc), (0, 1)))

    def with_source_rank(self, source_rank) -> "DistributedMatrix":
        """Inverse of :meth:`to_origin`: this origin-(0, 0) matrix under
        ``source_rank``, the rank axes rolled back (one device copy); the
        grid is the same (the JAX package relabels it)."""
        sr, sc = Index2D(*source_rank)
        if (sr, sc) == (0, 0):
            return self
        if tuple(self.dist.source_rank) != (0, 0):
            raise ValueError(f"with_source_rank: source rank {tuple(self.dist.source_rank)}, "
                             "expected (0, 0)")
        dist = Distribution(self.dist.size, self.dist.block_size, self.dist.grid_size,
                            Index2D(sr, sc))
        return DistributedMatrix(dist, self.grid, torch.roll(self.data, (sr, sc), (0, 1)))

    def _inplace(self, data: torch.Tensor) -> "DistributedMatrix":
        """Repoint this matrix at ``data`` (the algorithms' result) and
        return a fresh handle to the same tensor."""
        self.data = data
        return DistributedMatrix(self.dist, self.grid, data)

    # --- host-side access (tests / IO) ---------------------------------------
    def to_global(self) -> np.ndarray:
        """Gather the full matrix to a host numpy array."""
        g = layout.unpad_global(layout.unpack(self.data, self.dist), self.dist)
        return g.detach().cpu().numpy()

    def __repr__(self):
        return (
            f"DistributedMatrix({self.size.rows}x{self.size.cols}, "
            f"tiles {self.block_size.rows}x{self.block_size.cols}, grid {self.grid})"
        )


def carry(grid: Grid, x, dist=None):
    """A stage input of this package from the JAX package's numpy output:
    with ``dist``, the stacked array ``x`` as a :class:`DistributedMatrix`
    (the band matrix, an eigenvector matrix); without, ``x`` as a tensor on
    the grid's device (``taus``, the compact band storage).  The
    tridiagonal ``(d, e)`` is host numpy in both packages and needs no
    carrying."""
    if dist is not None:
        return DistributedMatrix.from_stacked(x, dist, grid)
    return torch.from_numpy(np.array(x, copy=True)).to(grid.device)
