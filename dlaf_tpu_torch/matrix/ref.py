"""Sub-matrix views (counterpart of ``dlaf_tpu/matrix/ref.py``).

A :class:`MatrixRef` records a rectangular window of a
:class:`DistributedMatrix` without copying it.  Consumers
(``general_sub_multiplication``) read the parent's stacked tile tensor
directly and restrict their tile loops to the window where the window is
tile aligned; other windows are copied out and back by ``matrix/window.py``
(an index copy of O(window) elements).
"""
from __future__ import annotations

from dataclasses import dataclass

from dlaf_tpu_torch.common.index import Index2D, Size2D
from dlaf_tpu_torch.matrix.distribution import Distribution
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix


@dataclass(frozen=True)
class MatrixRef:
    """A window of ``parent`` at any element ``origin``, of element extent
    ``size``."""

    parent: DistributedMatrix
    origin: Index2D
    size: Size2D

    def __init__(self, parent: DistributedMatrix, origin, size):
        origin = Index2D(*(int(v) for v in origin))
        size = Size2D(*(int(v) for v in size))
        if (origin.row < 0 or origin.col < 0 or origin.row + size.rows > parent.size.rows
                or origin.col + size.cols > parent.size.cols):
            raise ValueError(
                f"MatrixRef {tuple(origin)}+{tuple(size)} out of bounds {tuple(parent.size)}")
        object.__setattr__(self, "parent", parent)
        object.__setattr__(self, "origin", origin)
        object.__setattr__(self, "size", size)

    @property
    def aligned(self) -> bool:
        """True when the window shares the parent's tile grid: its origin on
        a tile boundary and each extent a tile multiple or reaching the
        parent's edge."""
        mb, nb = self.parent.block_size
        if self.origin.row % mb or self.origin.col % nb:
            return False
        for ext, blk, off, tot in ((self.size.rows, mb, self.origin.row, self.parent.size.rows),
                                   (self.size.cols, nb, self.origin.col, self.parent.size.cols)):
            if ext % blk and off + ext != tot:
                return False
        return True

    @property
    def block_size(self) -> Size2D:
        return self.parent.block_size

    @property
    def grid(self):
        return self.parent.grid

    @property
    def dtype(self):
        return self.parent.dtype

    @property
    def tile_origin(self) -> Index2D:
        """The first parent tile the window touches."""
        mb, nb = self.parent.block_size
        return Index2D(self.origin.row // mb, self.origin.col // nb)

    @property
    def nr_tiles(self) -> Size2D:
        mb, nb = self.parent.block_size
        return Size2D(-(-self.size.rows // mb), -(-self.size.cols // nb))

    @property
    def dist(self) -> Distribution:
        """The window's distribution when it is tile aligned: the parent's
        grid, its source rank the owner of the window's first tile."""
        return self.parent.dist.sub_distribution(tuple(self.origin), tuple(self.size))

    def materialize(self) -> DistributedMatrix:
        """The window copied out as a matrix of source rank (0, 0)."""
        from dlaf_tpu_torch.matrix import util as mutil

        return mutil.sub_matrix(self.parent, tuple(self.origin), tuple(self.size))


def as_ref(mat) -> MatrixRef:
    """A view of the whole matrix (a ref is returned as it is)."""
    if isinstance(mat, MatrixRef):
        return mat
    return MatrixRef(mat, (0, 0), tuple(mat.size))
