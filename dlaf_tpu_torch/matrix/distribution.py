"""2D block-cyclic distribution index algebra.

A verbatim copy of ``dlaf_tpu/matrix/distribution.py`` (pure Python, no
framework): the port keeps its own copy so it never imports the JAX
package.  Analogue of ``dlaf::matrix::Distribution``
(reference: include/dlaf/matrix/distribution.h:115-1058 and
misc/matrix_distribution.md).  This is pure host-side Python bookkeeping: it
maps global tile/element indices to (grid rank, local tile slot) and back.
On device, the matrix lives as a stacked local-tile array
``[Pr, Pc, ltr, ltc, mb, nb]`` sharded over a 2D mesh (see matrix.py); the
block-cyclic cyclic re-indexing is this class's job, exactly as the reference
layers ``Distribution`` over flat per-rank memory.

Differences from the reference (by design, not omission):
  * tile_size == block_size (the reference allows tiles subdividing blocks;
    we provide retiling at the matrix level instead, distribution.h:121-130).
  * global element/tile offsets are supported via ``source_rank``; arbitrary
    element offsets inside a tile are not (reference ``GlobalElementIndex
    offset`` ctor) — sub-views handle that case (views.py).
"""
from __future__ import annotations

from dataclasses import dataclass

from dlaf_tpu_torch.common.index import Index2D, Size2D, ceil_div


def _owner_1d(global_tile: int, src: int, grid: int) -> int:
    """Rank owning this global tile along one dimension (util_distribution.h)."""
    return (global_tile + src) % grid


def _local_tile_1d(global_tile: int, grid: int) -> int:
    return global_tile // grid


def _global_tile_1d(local_tile: int, rank: int, src: int, grid: int) -> int:
    return local_tile * grid + (rank - src) % grid


def _next_local_tile_1d(global_tile: int, rank: int, src: int, grid: int) -> int:
    """Local index of ``global_tile`` if owned by ``rank``, else of the next
    global tile > ``global_tile`` owned by ``rank``
    (reference: next_local_tile_from_global_tile, util_distribution.h)."""
    owner = _owner_1d(global_tile, src, grid)
    if owner == rank:
        return global_tile // grid
    # distance from global_tile to the next tile owned by rank
    dist = (rank - owner) % grid
    return (global_tile + dist) // grid


def _local_nr_tiles_1d(nr_tiles: int, rank: int, src: int, grid: int) -> int:
    return _next_local_tile_1d(nr_tiles, rank, src, grid)


@dataclass(frozen=True)
class Distribution:
    """Block-cyclic map of an ``m x n`` matrix tiled in ``mb x nb`` tiles over
    a ``Pr x Pc`` grid, source rank ``(sr, sc)``.

    All methods are per-coordinate pairs over (row, col); rank arguments are
    explicit so the same object serves SPMD code on every rank (the reference
    instead stores ``rank_index`` per process, distribution.h:137)."""

    size: Size2D
    block_size: Size2D
    grid_size: Size2D = Size2D(1, 1)
    source_rank: Index2D = Index2D(0, 0)

    def __post_init__(self):
        object.__setattr__(self, "size", Size2D(*self.size))
        object.__setattr__(self, "block_size", Size2D(*self.block_size))
        object.__setattr__(self, "grid_size", Size2D(*self.grid_size))
        object.__setattr__(self, "source_rank", Index2D(*self.source_rank))
        if self.size.rows < 0 or self.size.cols < 0:
            raise ValueError(f"negative size {self.size}")
        if self.block_size.rows <= 0 or self.block_size.cols <= 0:
            raise ValueError(f"non-positive block size {self.block_size}")
        if not self.source_rank.is_in(self.grid_size):
            raise ValueError(f"source rank {self.source_rank} not in grid {self.grid_size}")

    # --- global tile grid ---------------------------------------------------
    @property
    def nr_tiles(self) -> Size2D:
        return Size2D(
            ceil_div(self.size.rows, self.block_size.rows),
            ceil_div(self.size.cols, self.block_size.cols),
        )

    def tile_size_of(self, gt: Index2D) -> Size2D:
        """Actual (possibly ragged last) size of global tile ``gt``."""
        gt = Index2D(*gt)
        nt = self.nr_tiles
        rows = (
            self.size.rows - gt.row * self.block_size.rows
            if gt.row == nt.rows - 1
            else self.block_size.rows
        )
        cols = (
            self.size.cols - gt.col * self.block_size.cols
            if gt.col == nt.cols - 1
            else self.block_size.cols
        )
        return Size2D(rows, cols)

    # --- element <-> tile ---------------------------------------------------
    def global_tile_index(self, ge: Index2D) -> Index2D:
        return Index2D(ge[0] // self.block_size.rows, ge[1] // self.block_size.cols)

    def tile_element_index(self, ge: Index2D) -> Index2D:
        return Index2D(ge[0] % self.block_size.rows, ge[1] % self.block_size.cols)

    def global_element_index(self, gt: Index2D, el: Index2D) -> Index2D:
        return Index2D(
            gt[0] * self.block_size.rows + el[0], gt[1] * self.block_size.cols + el[1]
        )

    # --- ownership ----------------------------------------------------------
    def rank_global_tile(self, gt: Index2D) -> Index2D:
        """Grid rank owning global tile ``gt`` (distribution.h rank_global_tile)."""
        return Index2D(
            _owner_1d(gt[0], self.source_rank.row, self.grid_size.rows),
            _owner_1d(gt[1], self.source_rank.col, self.grid_size.cols),
        )

    def rank_global_element(self, ge: Index2D) -> Index2D:
        return self.rank_global_tile(self.global_tile_index(ge))

    # --- global tile <-> local tile -----------------------------------------
    def local_tile_index(self, gt: Index2D) -> Index2D:
        """Local slot of ``gt`` on its owner rank."""
        return Index2D(
            _local_tile_1d(gt[0], self.grid_size.rows),
            _local_tile_1d(gt[1], self.grid_size.cols),
        )

    def global_tile_from_local(self, lt: Index2D, rank: Index2D) -> Index2D:
        return Index2D(
            _global_tile_1d(lt[0], rank[0], self.source_rank.row, self.grid_size.rows),
            _global_tile_1d(lt[1], rank[1], self.source_rank.col, self.grid_size.cols),
        )

    def next_local_tile_from_global_tile(self, gt: Index2D, rank: Index2D) -> Index2D:
        return Index2D(
            _next_local_tile_1d(gt[0], rank[0], self.source_rank.row, self.grid_size.rows),
            _next_local_tile_1d(gt[1], rank[1], self.source_rank.col, self.grid_size.cols),
        )

    def local_nr_tiles(self, rank: Index2D) -> Size2D:
        nt = self.nr_tiles
        return Size2D(
            _local_nr_tiles_1d(nt.rows, rank[0], self.source_rank.row, self.grid_size.rows),
            _local_nr_tiles_1d(nt.cols, rank[1], self.source_rank.col, self.grid_size.cols),
        )

    def local_size(self, rank: Index2D) -> Size2D:
        """Local element extent on ``rank`` (sum of owned tile sizes)."""
        rows = sum(
            self.tile_size_of(Index2D(self.global_tile_from_local((lt, 0), (rank[0], 0)).row, 0)).rows
            for lt in range(self.local_nr_tiles(rank).rows)
        )
        cols = sum(
            self.tile_size_of(Index2D(0, self.global_tile_from_local((0, lt), (0, rank[1])).col)).cols
            for lt in range(self.local_nr_tiles(rank).cols)
        )
        return Size2D(rows, cols)

    # --- padded stacked-storage geometry (TPU-specific) ----------------------
    @property
    def local_slots(self) -> Size2D:
        """Per-rank local tile-stack extent, identical on every rank: the
        device array is ``[Pr, Pc, ltr, ltc, mb, nb]`` with uniform ltr/ltc
        (max over ranks), padding slots zero-filled.  This uniformity is what
        lets block-cyclic live on top of XLA's even sharding (SURVEY §7)."""
        nt = self.nr_tiles
        return Size2D(
            ceil_div(nt.rows, self.grid_size.rows), ceil_div(nt.cols, self.grid_size.cols)
        )

    @property
    def padded_size(self) -> Size2D:
        """Global element extent after padding to full uniform tile slots."""
        s = self.local_slots
        return Size2D(
            s.rows * self.grid_size.rows * self.block_size.rows,
            s.cols * self.grid_size.cols * self.block_size.cols,
        )

    # --- sub-distribution (reference SubDistributionSpec, distribution.h:64) --
    def sub_distribution(self, origin: Index2D, size: Size2D) -> "Distribution":
        """Distribution of the tile-aligned sub-matrix starting at global
        *element* ``origin`` (must be tile-aligned) of element extent ``size``."""
        origin = Index2D(*origin)
        size = Size2D(*size)
        if origin.row % self.block_size.rows or origin.col % self.block_size.cols:
            raise ValueError(f"sub-distribution origin {origin} not tile aligned")
        if origin.row + size.rows > self.size.rows or origin.col + size.cols > self.size.cols:
            raise ValueError("sub-distribution out of bounds")
        gt = self.global_tile_index(origin)
        new_src = self.rank_global_tile(gt)
        return Distribution(size, self.block_size, self.grid_size, new_src)
