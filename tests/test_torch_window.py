"""The port's ``MatrixRef`` (``dlaf_tpu_torch/matrix/ref.py``) and the
window copies at any element origin (``matrix/window.py``) against the JAX
package's, on CPU grids of rank threads of the JAX fixture's six shapes,
with the windows of ``tests/test_window.py`` on a 24 x 24 matrix of tiles
8 x 8 (and 8 x 4).

The copies move values unchanged, so every result is held bit for bit to
the JAX package's stacked array (layout, padding and source rank
included).  Source ranks (0, 0) and (1, 2) (mod the grid) both, as the
port indexes each element at its owner's local slot whatever the source
rank.
"""
import jax
import numpy as np
import pytest

import dlaf_tpu as dt
import dlaf_tpu.testing as tu
from dlaf_tpu.matrix.ref import MatrixRef as JRef
from dlaf_tpu.matrix.ref import as_ref as j_as_ref
from dlaf_tpu.matrix.window import window_extract as j_extract
from dlaf_tpu.matrix.window import window_update as j_update
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.matrix.ref import MatrixRef, as_ref
from dlaf_tpu_torch.matrix.window import window_extract, window_update
from dlaf_tpu_torch.testing import GRID_SHAPES, grid_like

# origins and sizes: aligned, off the tile grid on both axes, in-tile
# offsets, ragged edges, one element, the whole matrix
WINDOWS = [
    ((0, 0), (24, 24)),
    ((8, 16), (16, 8)),
    ((3, 5), (13, 11)),
    ((9, 0), (15, 17)),
    ((1, 1), (1, 1)),
    ((17, 23), (7, 1)),
]


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_state():
    yield
    jax.clear_caches()


def _jgrid(comm_grids, shape):
    return next(g for g in comm_grids if tuple(g.grid_size) == tuple(shape))


def _src(shape):
    return (1 % shape[0], 2 % shape[1])


def _pair(comm_grids, shape, a, block, src=(0, 0)):
    jm = dt.DistributedMatrix.from_global(_jgrid(comm_grids, shape), a, block, source_rank=src)
    tm = DistributedMatrix.from_stacked(np.asarray(jm.data), jm.dist, grid_like(shape))
    return jm, tm


def _same(jm, tm):
    assert tuple(tm.dist.size) == tuple(jm.dist.size)
    assert tuple(tm.dist.source_rank) == tuple(jm.dist.source_rank)
    np.testing.assert_array_equal(tm.to_stacked(), np.asarray(jm.data))


@pytest.mark.parametrize("origin,size", [((8, 4), (12, 16)), ((3, 0), (8, 8)), ((0, 0), (6, 8)),
                                         ((12, 16), (12, 4)), ((0, 0), (24, 20))])
def test_matrix_ref_geometry_like_jax(comm_grids, origin, size):
    _, tm = _pair(comm_grids, (2, 4), tu.random_matrix(24, 20, np.float64, seed=0), (4, 4))
    jm = dt.DistributedMatrix.from_global(_jgrid(comm_grids, (2, 4)), tm.to_global(), (4, 4))
    jr, tr = JRef(jm, origin, size), MatrixRef(tm, origin, size)
    assert tr.aligned == jr.aligned
    for attr in ("origin", "size", "block_size", "tile_origin", "nr_tiles"):
        assert tuple(getattr(tr, attr)) == tuple(getattr(jr, attr)), attr
    assert tr.grid is tm.grid and tr.dtype == tm.dtype
    if jr.aligned:
        for attr in ("size", "block_size", "grid_size", "source_rank"):
            assert tuple(getattr(tr.dist, attr)) == tuple(getattr(jr.dist, attr)), attr
    _same(jr.materialize(), tr.materialize())
    assert as_ref(tr) is tr
    assert tuple(as_ref(tm).size) == tuple(j_as_ref(jm).size) == (24, 20)
    with pytest.raises(ValueError):
        MatrixRef(tm, (16, 16), (12, 8))
    with pytest.raises(ValueError):
        JRef(jm, (16, 16), (12, 8))


@pytest.mark.parametrize("shape", GRID_SHAPES)
@pytest.mark.parametrize("origin,size", WINDOWS)
def test_window_extract_like_jax(comm_grids, shape, origin, size):
    a = tu.random_matrix(24, 24, np.float64, seed=1)
    for src in {(0, 0), _src(shape)}:
        jm, tm = _pair(comm_grids, shape, a, (8, 8), src)
        got = window_extract(tm, origin, size)
        _same(j_extract(jm, origin, size), got)
        np.testing.assert_array_equal(got.to_global(), a[origin[0]:origin[0] + size[0],
                                                         origin[1]:origin[1] + size[1]])


@pytest.mark.parametrize("shape", GRID_SHAPES)
@pytest.mark.parametrize("origin,size", WINDOWS)
def test_window_update_like_jax(comm_grids, shape, origin, size):
    a = tu.random_matrix(24, 24, np.float64, seed=2)
    w = tu.random_matrix(size[0], size[1], np.float64, seed=3)
    for src in {(0, 0), _src(shape)}:
        jm, tm = _pair(comm_grids, shape, a, (8, 8), src)
        jw, tw = _pair(comm_grids, shape, w, (8, 8))
        before = tm.data
        got = window_update(tm, origin, tw)
        _same(j_update(jm, origin, jw), got)
        assert got.data is tm.data is before  # in place of the parent's tensor
        want = a.copy()
        want[origin[0]:origin[0] + size[0], origin[1]:origin[1] + size[1]] = w
        np.testing.assert_array_equal(tm.to_global(), want)


def test_window_roundtrip_nonsquare_blocks_and_win_source_rank(comm_grids):
    a = tu.random_matrix(30, 22, np.float32, seed=4)
    jm, tm = _pair(comm_grids, (2, 4), a, (8, 4))
    _same(j_extract(jm, (5, 3), (19, 14)), window_extract(tm, (5, 3), (19, 14)))
    w = tu.random_matrix(19, 14, np.float32, seed=5)
    jw, tw = _pair(comm_grids, (2, 4), w, (8, 4), (1, 3))
    _same(j_update(jm, (5, 3), jw), window_update(tm, (5, 3), tw))


def test_window_update_refuses_other_grids_and_blocks():
    tm = DistributedMatrix.from_global(grid_like((2, 4)), np.zeros((24, 24)), (8, 8))
    with pytest.raises(ValueError, match="grid"):
        window_update(tm, (0, 0), DistributedMatrix.from_global(grid_like((4, 2)),
                                                                np.ones((8, 8)), (8, 8)))
    with pytest.raises(ValueError, match="block"):
        window_update(tm, (0, 0), DistributedMatrix.from_global(tm.grid, np.ones((8, 8)),
                                                                (4, 4)))
    with pytest.raises(ValueError, match="out of bounds"):
        window_extract(tm, (20, 0), (8, 8))
