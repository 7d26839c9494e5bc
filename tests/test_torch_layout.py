"""The port's data model against the JAX package's: block-cyclic
distribution algebra, pack/unpack/pad, bucketed segments, and the
stacked-state carry-across (``DistributedMatrix.from_stacked`` /
``to_stacked``).  The algebra is pure, so grid shapes beyond 1x1 are
checked too; comparisons are exact (integers and copies)."""
import jax
import numpy as np
import pytest

import dlaf_tpu.testing as tu
from dlaf_tpu.algorithms import _spmd as jspmd
from dlaf_tpu.matrix import layout as jlayout
from dlaf_tpu.matrix.distribution import Distribution as JDist
from dlaf_tpu.matrix.matrix import DistributedMatrix as JMatrix
from dlaf_tpu_torch.algorithms import _spmd as tspmd
from dlaf_tpu_torch.comm.grid import Grid as TGrid
from dlaf_tpu_torch.matrix import layout as tlayout
from dlaf_tpu_torch.matrix.distribution import Distribution as TDist
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix as TMatrix

# (size, block, grid, source rank)
CASES = [
    ((64, 64), (16, 16), (1, 1), (0, 0)),
    ((100, 37), (16, 8), (2, 3), (1, 2)),
    ((7, 130), (4, 32), (3, 2), (0, 1)),
    ((192, 192), (32, 32), (2, 4), (1, 3)),
    ((0, 5), (3, 3), (2, 2), (0, 0)),
    ((33, 33), (33, 33), (1, 2), (0, 1)),
]


@pytest.mark.parametrize("size,block,grid,src", CASES)
def test_distribution_matches_jax(size, block, grid, src):
    jd, td = JDist(size, block, grid, src), TDist(size, block, grid, src)
    for prop in ("nr_tiles", "local_slots", "padded_size", "size", "block_size"):
        assert tuple(getattr(td, prop)) == tuple(getattr(jd, prop)), prop
    nt = jd.nr_tiles
    for r in range(grid[0]):
        for c in range(grid[1]):
            assert td.local_nr_tiles((r, c)) == jd.local_nr_tiles((r, c))
            assert td.local_size((r, c)) == jd.local_size((r, c))
    for i in range(nt.rows):
        for j in range(nt.cols):
            gt = (i, j)
            assert td.rank_global_tile(gt) == jd.rank_global_tile(gt)
            assert td.local_tile_index(gt) == jd.local_tile_index(gt)
            assert td.tile_size_of(gt) == jd.tile_size_of(gt)
            rank = jd.rank_global_tile(gt)
            lt = jd.local_tile_index(gt)
            assert td.global_tile_from_local(lt, rank) == jd.global_tile_from_local(lt, rank)
            assert (td.next_local_tile_from_global_tile(gt, (0, 0))
                    == jd.next_local_tile_from_global_tile(gt, (0, 0)))


@pytest.mark.parametrize("size,block,grid,src", CASES)
def test_pack_unpack_match_jax(size, block, grid, src):
    import torch

    a = np.arange(size[0] * size[1], dtype=np.float64).reshape(size) + 1.0
    jd, td = JDist(size, block, grid, src), TDist(size, block, grid, src)
    jpad = jlayout.pad_global(a, jd)
    jx = jlayout.pack(jpad, jd)
    # numpy in, numpy out
    np.testing.assert_array_equal(tlayout.pad_global(a, td), jpad)
    np.testing.assert_array_equal(tlayout.pack(tlayout.pad_global(a, td), td), jx)
    # torch in, torch out
    tx = tlayout.pack(tlayout.pad_global(torch.from_numpy(a), td), td)
    np.testing.assert_array_equal(tx.numpy(), jx)
    back = tlayout.unpad_global(tlayout.unpack(tx, td), td)
    np.testing.assert_array_equal(back.numpy(), a)
    np.testing.assert_array_equal(tlayout.unpack(jx, td), jlayout.unpack(jx, jd))


@pytest.mark.parametrize("ratio", [None, 2.0, 1.414, 1.0])
@pytest.mark.parametrize("n", [1, 5, 32, 100])
def test_halving_segments_match_jax(n, ratio):
    assert tspmd.halving_segments(n, ratio) == jspmd.halving_segments(n, ratio)


@pytest.mark.parametrize("size,block,grid,src", CASES[:4])
def test_geometry_matches_jax(size, block, grid, src):
    if src != (0, 0):
        with pytest.raises(NotImplementedError):
            tspmd.Geometry.of(TDist(size, block, grid, src))
        return
    jg = jspmd.Geometry.of(JDist(size, block, grid, src))
    tg = tspmd.Geometry.of(TDist(size, block, grid, src))
    assert vars(tg) == vars(jg)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,mb", [(64, 16), (100, 32)])
def test_from_stacked_round_trip(grid_1x1, n, mb, dtype):
    a = tu.random_hermitian_pd(n, dtype, seed=3)
    jm = JMatrix.from_global(grid_1x1, a, (mb, mb))
    stacked = np.asarray(jax.device_get(jm.data))
    tm = TMatrix.from_stacked(stacked, jm.dist, TGrid.create(device="cpu"))
    np.testing.assert_array_equal(tm.to_stacked(), stacked)
    np.testing.assert_array_equal(tm.to_global(), jm.to_global())
    # from_global builds the same state the JAX package does
    tg = TMatrix.from_global(TGrid.create(device="cpu"), a, (mb, mb))
    np.testing.assert_array_equal(tg.to_stacked(), stacked)
    assert tg.dtype == tm.dtype and tuple(tg.size) == tuple(jm.size)
    assert tuple(tg.block_size) == tuple(jm.block_size)
    cp = tg.astype(np.float64)
    assert cp.data.data_ptr() != tg.data.data_ptr()
    np.testing.assert_array_equal(cp.to_global(), a.astype(np.float64))


@pytest.mark.parametrize("nr", [3, 5, 7])
def test_one_rank_collectives_match_jax_slot_for_slot(grid_1x1, nr):
    """The size-1-axis collectives of the port against the JAX package's
    inside shard_map on a 1x1 mesh (exact: they are selects and copies)."""
    import jax.numpy as jnp
    import torch

    from dlaf_tpu.comm import collectives as jcoll
    from dlaf_tpu_torch.comm import collectives as tcoll

    ltr, ltc = 5, 6
    panel = np.arange(ltr * 2 * 2, dtype=np.float64).reshape(ltr, 2, 2) + 1.0
    jv, iv = np.array([1, 2, 3, 4, 6]), np.array([0, 2, 4, 5])
    def c_idx(c, v):
        return jnp.asarray(v) if c is jcoll else torch.from_numpy(v)

    cases = {
        "transpose_panel": lambda c, p: c.transpose_panel(p, nr, ltc),
        "transpose_panel_rows": lambda c, p: c.transpose_panel_rows(p, nr, ltc),
        "transpose_panel_windowed":
            lambda c, p: c.transpose_panel_windowed(p, c_idx(c, jv), 1, nr),
        "transpose_panel_rows_windowed":
            lambda c, p: c.transpose_panel_rows_windowed(p, c_idx(c, iv), 2, nr),
        "bcast2d": lambda c, p: c.bcast2d(p, 0, 0),
    }
    for name, fn in cases.items():
        ref = jcoll.spmd(grid_1x1, lambda x, fn=fn: jcoll.relocal(fn(jcoll, jcoll.local(x))))(
            jnp.asarray(panel[None, None]))
        got = fn(tcoll, torch.from_numpy(panel))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref)[0, 0], err_msg=name)
    taken, have = tcoll.transpose_panel_parts(torch.from_numpy(panel), nr, ltc)
    jt, jh = jcoll.spmd(grid_1x1, lambda x: tuple(
        jcoll.relocal(v) for v in jcoll.transpose_panel_parts(jcoll.local(x), nr, ltc)))(
        jnp.asarray(panel[None, None]))
    np.testing.assert_array_equal(taken.numpy(), np.asarray(jt)[0, 0])
    np.testing.assert_array_equal(have.numpy(), np.asarray(jh)[0, 0])
