"""The port's ``permute`` (``dlaf_tpu_torch/algorithms/permutations.py``)
against the JAX package's, rows and columns, on CPU grids of rank threads
of the JAX fixture's six shapes, at source ranks (0, 0) and (1, 2) (mod
the grid).  A permutation moves values unchanged: the results are held bit
for bit to the JAX package's stacked array, and to numpy's gather."""
import jax
import numpy as np
import pytest

import dlaf_tpu as dt
import dlaf_tpu.testing as tu
from dlaf_tpu.algorithms.permutations import permute as j_permute
from dlaf_tpu_torch import permute
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.testing import GRID_SHAPES, grid_like


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_state():
    yield
    jax.clear_caches()


@pytest.mark.parametrize("shape", GRID_SHAPES)
@pytest.mark.parametrize("coord", ["rows", "cols"])
def test_permute_matches_jax_bit_for_bit(comm_grids, shape, coord):
    jg = next(g for g in comm_grids if tuple(g.grid_size) == shape)
    a = tu.random_matrix(37, 29, np.float64, seed=1)
    n = a.shape[0] if coord == "rows" else a.shape[1]
    perm = np.random.default_rng(2).permutation(n)
    for src in {(0, 0), (1 % shape[0], 2 % shape[1])}:
        jm = dt.DistributedMatrix.from_global(jg, a, (8, 8), source_rank=src)
        tm = DistributedMatrix.from_stacked(np.asarray(jm.data), jm.dist, grid_like(shape))
        ref = j_permute(jm, perm, coord)
        out = permute(tm, perm, coord)
        assert tuple(out.dist.source_rank) == tuple(ref.dist.source_rank) == src
        np.testing.assert_array_equal(out.to_stacked(), np.asarray(ref.data))
        np.testing.assert_array_equal(out.to_global(), a[perm] if coord == "rows" else a[:, perm])
        np.testing.assert_array_equal(tm.to_global(), a)  # a new matrix


def test_permute_checks_its_arguments():
    tm = DistributedMatrix.from_global(grid_like((2, 4)), np.ones((8, 6)), (4, 4))
    with pytest.raises(ValueError, match="shape"):
        permute(tm, np.arange(6), "rows")
    with pytest.raises(ValueError, match="coord"):
        permute(tm, np.arange(8), "diag")
    empty = DistributedMatrix.from_global(grid_like((2, 4)), np.ones((0, 6)), (4, 4))
    assert tuple(permute(empty, np.arange(0), "rows").size) == (0, 6)
