"""The port's Left/Lower triangular_solver and positive_definite_solver
against the JAX package's, on the 1x1 grid, at small sizes, with the same
knobs and input state in both packages.

Tolerance: ``tol_for(dtype, n)`` of the relative max error
(``dlaf_tpu/testing/__init__.py:55``).
"""
import contextlib

import jax
import numpy as np
import pytest

import dlaf_tpu as dt
import dlaf_tpu.testing as tu
from dlaf_tpu import tune as jtune
from dlaf_tpu_torch import positive_definite_solver, triangular_solver
from dlaf_tpu_torch import tune as ttune
from dlaf_tpu_torch.comm.grid import Grid
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix

VARIANTS = {
    "bucketed": dict(trsm_lookahead=False, cholesky_lookahead=False,
                     trailing_update_impl="auto"),
    "lookahead_fused": dict(trsm_lookahead=True, cholesky_lookahead=True,
                            trailing_update_impl="fused"),
}


@contextlib.contextmanager
def knobs(**kw):
    jp, tp = jtune.get_tune_parameters(), ttune.get_tune_parameters()
    jold = {k: getattr(jp, k) for k in kw}
    told = {k: getattr(tp, k) for k in kw}
    jp.update(**kw)
    tp.update(**kw)
    try:
        yield
    finally:
        jp.update(**jold)
        tp.update(**told)


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_state():
    yield
    jax.clear_caches()


def _pair(grid_1x1, a, block):
    jm = dt.DistributedMatrix.from_global(grid_1x1, a, block)
    tm = DistributedMatrix.from_stacked(np.asarray(jm.data), jm.dist, Grid.create(device="cpu"))
    return jm, tm


def _rel_err(got, ref):
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("op", ["N", "C"])
@pytest.mark.parametrize("dtype,n,mb,nrhs", [(np.float32, 100, 32, 40), (np.float64, 64, 16, 24)])
def test_triangular_solver_left_lower_matches_jax(grid_1x1, variant, op, dtype, n, mb, nrhs):
    a = tu.random_triangular(n, dtype, lower=True, seed=n)
    a = a + np.triu(tu.random_matrix(n, n, dtype, seed=2), 1)  # upper is not read
    b = tu.random_matrix(n, nrhs, dtype, seed=3)
    ja, ta = _pair(grid_1x1, a, (mb, mb))
    jb, tb = _pair(grid_1x1, b, (mb, mb // 2))
    with knobs(panel_trsm_pallas=True, **VARIANTS[variant]):
        ref = dt.triangular_solver("Left", "L", op, "N", 2.0, ja, jb, backend="distributed")
        out = triangular_solver("Left", "L", op, "N", 2.0, ta, tb, backend="distributed")
    assert out.data is tb.data  # in place
    np.testing.assert_array_equal(ta.to_global(), a)  # A untouched
    assert _rel_err(out.to_global(), ref.to_global()) <= tu.tol_for(dtype, n)


@pytest.mark.parametrize("op", ["N", "C"])
def test_triangular_solver_dense_auto_path_matches_jax(grid_1x1, op):
    n, mb = 72, 16
    a = tu.random_triangular(n, np.float64, lower=True, seed=4)
    b = tu.random_matrix(n, 10, np.float64, seed=5)
    ja, ta = _pair(grid_1x1, a, (mb, mb))
    jb, tb = _pair(grid_1x1, b, (mb, mb))
    ref = dt.triangular_solver("Left", "L", op, "N", 1.0, ja, jb).to_global()
    got = triangular_solver("Left", "L", op, "N", 1.0, ta, tb).to_global()
    assert _rel_err(got, ref) <= tu.tol_for(np.float64, n)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("return_info", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_positive_definite_solver_matches_jax(grid_1x1, dtype, return_info, variant):
    n, mb = 96, 32
    a = tu.random_hermitian_pd(n, dtype, seed=7)
    b = tu.random_matrix(n, 12, dtype, seed=8)
    ja, ta = _pair(grid_1x1, a, (mb, mb))
    jb, tb = _pair(grid_1x1, b, (mb, mb))
    with knobs(panel_trsm_pallas=True, **VARIANTS[variant]):
        ref = dt.positive_definite_solver("L", ja, jb, return_info=return_info)
        out = positive_definite_solver("L", ta, tb, return_info=return_info)
    if return_info:
        (ref, jinfo), (out, tinfo) = ref, out
        assert int(tinfo) == int(jinfo) == 0
    assert _rel_err(out.to_global(), ref.to_global()) <= tu.tol_for(dtype, n)
    assert _rel_err(a.astype(np.result_type(dtype, np.float64)) @ out.to_global(), b) \
        <= tu.tol_for(dtype, n) * 10


def test_left_out_options_raise():
    """The Right side still waits (ROADMAP §A, item 2); ``refine_to`` is
    ported, and a value outside its domain raises."""
    from dlaf_tpu_torch.health import ConfigurationError

    g = Grid.create(device="cpu")
    ta = DistributedMatrix.from_global(g, np.eye(8), (4, 4))
    tb = DistributedMatrix.from_global(g, np.ones((8, 2)), (4, 4))
    with pytest.raises(NotImplementedError):
        triangular_solver("Right", "L", "N", "N", 1.0, ta, tb)
    with pytest.raises(ConfigurationError, match="refine_to"):
        triangular_solver("Left", "L", "N", "N", 1.0, ta, tb, refine_to="output")
    with pytest.raises(ConfigurationError, match="refine_to"):
        positive_definite_solver("L", ta, tb, refine_to="target")


# ------------------------------------------------------- multi-rank grids

MULTI_SHAPES = [(2, 2), (2, 4), (4, 2)]
# f32 on every shape (the ids of before), c64 and c128 on one shape each
MULTI_CASES = [
    *(pytest.param(s, np.float32, id=f"shape{i}") for i, s in enumerate(MULTI_SHAPES)),
    pytest.param((2, 4), np.complex64, id="shape1-complex64"),
    pytest.param((4, 2), np.complex128, id="shape2-complex128"),
]
MULTI_VARIANTS = {
    "bucketed": dict(trsm_lookahead=False, cholesky_lookahead=False, trailing_update_impl="auto"),
    "lookahead": dict(trsm_lookahead=True, cholesky_lookahead=True, trailing_update_impl="xla"),
}
_JAX_POSV: dict = {}


def _multi_pair(comm_grids, shape, a, block):
    jgrid = next(g for g in comm_grids if tuple(g.grid_size) == shape)
    jm = dt.DistributedMatrix.from_global(jgrid, a, block)
    tm = DistributedMatrix.from_stacked(np.asarray(jm.data), jm.dist,
                                        Grid.create(shape, device="cpu"))
    return jm, tm


@pytest.mark.parametrize("tier", ["psum", "v2", "pallas"])
@pytest.mark.parametrize("variant", list(MULTI_VARIANTS))
@pytest.mark.parametrize("shape,dtype", MULTI_CASES)
def test_posv_multi_rank_matches_jax(comm_grids, shape, dtype, variant, tier):
    """POSV (the factorization, then both Left/Lower solves) on rank threads
    of a 2x2, 2x4 and 4x2 grid, in each collectives tier, against the JAX
    package on its 8-device mesh; ``return_info`` as path M3 calls it.  f32,
    and c64 and c128 on one shape each."""
    n, mb = 52, 8
    a = tu.random_hermitian_pd(n, dtype, seed=31)
    b = tu.random_matrix(n, 12, dtype, seed=32)
    key = (shape, np.dtype(dtype).str, variant)
    if key not in _JAX_POSV:
        ja, _ = _multi_pair(comm_grids, shape, a, (mb, mb))
        jb, _ = _multi_pair(comm_grids, shape, b, (mb, mb))
        with knobs(**MULTI_VARIANTS[variant]):
            _JAX_POSV[key] = dt.positive_definite_solver("L", ja, jb).to_global()
    _, ta = _multi_pair(comm_grids, shape, a, (mb, mb))
    _, tb = _multi_pair(comm_grids, shape, b, (mb, mb))
    with knobs(collectives_impl=tier, **MULTI_VARIANTS[variant]):
        out, info = positive_definite_solver("L", ta, tb, return_info=True)
    assert int(info) == 0
    assert _rel_err(out.to_global(), _JAX_POSV[key]) <= tu.tol_for(dtype, n)
    assert _rel_err(a.astype(np.result_type(dtype, np.float64)) @ out.to_global(), b) \
        <= tu.tol_for(dtype, n) * 10


@pytest.mark.parametrize("op", ["N", "C"])
def test_triangular_solver_2x4_matches_jax(comm_grids, op):
    n, mb = 44, 8
    a = tu.random_triangular(n, np.float64, lower=True, seed=33)
    b = tu.random_matrix(n, 20, np.float64, seed=34)
    ja, ta = _multi_pair(comm_grids, (2, 4), a, (mb, mb))
    jb, tb = _multi_pair(comm_grids, (2, 4), b, (mb, mb // 2))
    with knobs(collectives_impl="pallas", trsm_lookahead=True, trailing_update_impl="fused"):
        ref = dt.triangular_solver("Left", "L", op, "N", 2.0, ja, jb).to_global()
        out = triangular_solver("Left", "L", op, "N", 2.0, ta, tb)
    np.testing.assert_array_equal(ta.to_global(), a)  # A untouched
    assert _rel_err(out.to_global(), ref) <= tu.tol_for(np.float64, n)
