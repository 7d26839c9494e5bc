"""The port's triangular_solver (both sides), cholesky_solver and
positive_definite_solver (both triangles) against the JAX package's, on
the 1x1 grid and on multi-rank grids of rank threads, at small sizes,
with the same knobs and input state in both packages.

Tolerance: ``tol_for(dtype, n)`` of the relative max error
(``dlaf_tpu/testing/__init__.py:55``).
"""
import contextlib
import itertools

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
    """Both sides are ported; a ``refine_to`` outside its domain, a side
    other than Left and Right and a Right solve whose A does not match B's
    columns raise."""
    from dlaf_tpu_torch.health import ConfigurationError

    g = Grid.create(device="cpu")
    ta = DistributedMatrix.from_global(g, np.eye(8), (4, 4))
    tb = DistributedMatrix.from_global(g, np.ones((8, 2)), (4, 4))
    with pytest.raises(ValueError, match="side"):
        triangular_solver("Top", "L", "N", "N", 1.0, ta, tb)
    with pytest.raises(ValueError, match="incompatible"):
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


# ------------------------------------------------------------- Right side

RIGHT_COMBOS = list(itertools.product("LU", "NTC", "NU"))
_JAX_RIGHT: dict = {}


def _right_inputs(n, dtype, uplo, diag):
    """A triangular A whose other triangle is garbage (not read), B of 20
    rows and n columns."""
    a = tu.random_triangular(n, dtype, lower=uplo == "L", unit=diag == "U", seed=41)
    junk = np.triu(tu.random_matrix(n, n, dtype, seed=42), 1)
    a = a + (junk if uplo == "L" else junk.T)
    return a, tu.random_matrix(20, n, dtype, seed=43)


def _jax_right(comm_grids, uplo, op, diag, n, mb, dtype):
    """The JAX package's Right solve (alpha = 2) on its 2x4 mesh (its
    distributed Right kernel), once per case."""
    key = (uplo, op, diag, n, mb, np.dtype(dtype).str)
    if key not in _JAX_RIGHT:
        a, b = _right_inputs(n, dtype, uplo, diag)
        ja, _ = _multi_pair(comm_grids, (2, 4), a, (mb, mb))
        jb, _ = _multi_pair(comm_grids, (2, 4), b, (mb // 2, mb))
        _JAX_RIGHT[key] = dt.triangular_solver("Right", uplo, op, diag, 2.0, ja, jb).to_global()
    return _JAX_RIGHT[key]


def _right_cases():
    """(shape, tier, backend, n, mb, dtype, uplo, op, diag): every combo on
    2x4 under 'pallas'; 1x1 under 'auto' (the dense solve) and
    'distributed'; 4x2 in the three tiers and 2x4 in the other two; a
    ragged N; c128."""
    out = [pytest.param((2, 4), "pallas", "auto", 44, 8, np.float64, *c, id="2x4-pallas-" + "".join(c))
           for c in RIGHT_COMBOS]
    for c in (("L", "C", "N"), ("U", "N", "U")):
        for backend in ("auto", "distributed"):
            out.append(pytest.param((1, 1), "psum", backend, 44, 8, np.float64, *c,
                                    id=f"1x1-{backend}-" + "".join(c)))
    for tier in ("psum", "v2", "pallas"):
        for c in (("L", "C", "N"), ("U", "T", "N")):
            out.append(pytest.param((4, 2), tier, "auto", 44, 8, np.float64, *c,
                                    id=f"4x2-{tier}-" + "".join(c)))
    for tier in ("psum", "v2"):
        out.append(pytest.param((2, 4), tier, "auto", 44, 8, np.float64, "L", "N", "N",
                                id=f"2x4-{tier}-LNN"))
    for c in (("L", "C", "N"), ("U", "N", "N")):
        out.append(pytest.param((2, 4), "pallas", "auto", 13, 4, np.float64, *c,
                                id="2x4-ragged-" + "".join(c)))
    for c in (("L", "C", "N"), ("U", "C", "U")):
        out.append(pytest.param((2, 4), "pallas", "auto", 44, 8, np.complex128, *c,
                                id="2x4-complex128-" + "".join(c)))
    return out


@pytest.mark.parametrize("shape,tier,backend,n,mb,dtype,uplo,op,diag", _right_cases())
def test_triangular_solver_right_matches_jax(comm_grids, shape, tier, backend, n, mb, dtype,
                                             uplo, op, diag):
    """X op(A) = 2 B: the port's bucketed Right kernel (the dense solve on
    1x1 under 'auto') against the JAX package's Right kernel on its 2x4
    mesh, within tol_for(dtype, n); A untouched, B solved in place."""
    a, b = _right_inputs(n, dtype, uplo, diag)
    ref = _jax_right(comm_grids, uplo, op, diag, n, mb, dtype)
    ta = DistributedMatrix.from_global(Grid.create(shape, device="cpu"), a, (mb, mb))
    tb = DistributedMatrix.from_global(Grid.create(shape, device="cpu"), b, (mb // 2, mb))
    with knobs(collectives_impl=tier, trsm_lookahead=True):  # lookahead is Left only
        out = triangular_solver("Right", uplo, op, diag, 2.0, ta, tb, backend=backend)
    assert out.data is tb.data  # in place
    np.testing.assert_array_equal(ta.to_global(), a)
    assert _rel_err(out.to_global(), ref) <= tu.tol_for(dtype, n)


# ------------------------------------------------------------ the U forms

_JAX_UPPER: dict = {}


def _upper_cases():
    """(shape, tier, variant, dtype, return_info): the dense 1x1 route, the
    distributed kernels on 2x4 in the three tiers and on 4x2, c128."""
    return [
        pytest.param((1, 1), "psum", "bucketed", np.float64, False, id="1x1-dense"),
        pytest.param((1, 1), "psum", "lookahead", np.float64, True, id="1x1-lookahead-info"),
        pytest.param((2, 4), "psum", "bucketed", np.float32, True, id="2x4-psum"),
        pytest.param((2, 4), "v2", "lookahead", np.float32, False, id="2x4-v2-lookahead"),
        pytest.param((2, 4), "pallas", "lookahead", np.float32, True, id="2x4-pallas-lookahead"),
        pytest.param((4, 2), "pallas", "bucketed", np.complex128, True, id="4x2-complex128"),
    ]


@pytest.mark.parametrize("shape,tier,variant,dtype,return_info", _upper_cases())
def test_posv_upper_matches_jax(comm_grids, shape, tier, variant, dtype, return_info):
    """POSV with A's upper triangle (the U mirror of the factorization,
    then the Left/Upper/C and Left/Upper/N solves) against the JAX
    package's (its default knobs, one run per grid and dtype), within
    tol_for(dtype, n); the factor left in A's upper triangle, its strict
    lower triangle the caller's."""
    n, mb = 52, 8
    a = tu.random_hermitian_pd(n, dtype, seed=51)
    junk = np.tril(tu.random_matrix(n, n, dtype, seed=52), -1)
    a_up = np.triu(a) + junk  # the strict lower triangle is not read
    b = tu.random_matrix(n, 12, dtype, seed=53)
    key = (shape, np.dtype(dtype).str)
    if key not in _JAX_UPPER:
        ja, _ = _multi_pair(comm_grids, shape, a_up, (mb, mb))
        jb, _ = _multi_pair(comm_grids, shape, b, (mb, mb))
        x = dt.positive_definite_solver("U", ja, jb).to_global()
        _JAX_UPPER[key] = (x, np.triu(ja.to_global()))
    _, ta = _multi_pair(comm_grids, shape, a_up, (mb, mb))
    _, tb = _multi_pair(comm_grids, shape, b, (mb, mb))
    with knobs(collectives_impl=tier, **MULTI_VARIANTS[variant]):
        out = positive_definite_solver("U", ta, tb, return_info=return_info)
    if return_info:
        out, info = out
        assert int(info) == 0
    x_ref, u_ref = _JAX_UPPER[key]
    assert _rel_err(out.to_global(), x_ref) <= tu.tol_for(dtype, n)
    fac = ta.to_global()
    np.testing.assert_array_equal(np.tril(fac, -1), junk)
    assert _rel_err(np.triu(fac), u_ref) <= tu.tol_for(dtype, n)


def test_posv_upper_raises_like_jax(comm_grids):
    """``raise_on_failure`` on a matrix whose leading minor of order 38
    fails, from its upper triangle: the same info in both packages."""
    from dlaf_tpu_torch.health import NotPositiveDefiniteError

    n, mb = 56, 8
    a = tu.random_hermitian_pd(n, np.float64, seed=54)
    a[37, 37] = -40.0
    b = tu.random_matrix(n, 3, np.float64, seed=55)
    ja, ta = _multi_pair(comm_grids, (2, 4), np.triu(a), (mb, mb))
    jb, tb = _multi_pair(comm_grids, (2, 4), b, (mb, mb))
    with pytest.raises(dt.NotPositiveDefiniteError) as je:
        dt.positive_definite_solver("U", ja, jb, raise_on_failure=True)
    with knobs(collectives_impl="pallas"):
        with pytest.raises(NotPositiveDefiniteError) as te:
            positive_definite_solver("U", ta, tb, raise_on_failure=True)
    assert te.value.info == je.value.info == 38
