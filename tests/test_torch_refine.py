"""The refined and mixed-precision solvers of the port against the JAX
package's: ``positive_definite_solver`` and ``triangular_solver`` with
``refine_to='input'`` under the bf16x3 tier, and
``positive_definite_solver_mixed`` converging, falling back and reporting
a stall, on CPU grids of rank threads (the cases of
``tests/test_precision.py``, ``tests/test_solver.py`` and
``tests/test_health.py``).

Each comparison holds the port's solution within the JAX test's budget of
the exact solution and of the JAX package's, and the two packages'
``RefineInfo`` / ``MixedSolveInfo`` to the same ``converged``,
``fallback`` and sweep counts.
"""
import contextlib

import jax
import numpy as np
import pytest

import dlaf_tpu as dt
import dlaf_tpu.testing as tu
from dlaf_tpu import health as jhealth
from dlaf_tpu import tune as jtune
from dlaf_tpu.algorithms import refine as jrefine
from dlaf_tpu.testing import faults
from dlaf_tpu_torch import health, positive_definite_solver, positive_definite_solver_mixed
from dlaf_tpu_torch import triangular_solver
from dlaf_tpu_torch import tune as ttune
from dlaf_tpu_torch.algorithms import refine as trefine
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.testing import grid_like


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_state():
    yield
    jax.clear_caches()


@contextlib.contextmanager
def gemm_tier(tier):
    jp, tp = jtune.get_tune_parameters(), ttune.get_tune_parameters()
    old = (jp.gemm_precision, tp.gemm_precision)
    jp.update(gemm_precision=tier)
    tp.update(gemm_precision=tier)
    try:
        yield
    finally:
        jp.update(gemm_precision=old[0])
        tp.update(gemm_precision=old[1])


@contextlib.contextmanager
def refine_infos(monkeypatch):
    """Record the RefineInfo of every residual_refine call of both packages."""
    got = {"jax": [], "port": []}
    for key, mod in (("jax", jrefine), ("port", trefine)):
        inner = mod.residual_refine

        def wrapped(*args, _inner=inner, _key=key, **kw):
            x, info = _inner(*args, **kw)
            got[_key].append(info)
            return x, info

        monkeypatch.setattr(mod, "residual_refine", wrapped)
    yield got


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


def _pair(comm_grids, shape, a, block):
    jgrid = next(g for g in comm_grids if tuple(g.grid_size) == tuple(shape))
    jm = dt.DistributedMatrix.from_global(jgrid, a, block)
    return jm, DistributedMatrix.from_stacked(np.asarray(jm.data), jm.dist, grid_like(shape))


def _wide(a):
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


@pytest.mark.parametrize("dtype,shape,uplo", [
    *(pytest.param(d, s, "L", id=f"{d}-shape{i}") for d in (np.float32, np.complex64)
      for i, s in enumerate([(2, 4), (2, 2)])),
    pytest.param(np.float32, (2, 4), "U", id=f"{np.float32}-shape0-upper"),
])
def test_posv_bf16x3_refined_matches_jax(comm_grids, monkeypatch, dtype, shape, uplo):
    """``tests/test_precision.py::test_posv_bf16x3_refined_meets_seed_bounds``
    in both packages: the solution within tol_for(dtype, m, 500) of the
    exact one and of the JAX package's, the same RefineInfo outcome; from
    A's lower and from its upper triangle."""
    m, k, mb = 64, 8, 8
    a = tu.random_hermitian_pd(m, dtype, seed=3)
    b = tu.random_matrix(m, k, dtype, seed=4)
    expected = np.linalg.solve(_wide(a), _wide(b))
    tri = np.tril(a) if uplo == "L" else np.triu(a)
    (ja, ta), (jb, tb) = (_pair(comm_grids, shape, v, (mb, mb)) for v in (tri, b))
    with gemm_tier("bf16x3"), refine_infos(monkeypatch) as infos:
        ref = dt.positive_definite_solver(uplo, ja, jb, refine_to="input").to_global()
        unrefined = positive_definite_solver(uplo, *(_pair(comm_grids, shape, v, (mb, mb))[1]
                                                     for v in (tri, b))).to_global()
        out = positive_definite_solver(uplo, ta, tb, refine_to="input").to_global()
    tol = tu.tol_for(dtype, m, 500.0)
    assert _rel_err(out, expected) <= tol and _rel_err(out, ref) <= tol
    # the refinement did something: the split-tier solve alone is further off
    assert _rel_err(out, expected) < _rel_err(unrefined, expected)
    (ji,), (ti,) = infos["jax"], infos["port"]
    assert (ti.converged, ti.sweeps) == (ji.converged, ji.sweeps) and ti.converged


@pytest.mark.parametrize("dtype,side", [
    pytest.param(np.float32, "Left", id=str(np.float32)),
    pytest.param(np.complex64, "Left", id=str(np.complex64)),
    pytest.param(np.float32, "Right", id=str(np.float32) + "-Right"),
])
def test_trsm_bf16x3_refined_matches_jax(comm_grids, monkeypatch, dtype, side):
    """``test_trsm_bf16x3_refined_meets_seed_bounds``: a normwise backward
    error within 50x the refinement tolerance, in both packages; the Right
    side's residual is a Right TRMM."""
    m, k, mb = 64, 8, 8
    a = tu.random_triangular(m, dtype, lower=True, seed=5)
    b = tu.random_matrix(m, k, dtype, seed=6)
    if side == "Right":
        b = np.ascontiguousarray(b.T)
    (ja, ta), (jb, tb) = (_pair(comm_grids, (2, 4), v, (mb, mb)) for v in (a, b))
    with gemm_tier("bf16x3"), refine_infos(monkeypatch) as infos:
        ref = dt.triangular_solver(side, "L", "N", "N", 1.0, ja, jb,
                                   refine_to="input").to_global()
        out = triangular_solver(side, "L", "N", "N", 1.0, ta, tb, refine_to="input").to_global()
    bound = trefine.refine_tolerance(np.max(np.abs(a)), m, dtype)
    for xh in (out, ref):
        r = b - (a @ xh if side == "Left" else xh @ a)
        assert np.max(np.abs(r)) <= 50.0 * bound * max(np.max(np.abs(xh)), 1.0)
    assert _rel_err(out, ref) <= tu.tol_for(dtype, m, 500.0)
    (ji,), (ti,) = infos["jax"], infos["port"]
    assert (ti.converged, ti.sweeps) == (ji.converged, ji.sweeps)


def test_posv_refine_is_a_no_op_at_the_default_tier(comm_grids, monkeypatch):
    m, k, mb = 32, 4, 8
    a = tu.random_hermitian_pd(m, np.float64, seed=8)
    b = tu.random_matrix(m, k, np.float64, seed=9)
    (_, ta), (_, tb) = (_pair(comm_grids, (2, 4), v, (mb, mb)) for v in (np.tril(a), b))
    with refine_infos(monkeypatch) as infos:
        out = positive_definite_solver("L", ta, tb, refine_to="input").to_global()
    assert _rel_err(out, np.linalg.solve(a, b)) <= tu.tol_for(np.float64, m, 500.0)
    (ti,) = infos["port"]
    assert ti.converged and ti.sweeps == 0


def test_bad_refine_to_rejected():
    from dlaf_tpu_torch.health import ConfigurationError

    with pytest.raises(ConfigurationError, match="refine_to"):
        trefine.validate_refine_to("output")
    g = grid_like((2, 4))
    ta = DistributedMatrix.from_global(g, np.tril(tu.random_hermitian_pd(16, np.float32, 1)),
                                       (4, 4))
    tb = DistributedMatrix.from_global(g, tu.random_matrix(16, 4, np.float32, 2), (4, 4))
    with pytest.raises(ConfigurationError, match="refine_to"):
        positive_definite_solver("L", ta, tb, refine_to="target")
    with pytest.raises(ConfigurationError, match="refine_to"):
        triangular_solver("Left", "L", "N", "N", 1.0, ta, tb, refine_to="x")


def test_residual_refine_bails_on_nan():
    x = DistributedMatrix.from_global(grid_like((2, 4)), tu.random_matrix(16, 4, np.float32, 1),
                                      (4, 4))
    calls = []

    def residual(xc):
        calls.append(1)
        return xc.like(xc.data * float("nan"))

    _, info = trefine.residual_refine(x, residual, lambda r: r, tol=1e-7, anorm=1.0,
                                      max_sweeps=3)
    assert len(calls) == 1 and not info.converged


# ------------------------------------------------------------ mixed precision


def _ab(m, k, dtype, seed, cond=None):
    """``tests/test_solver.py``'s inputs: SPD, or SPD with a prescribed
    condition number."""
    if cond is None:
        a = tu.random_hermitian_pd(m, dtype, seed=seed)
    else:
        rng = np.random.default_rng(seed)
        q, _ = np.linalg.qr(rng.standard_normal((m, m)))
        a = ((q * np.logspace(0, -np.log10(cond), m)) @ q.T).astype(dtype)
    return a, tu.random_matrix(m, k, dtype, seed=seed + 1)


def _mixed_both(comm_grids, shape, a, b, mb, uplo="L", **kw):
    tri = np.tril(a) if uplo == "L" else np.triu(a)
    (ja, ta), (jb, tb) = (_pair(comm_grids, shape, v, (mb, mb)) for v in (tri, b))
    with jhealth.capture_events() as jev:
        jx, ji = dt.positive_definite_solver_mixed(uplo, ja, jb, **kw)
    before = (ta.to_global().copy(), tb.to_global().copy())
    with health.capture_events() as tev:
        tx, ti = positive_definite_solver_mixed(uplo, ta, tb, **kw)
    np.testing.assert_array_equal(ta.to_global(), before[0])  # A and B untouched
    np.testing.assert_array_equal(tb.to_global(), before[1])
    return (jx.to_global(), ji, [e["event"] for e in jev]), (tx.to_global(), ti,
                                                              [e["event"] for e in tev])


@pytest.mark.parametrize("shape,dtype,uplo", [
    pytest.param((2, 4), np.float64, "L", id="shape0-float64"),
    pytest.param((2, 4), np.complex128, "L", id="shape1-complex128"),
    pytest.param((1, 1), np.float64, "L", id="shape2-float64"),
    pytest.param((4, 2), np.float64, "L", id="shape3-float64"),
    pytest.param((2, 4), np.float64, "U", id="shape0-float64-upper"),
])
def test_posv_mixed_converges_like_jax(comm_grids, shape, dtype, uplo):
    """``tests/test_solver.py::test_posv_mixed_converges``: f64-class
    accuracy from the f32 (c64) factor without the fallback, the same
    sweep count as the JAX package; from either triangle of A."""
    m, k, mb = 64, 3, 8
    a, b = _ab(m, k, dtype, seed=11)
    (jx, ji, jev), (tx, ti, tev) = _mixed_both(comm_grids, shape, a, b, mb, uplo=uplo)
    assert ti.converged and not ti.fallback and ti.iters <= 10
    assert (ti.converged, ti.fallback, ti.iters) == (ji.converged, ji.fallback, ji.iters)
    assert ti.backward_error < 1e-12 and tev == jev == []
    tol = tu.tol_for(dtype, m, 2000.0)
    assert _rel_err(tx, np.linalg.solve(a, b)) <= tol and _rel_err(tx, jx) <= tol


def test_posv_mixed_falls_back_like_jax(comm_grids):
    """``test_posv_mixed_fallback``: cond(A) = 1e11 >> 1/eps(f32), so the f32
    factor cannot converge in 4 sweeps; the full-precision solve is
    recorded as ``mixed_solve_fallback`` and is accurate."""
    m, k, mb = 48, 2, 8
    a, b = _ab(m, k, np.float64, seed=13, cond=1e11)
    (jx, ji, jev), (tx, ti, tev) = _mixed_both(comm_grids, (2, 4), a, b, mb, max_iters=4)
    assert ti.fallback and ti.converged
    assert (ti.converged, ti.fallback, ti.iters) == (ji.converged, ji.fallback, ji.iters)
    assert tev == jev == ["mixed_solve_fallback"]
    resid = np.abs(a @ tx - b).max()
    assert resid <= 1e-11 * np.abs(a).max() * max(np.abs(tx).max(), 1)


def test_posv_mixed_without_fallback_reports_like_jax(comm_grids):
    """``test_posv_mixed_no_fallback_reports``: the best iterate, not
    converged, no fallback, a ``mixed_solve_stalled`` event."""
    m, k, mb = 48, 2, 8
    a, b = _ab(m, k, np.float64, seed=13, cond=1e11)
    (_, ji, jev), (_, ti, tev) = _mixed_both(comm_grids, (2, 4), a, b, mb, max_iters=4,
                                             fallback=False)
    assert not ti.converged and not ti.fallback
    assert (ti.converged, ti.fallback, ti.iters) == (ji.converged, ji.fallback, ji.iters)
    assert tev == jev == ["mixed_solve_stalled"]


@pytest.mark.parametrize("shape", [(2, 4), (1, 1)])
@pytest.mark.parametrize("fallback", [False, True])
def test_mixed_solver_health_like_jax(comm_grids, fallback, shape):
    """``tests/test_health.py``'s convergence cases (cond 1e14): without the
    fallback ``raise_on_failure`` raises ConvergenceError carrying the
    info, with it the fallback converges; the same events in both
    packages.  On 1x1 the f32 factor is the dense path, whose failure is
    NaN in both packages (ROADMAP §C, C3)."""
    n = 32
    a = faults.ill_conditioned_pd(n, np.float64, cond=1e14, seed=3)
    b = tu.random_matrix(n, 2, np.float64, seed=4)
    (ja, ta), (jb, tb) = (_pair(comm_grids, shape, v, (8, 8)) for v in (a, b))
    with jhealth.capture_events() as jev, health.capture_events() as tev:
        if fallback:
            _, ji = dt.positive_definite_solver_mixed("L", ja, jb)
            _, ti = positive_definite_solver_mixed("L", ta, tb)
            assert ti.fallback and ti.converged and ji.fallback and ji.converged
        else:
            with pytest.raises(dt.ConvergenceError):
                dt.positive_definite_solver_mixed("L", ja, jb, fallback=False,
                                                  raise_on_failure=True)
            with pytest.raises(health.ConvergenceError) as ei:
                positive_definite_solver_mixed("L", ta, tb, fallback=False,
                                               raise_on_failure=True)
            assert ei.value.info is not None and not ei.value.info.converged
    want = "mixed_solve_fallback" if fallback else "mixed_solve_stalled"
    assert [e["event"] for e in tev] == [e["event"] for e in jev] == [want]
