"""The port's distributed transpose and generalized_to_standard (HEGST)
against the JAX package's, on CPU grids of rank threads of the JAX
fixture's shapes (the cases of ``tests/test_gen_to_std.py``).

- ``transpose``: the distribution and the stacked tiles bit for bit the
  JAX package's (a copy), with and without ``conj``, non-square, ragged,
  with a source rank off (0, 0), and empty.
- The composed backend (two triangular solves, the Right one on the port's
  bucketed Right kernel) for L and U, f64 and c128, at the JAX test's
  m = 13, mb = 4 on 2x4.
- The fused backend (the hegst tile recursion, then one Left solve) on
  2x2, 2x4 and 4x2 against the JAX package's fused and composed results,
  and its ``trailing_update_impl='fused'`` tier (two consume rings a step,
  their twins on the CPU) bit for bit its 'xla' tier.
- Cholesky of B, then HEGST, as the generalized eigensolver chains them.

Tolerances: the JAX test's ``tol_for(dtype, m, 500)`` against the exact
transform, ``tol_for(dtype, m, 200)`` relative to ``max|A_std|`` between
two results of the packages' backends.
"""
import contextlib

import jax
import numpy as np
import pytest

import dlaf_tpu as dt
import dlaf_tpu.testing as tu
from dlaf_tpu import tune as jtune
from dlaf_tpu.algorithms.gen_to_std import generalized_to_standard as j_hegst
from dlaf_tpu.matrix import util as j_util
from dlaf_tpu_torch import tune
from dlaf_tpu_torch.algorithms.cholesky import cholesky_factorization
from dlaf_tpu_torch.algorithms.gen_to_std import generalized_to_standard
from dlaf_tpu_torch.health import ConfigurationError
from dlaf_tpu_torch.matrix import util as t_util
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.testing import grid_like


@contextlib.contextmanager
def knobs(**kw):
    """Set the same knobs in both packages; restore both afterwards."""
    jp, tp = jtune.get_tune_parameters(), tune.get_tune_parameters()
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


def _jgrid(comm_grids, shape):
    return next(g for g in comm_grids if tuple(g.grid_size) == tuple(shape))


def _pair(comm_grids, shape, a, block, source_rank=(0, 0)):
    jm = dt.DistributedMatrix.from_global(_jgrid(comm_grids, shape), a, block, source_rank)
    return jm, DistributedMatrix.from_stacked(np.asarray(jm.data), jm.dist, grid_like(shape))


def _max_rel(got, ref) -> float:
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


def _problem(m, dtype, uplo, seed_a, seed_b):
    """A's ``uplo`` triangle, the factor of B in its ``uplo`` triangle, and
    the exact A_std."""
    a = tu.random_hermitian_pd(m, dtype, seed=seed_a)
    b = tu.random_hermitian_pd(m, dtype, seed=seed_b)
    ell = np.linalg.cholesky(b)
    expected = np.linalg.solve(ell, a) @ np.linalg.inv(ell.conj().T)
    if uplo == "L":
        return np.tril(a), ell, expected
    return np.triu(a), ell.conj().T, expected


@pytest.mark.parametrize("shape,m,n,block,conj,dtype,source_rank", [
    pytest.param((2, 4), 13, 9, (4, 4), True, np.complex128, (0, 0), id="2x4-conj"),
    pytest.param((4, 2), 13, 9, (4, 3), False, np.complex128, (0, 0), id="4x2-nonsquare-tiles"),
    pytest.param((2, 4), 13, 9, (4, 4), True, np.float64, (1, 1), id="2x4-source-rank"),
    pytest.param((1, 1), 9, 13, (4, 4), True, np.complex128, (0, 0), id="1x1"),
    pytest.param((2, 4), 0, 5, (4, 4), True, np.float64, (0, 0), id="empty"),
])
def test_transpose_matches_jax(comm_grids, shape, m, n, block, conj, dtype, source_rank):
    a = tu.random_matrix(m, n, dtype, seed=1)
    jm, tm = _pair(comm_grids, shape, a, block, source_rank)
    want = j_util.transpose(jm, conj=conj)
    got = t_util.transpose(tm, conj=conj)
    for field in ("size", "block_size", "grid_size", "source_rank"):
        assert tuple(getattr(got.dist, field)) == tuple(getattr(want.dist, field))
    np.testing.assert_array_equal(got.to_stacked(), np.asarray(want.data))
    np.testing.assert_array_equal(tm.to_global(), a)  # the input untouched


@pytest.mark.parametrize("uplo", "LU")
@pytest.mark.parametrize("dtype", [np.float64, np.complex128], ids=str)
def test_composed_matches_jax(comm_grids, uplo, dtype):
    """``tests/test_gen_to_std.py::test_gen_to_std`` in both packages (the
    default backend): the exact transform and the JAX package's result
    within tol_for(dtype, 13, 500); full Hermitian storage; A and B not
    modified."""
    m, mb = 13, 4
    tri, fac, expected = _problem(m, dtype, uplo, 3, 4)
    (ja, ta), (jb, tb) = (_pair(comm_grids, (2, 4), v, (mb, mb)) for v in (tri, fac))
    with knobs(gen_to_std_backend="composed"):
        ref = j_hegst(uplo, ja, jb).to_global()
        with knobs(collectives_impl="pallas"):
            out = generalized_to_standard(uplo, ta, tb).to_global()
    tol = tu.tol_for(dtype, m, 500.0)
    assert _max_rel(out, expected) <= tol and _max_rel(out, ref) <= tol
    np.testing.assert_allclose(out, out.conj().T, atol=1e-8)
    np.testing.assert_array_equal(ta.to_global(), tri)
    np.testing.assert_array_equal(tb.to_global(), fac)


_JAX_FUSED: dict = {}


@pytest.mark.parametrize("uplo,shape,m,nb,dtype", [
    pytest.param("L", (2, 2), 24, 4, np.float64, id="L-2x2"),
    pytest.param("L", (2, 4), 24, 4, np.float64, id="L-2x4"),
    pytest.param("L", (4, 2), 24, 4, np.float64, id="L-4x2"),
    pytest.param("L", (2, 4), 21, 5, np.complex128, id="L-2x4-ragged-complex128"),
    pytest.param("U", (2, 4), 24, 4, np.float64, id="U-2x4"),
])
def test_fused_matches_jax(comm_grids, uplo, shape, m, nb, dtype):
    """``test_gen_to_std_fused_backend``: the fused hegst on a multi-rank
    grid against the JAX package's fused and composed results, and the
    exact transform; the U case runs the L recursion on U^H."""
    tri, fac, expected = _problem(m, dtype, uplo, m, m + 1)
    key = (uplo, shape, np.dtype(dtype).str)
    if key not in _JAX_FUSED:
        refs = {}
        for be in ("composed", "fused"):
            (ja, jb) = (_pair(comm_grids, shape, v, (nb, nb))[0] for v in (tri, fac))
            with knobs(gen_to_std_backend=be):
                refs[be] = j_hegst(uplo, ja, jb).to_global()
        _JAX_FUSED[key] = refs
    _, ta = _pair(comm_grids, shape, tri, (nb, nb))
    _, tb = _pair(comm_grids, shape, fac, (nb, nb))
    with knobs(gen_to_std_backend="fused"):
        out = generalized_to_standard(uplo, ta, tb).to_global()
    scale = max(1.0, np.abs(expected).max())
    for ref in _JAX_FUSED[key].values():
        assert np.abs(out - ref).max() <= tu.tol_for(dtype, m, 200.0) * scale
    assert _max_rel(out, expected) <= tu.tol_for(dtype, m, 500.0)


@pytest.mark.parametrize("shape,m,nb,tier", [
    pytest.param((2, 2), 24, 4, "pallas", id="2x2"),
    pytest.param((2, 4), 40, 8, "pallas", id="2x4"),
    pytest.param((4, 2), 40, 8, "v2", id="4x2-v2"),
    pytest.param((2, 4), 21, 5, "psum", id="2x4-ragged-psum"),
])
def test_fused_tier_bitwise_xla(monkeypatch, shape, m, nb, tier):
    """Under ``trailing_update_impl='fused'`` the hegst's her2k is two
    consume rings a step (``fused_transpose_update`` twice on every rank,
    the first fed the A panel's exchange and the second the L panel's, the
    same slots suppressed); on a CPU grid that is the transport plus one
    update each, and the result is the 'xla' tier's bit for bit."""
    import threading

    from dlaf_tpu_torch.algorithms import gen_to_std as t_gen_to_std

    calls: dict = {}
    inner = t_gen_to_std._tu.fused_transpose_update

    def spy(x, cp, taken, have, suppress, axis="r"):
        calls.setdefault(threading.current_thread().name, []).append(suppress.clone())
        return inner(x, cp, taken, have, suppress, axis)

    monkeypatch.setattr(t_gen_to_std._tu, "fused_transpose_update", spy)
    tri, fac, _ = _problem(m, np.float64, "L", 7, 8)
    out = {}
    for impl in ("xla", "fused"):
        ta = DistributedMatrix.from_global(grid_like(shape), tri, (nb, nb))
        tb = DistributedMatrix.from_global(grid_like(shape), fac, (nb, nb))
        with knobs(gen_to_std_backend="fused", trailing_update_impl=impl, collectives_impl=tier):
            out[impl] = generalized_to_standard("L", ta, tb).to_stacked()
        if impl == "xla":
            assert not calls
    np.testing.assert_array_equal(out["fused"], out["xla"])
    mt = -(-m // nb)
    assert len(calls) == shape[0] * shape[1]
    for seq in calls.values():
        assert len(seq) == 2 * mt
        for first, second in zip(seq[::2], seq[1::2]):
            assert bool((first == second).all())


def test_cholesky_then_hegst_matches_jax(comm_grids):
    """``test_gen_to_std_with_cholesky_pipeline``: cholesky(B) then HEGST,
    in both packages, each backend of the port against the JAX package's
    default chain."""
    m, mb = 16, 4
    a = tu.random_hermitian_pd(m, np.float64, seed=5)
    b = tu.random_hermitian_pd(m, np.float64, seed=6)
    ell = np.linalg.cholesky(b)
    expected = np.linalg.solve(ell, a) @ np.linalg.inv(ell.T)
    (ja, _), (jb, _) = (_pair(comm_grids, (2, 4), v, (mb, mb)) for v in (np.tril(a), b))
    ref = j_hegst("L", ja, dt.cholesky_factorization("L", jb)).to_global()
    tol = tu.tol_for(np.float64, m, 500.0)
    for be in ("composed", "fused"):
        (_, ta), (_, tb) = (_pair(comm_grids, (2, 4), v, (mb, mb)) for v in (np.tril(a), b))
        with knobs(gen_to_std_backend=be):
            out = generalized_to_standard("L", ta, cholesky_factorization("L", tb)).to_global()
        assert _max_rel(out, expected) <= tol and _max_rel(out, ref) <= tol


def test_backend_knob_is_checked():
    with pytest.raises(ConfigurationError, match="gen_to_std_backend"):
        tune.get_tune_parameters().update(gen_to_std_backend="hegst")
    assert tune.TuneParameters().gen_to_std_backend == "composed"
