"""The port's mixed-precision eigensolver (``dlaf_tpu_torch/algorithms/
eig_refine.py``) against the JAX package's, with the cases of
``tests/test_eig_refine.py`` for real dtypes, on a 2x4 grid of rank
threads on the CPU (and 1x1), at N = 48, nb 8 and the eigensolver knobs of
``tests/test_torch_eigensolver_grid.py`` in both packages (one compile of
each JAX route in this module's worker).

Eigenvalues: within ``tol_for(f64, N, 200) * max|w|`` of the JAX
package's and of LAPACK's.  Eigenvectors, whose signs are free: residual
``max|A V - V diag(w)|`` within ``tol_for(f64, N, 200) * max(max|w|, 1)``
and orthogonality ``max|V^T V - I|`` within ``tol_for(f64, N, 200)``.
"""

import jax
import numpy as np
import pytest

import dlaf_tpu as dt
import dlaf_tpu.testing as tu
from dlaf_tpu import tune as jtune
from dlaf_tpu.algorithms import eig_refine as j_er
from dlaf_tpu_torch import health, tune
from dlaf_tpu_torch.algorithms import eig_refine as t_er
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.testing import grid_like

N, NB = 48, 8
KNOBS = dict(eigensolver_min_band=4, eigensolver_sbr_band=2, band_chase_backend="native",
             dc_secular_pallas=True, trailing_update_impl="fused", dc_leaf_size=8,
             bt_band_hh_group_size=2)
TOL = tu.tol_for(np.float64, N, 200.0)
ITEM_5 = r"ROADMAP\.md §A, item 5: the rest of the eigensolver"


@pytest.fixture(scope="module", autouse=True)
def _knobs_and_compiled_state():
    jp, tp = jtune.get_tune_parameters(), tune.get_tune_parameters()
    jold = {k: getattr(jp, k) for k in KNOBS}
    told = {k: getattr(tp, k) for k in KNOBS}
    jp.update(**KNOBS)
    tp.update(**KNOBS)
    yield
    jp.update(**jold)
    tp.update(**told)
    jax.clear_caches()


def _mats(grid_2x4, *arrays, shape=(2, 4)):
    jg = grid_2x4 if shape == (2, 4) else None
    tg = grid_like(shape)
    out = []
    for a in arrays:
        out.append((dt.DistributedMatrix.from_global(jg, a, (NB, NB)) if jg is not None else None,
                    DistributedMatrix.from_global(tg, a, (NB, NB))))
    return out


def _check_pairs(a, w, v, w_want, jw=None, tol=TOL):
    scale = max(np.abs(w_want).max(), 1.0)
    np.testing.assert_allclose(w, w_want, rtol=0, atol=tol * scale)
    if jw is not None:
        np.testing.assert_allclose(w, jw, rtol=0, atol=tol * scale)
    resid = np.abs(a @ v - v * w[None, :]).max()
    assert resid <= tol * scale, f"resid {resid:.3e}"
    ortho = np.abs(v.T @ v - np.eye(v.shape[1])).max()
    assert ortho <= tol, f"ortho {ortho:.3e}"


@pytest.mark.parametrize("uplo", "LU")
def test_heev_mixed_matches_jax(grid_2x4, uplo):
    """The f32 pipeline and the refinement deliver f64 eigenpairs; A is
    not touched."""
    a = tu.random_hermitian_pd(N, np.float64, seed=21)
    tri = np.tril(a) if uplo == "L" else np.triu(a)
    (jm, tm), = _mats(grid_2x4, tri)
    res, info = t_er.hermitian_eigensolver_mixed(uplo, tm)
    jres, jinfo = j_er.hermitian_eigensolver_mixed(uplo, jm)
    assert info.converged and jinfo.converged, (info, jinfo)
    assert info.ortho_error <= 1e-12 and info.residual == np.inf
    _check_pairs(a, res.eigenvalues, res.eigenvectors.to_global(), np.linalg.eigvalsh(a),
                 np.asarray(jres.eigenvalues))
    np.testing.assert_array_equal(tm.to_global(), tri)


def test_heev_mixed_on_1x1_takes_eigh(grid_2x4):
    a = tu.random_hermitian_pd(N, np.float64, seed=22)
    (_, tm), = _mats(grid_2x4, np.tril(a), shape=(1, 1))
    res, info = t_er.hermitian_eigensolver_mixed("L", tm)
    assert info.converged
    _check_pairs(a, res.eigenvalues, res.eigenvectors.to_global(), np.linalg.eigvalsh(a))


def test_refine_from_f32_matches_jax(grid_2x4):
    a = tu.random_hermitian_pd(N, np.float64, seed=5)
    w32, v32 = np.linalg.eigh(a.astype(np.float32))
    assert np.abs(a @ v32.astype(np.float64) - v32 * w32[None, :]).max() > 1e-8
    (jm, tm), (jv, tv) = _mats(grid_2x4, np.tril(a), v32.astype(np.float64))
    w, v, info = t_er.refine_eigenpairs("L", tm, tv)
    jw, _, jinfo = j_er.refine_eigenpairs("L", jm, jv)
    assert info.converged and jinfo.converged and info.iters == jinfo.iters
    _check_pairs(a, w, v.to_global(), np.linalg.eigvalsh(a), np.asarray(jw))


@pytest.mark.parametrize("spectrum", [(0, 11), (17, 30), (40, 47)])
def test_heev_mixed_partial_matches_jax(grid_2x4, spectrum):
    """The window's refinement by the spectral preconditioner (k <=
    max(WIDE_WINDOW_MIN, N / 2): the partial route)."""
    a = tu.random_hermitian_pd(N, np.float64, seed=31)
    (jm, tm), = _mats(grid_2x4, np.tril(a))
    res, info = t_er.hermitian_eigensolver_mixed("L", tm, spectrum=spectrum)
    jres, jinfo = j_er.hermitian_eigensolver_mixed("L", jm, spectrum=spectrum)
    il, iu = spectrum
    assert res.eigenvectors.size.cols == iu - il + 1
    assert info.converged and jinfo.converged, (info, jinfo)
    assert info.ortho_error == np.inf and info.residual <= 50 * N * np.finfo(np.float64).eps
    _check_pairs(a, res.eigenvalues, res.eigenvectors.to_global(),
                 np.linalg.eigvalsh(a)[il:iu + 1], np.asarray(jres.eigenvalues))


def test_heev_mixed_partial_cluster(grid_2x4):
    """A tight cluster inside the window (gaps ~1e-13): the mask skips the
    directions the preconditioner cannot resolve, the Rayleigh-Ritz step
    resolves them."""
    rng = np.random.default_rng(77)
    w_plant = np.linspace(1.0, 9.0, N)
    w_plant[21] = w_plant[20] + 1e-13
    w_plant[22] = w_plant[20] + 2e-13
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    a = (q * w_plant[None, :]) @ q.T
    a = (a + a.T) / 2
    (jm, tm), = _mats(grid_2x4, np.tril(a))
    res, info = t_er.hermitian_eigensolver_mixed("L", tm, spectrum=(12, 30))
    jres, _ = j_er.hermitian_eigensolver_mixed("L", jm, spectrum=(12, 30))
    assert info.converged, info
    _check_pairs(a, res.eigenvalues, res.eigenvectors.to_global(),
                 np.linalg.eigvalsh(a)[12:31], np.asarray(jres.eigenvalues))


def test_refine_partial_direct_matches_jax(grid_2x4):
    """From a host f32 basis: only n x k target-precision products, and the
    window reaches f64 accuracy."""
    a = tu.random_hermitian_pd(N, np.float64, seed=13)
    w32, v32 = np.linalg.eigh(a.astype(np.float32))
    assert np.abs(a @ v32[:, 10:30].astype(np.float64)
                  - v32[:, 10:30] * w32[None, 10:30]).max() > 1e-9
    (jm, tm), (jv, tv) = _mats(grid_2x4, np.tril(a), v32)
    w, x, info = t_er.refine_partial_eigenpairs("L", tm, tv, w32, (10, 29))
    jw, _, jinfo = j_er.refine_partial_eigenpairs("L", jm, jv, w32, (10, 29))
    assert info.converged and jinfo.converged
    assert tuple(x.size) == (N, 20)
    np.testing.assert_array_equal(tv.to_global(), v32)  # the basis is only read
    _check_pairs(a, w, x.to_global(), np.linalg.eigvalsh(a)[10:30], np.asarray(jw))


def test_heev_mixed_wide_window_route(grid_2x4, monkeypatch):
    """Windows wider than max(WIDE_WINDOW_MIN, N / 2) take the full
    refinement and a slice; out-of-range windows raise on both routes."""
    for mod in (t_er, j_er):
        monkeypatch.setattr(mod, "WIDE_WINDOW_MIN", 8)

    def forbidden(*args, **kwargs):
        raise AssertionError("the wide window took the partial route")

    partial = t_er.refine_partial_eigenpairs
    monkeypatch.setattr(t_er, "refine_partial_eigenpairs", forbidden)
    a = tu.random_hermitian_pd(N, np.float64, seed=51)
    (jm, tm), = _mats(grid_2x4, np.tril(a))
    res, info = t_er.hermitian_eigensolver_mixed("L", tm, spectrum=(10, 40))  # k = 31 > 24
    jres, _ = j_er.hermitian_eigensolver_mixed("L", jm, spectrum=(10, 40))
    assert info.converged and res.eigenvectors.size.cols == 31
    _check_pairs(a, res.eigenvalues, res.eigenvectors.to_global(),
                 np.linalg.eigvalsh(a)[10:41], np.asarray(jres.eigenvalues))
    for sp in ((-1, 40), (0, N), (5, 4)):
        with pytest.raises(ValueError, match="spectrum"):
            t_er.hermitian_eigensolver_mixed("L", tm, spectrum=sp)
    with pytest.raises(ValueError, match="spectrum"):
        partial("L", tm, tm, np.ones(N), (0, N))


def test_refine_clustered_matches_jax(grid_2x4, monkeypatch):
    """A cluster of 4 with gaps ~1e-14: the Rayleigh-Ritz rotation of the
    cluster columns (``window_extract`` / ``window_update``) takes over
    from the separated formula.  Every run is rotated, whatever its length
    (the JAX package skips runs longer than min(n, 512))."""
    sizes = []
    clusters = t_er._clusters

    def spy(lam, gap_floor, max_size):
        sizes.append(max_size)
        return clusters(lam, gap_floor, max_size)

    monkeypatch.setattr(t_er, "_clusters", spy)
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    w = np.linspace(1.0, 2.0, N)
    w[10:14] = 1.5 + np.arange(4) * 1e-14
    a = (q * w) @ q.T
    a = (a + a.T) / 2
    w32, v32 = np.linalg.eigh(a.astype(np.float32))
    (jm, tm), (jv, tv) = _mats(grid_2x4, np.tril(a), v32.astype(np.float64))
    w_out, v, info = t_er.refine_eigenpairs("L", tm, tv, max_iters=3)
    jw, _, _ = j_er.refine_eigenpairs("L", jm, jv, max_iters=3)
    assert info.converged and sizes and set(sizes) == {N}
    _check_pairs(a, w_out, v.to_global(), np.linalg.eigvalsh(a), np.asarray(jw))
    np.testing.assert_allclose(w_out, np.linalg.eigvalsh(a), rtol=0, atol=1e-12)


def test_non_convergence_is_recorded_and_raised(grid_2x4):
    """No sweep allowed: the f32 start is not converged; the stall is
    recorded, and ``raise_on_failure`` raises with the info."""
    a = tu.random_hermitian_pd(N, np.float64, seed=5)
    w32, v32 = np.linalg.eigh(a.astype(np.float32))
    (_, tm), (_, tv) = _mats(grid_2x4, np.tril(a), v32.astype(np.float64))
    with health.capture_events() as ev:
        _, _, info = t_er.refine_eigenpairs("L", tm, tv.astype(tv.dtype), max_iters=0)
    assert not info.converged and info.iters == 0
    assert [e["event"] for e in ev] == ["eig_refine_not_converged"]
    with pytest.raises(health.ConvergenceError) as err:
        t_er.refine_eigenpairs("L", tm, tv.astype(tv.dtype), max_iters=0, raise_on_failure=True)
    assert err.value.info.iters == 0 and not err.value.info.converged
    with health.capture_events() as ev, pytest.raises(health.ConvergenceError):
        t_er.refine_partial_eigenpairs("L", tm, DistributedMatrix.from_global(
            tm.grid, v32, (NB, NB)), w32, (0, 9), max_iters=0, raise_on_failure=True)
    assert [e["event"] for e in ev] == ["eig_refine_partial_not_converged"]


def test_complex_raises_with_item_5(grid_2x4):
    (_, tm), = _mats(grid_2x4, np.eye(16, dtype=np.complex128))
    with pytest.raises(NotImplementedError, match=ITEM_5):
        t_er.hermitian_eigensolver_mixed("L", tm)
    with pytest.raises(NotImplementedError, match=ITEM_5):
        t_er.refine_eigenpairs("L", tm, tm)


def test_refine_rotates_runs_longer_than_512(monkeypatch):
    """A run of 600 eigenvalues 5e-8 apart (n = 640, 1x1 grid): the port
    rotates the whole run and converges in one correction; with the JAX
    package's cap (runs longer than min(n, 512) skipped, their pairs left
    to the R/2 entries) three sweeps end short of the floor.  The JAX
    package itself is not run here: on a 1x1 grid its cluster rotation
    raises (ROADMAP.md §C)."""
    n = 640
    q, _ = np.linalg.qr(np.random.default_rng(9).standard_normal((n, n)))
    w = np.linspace(1.0, 2.0, n)
    w[20:620] = 1.5 + np.arange(600) * 5e-8
    a = (q * w) @ q.T
    a = (a + a.T) / 2
    _, v32 = np.linalg.eigh(a.astype(np.float32))
    tol = tu.tol_for(np.float64, n, 200.0)

    def refine():
        g = grid_like((1, 1))
        return t_er.refine_eigenpairs("L", DistributedMatrix.from_global(g, np.tril(a), (64, 64)),
                                      DistributedMatrix.from_global(g, v32.astype(np.float64),
                                                                    (64, 64)))

    w_out, v, info = refine()
    assert info.converged and info.iters == 1
    _check_pairs(a, w_out, v.to_global(), np.linalg.eigvalsh(a), tol=tol)
    clusters = t_er._clusters
    monkeypatch.setattr(t_er, "_clusters", lambda lam, gap_floor, max_size:
                        clusters(lam, gap_floor, min(max_size, 512)))
    _, _, capped = refine()
    assert not capped.converged and capped.ortho_error > 10 * tol

