"""The port's HEEV pipeline on multi-rank grids of rank threads against the
JAX package's on its CPU mesh, stage by stage on 2x4 and end to end on
every multi-rank shape of the JAX fixture (2x4, 4x2, 2x2, 1x2, 2x1); the
generalized eigensolver (HEGV) on 2x4 and on 1x1; and partial spectra
(HEEV and HEGV) and eigenvalues only (``hermitian_eigenvalues``) on 2x4
and 1x1.

Sizes follow ROADMAP.md's rule for multi-rank tests: N = 48, nb = 8, band
4, the SBR stage on (band 2), D&C leaves of 8 (n_pad = 64: three merge
levels and 16 padding poles), compact-WY groups of 2, the native host
chase, the secular kernel's flag on (its plain version on the CPU) and the
fused trailing-update tier, the same knobs in both packages.  Each stage's
input is the JAX package's output of the stage before on its 2x4 mesh,
carried across as numpy; the column-panel forms of the back-transforms
take the JAX package's column panels (``P(None, ('r', 'c'))``), whose
shards are first shown to be the port's per-rank panels bit for bit.

Tolerances: ``tol_for(dtype, N)`` (``dlaf_tpu/testing/__init__.py:55``)
of the error relative to the largest entry of the reference (the
frameworks sum in different orders), except the band gather and
``sub_matrix``, which are copies and are held bit for bit, and the
eigenvectors of the D&C, compared up to the sign of each column.
Residual ``max|A V - V diag(w)|`` relative to ``max|A|``, and
orthogonality ``max|V^T V - I|``, each within ``tol_for(dtype, N)``.  The
end-to-end runs are held to the eigenvalues of the JAX package's pipeline
on its 2x4 mesh (one compile per dtype).
"""
import contextlib

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import dlaf_tpu as dt
import dlaf_tpu.testing as tu
from dlaf_tpu import tune as jtune
from dlaf_tpu.algorithms import band_reduction as j_sbr
from dlaf_tpu.algorithms import band_to_tridiag as j_b2t
from dlaf_tpu.algorithms.bt_band_hh import bt_band_to_tridiagonal_hh_dist as j_bt_band
from dlaf_tpu.algorithms.bt_reduction_to_band import bt_reduction_to_band as j_bt_r2b
from dlaf_tpu.algorithms.eigensolver import hermitian_eigensolver as j_heev
from dlaf_tpu.algorithms.eigensolver import hermitian_generalized_eigensolver as j_hegv
from dlaf_tpu.algorithms.reduction_to_band import reduction_to_band as j_r2b
from dlaf_tpu.algorithms.tridiag_dc_dist import tridiag_dc_distributed as j_dc
from dlaf_tpu.matrix.util import sub_matrix as j_sub_matrix
from dlaf_tpu_torch import tune
from dlaf_tpu_torch.algorithms import band_reduction as t_sbr
from dlaf_tpu_torch.algorithms import band_to_tridiag as t_b2t
from dlaf_tpu_torch.algorithms.bt_band_hh import bt_band_to_tridiagonal_hh_dist as t_bt_band
from dlaf_tpu_torch.algorithms.bt_reduction_to_band import bt_reduction_to_band as t_bt_r2b
from dlaf_tpu_torch.algorithms.eigensolver import hermitian_eigensolver as t_heev
from dlaf_tpu_torch.algorithms.eigensolver import hermitian_generalized_eigensolver as t_hegv
from dlaf_tpu_torch.algorithms.tridiag_dc_dist import tridiag_dc_distributed as t_dc
from dlaf_tpu_torch.common import stagetimer
from dlaf_tpu_torch.matrix import colpanels as cpan
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix, carry
from dlaf_tpu_torch.matrix.util import sub_matrix as t_sub_matrix
from dlaf_tpu_torch.testing import grid_like

N, NB, BAND, B2 = 48, 8, 4, 2
KNOBS = dict(eigensolver_min_band=BAND, eigensolver_sbr_band=B2, band_chase_backend="native",
             dc_secular_pallas=True, trailing_update_impl="fused", dc_leaf_size=8,
             bt_band_hh_group_size=2)
DTYPES = [np.float32, np.float64]
MULTI = [(2, 4), (4, 2), (2, 2), (1, 2), (2, 1)]
STAGES = ["red2band", "sbr", "chase", "tridiag", "bt_band", "bt_sbr", "bt_red2band"]


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


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


def _jgrid(comm_grids, shape):
    return next(g for g in comm_grids if tuple(g.grid_size) == shape)


def check_eig(a, evals, evecs, tol):
    a64, v = a.astype(np.float64), evecs.astype(np.float64)
    res = a64 @ v - v * np.asarray(evals, np.float64)[None, :]
    assert np.max(np.abs(res)) < tol * max(1.0, np.abs(a64).max()), np.max(np.abs(res))
    ortho = v.T @ v - np.eye(v.shape[1])
    assert np.max(np.abs(ortho)) < tol, np.max(np.abs(ortho))


def _jmat(grid, data, dist):
    """A fresh JAX package matrix of the stacked numpy ``data`` (the JAX
    stages may donate their input)."""
    return dt.DistributedMatrix(dist, grid, jax.device_put(data, grid.stacked_sharding()))


def _cols(jcols):
    """The JAX package's column panels, global numpy ``[n_pad, kpad]``."""
    return np.asarray(jcols.data)


@pytest.fixture(scope="module", params=DTYPES, ids=["f32", "f64"])
def ref(request, grid_2x4):
    """The JAX package's pipeline on its 2x4 mesh, stage by stage (numpy,
    both forms of every back-transform), and end to end."""
    dtype = request.param
    out = {"dtype": dtype}
    a = tu.random_hermitian_pd(N, dtype, seed=5)
    out["a"] = a
    g = grid_2x4
    with knobs(**KNOBS):
        jm = dt.DistributedMatrix.from_global(g, np.tril(a), (NB, NB))
        band_mat, taus = j_r2b(jm, band=BAND)
        out["band_data"], out["band_dist"] = np.asarray(band_mat.data), band_mat.dist
        out["taus"] = np.asarray(taus)
        ab = j_b2t.extract_band_storage(band_mat, BAND)
        ab2, tr = j_sbr.sbr_reduce(ab, BAND, B2)
        out["ab"], out["tr"] = ab, tr
        hh = j_b2t.band_to_tridiagonal_hh_storage(ab2, B2, np.dtype(dtype))
        out["hh"] = hh
        w, v = j_dc(g, hh[0], hh[1], NB, dtype=dtype)
        out["v_data"], out["v_dist"] = np.asarray(v.data), v.dist
        cols1 = j_bt_band(hh, _jmat(g, out["v_data"], v.dist), out_cols=True)
        out["cols1"] = _cols(cols1)
        out["cols1_shards"] = {
            tuple(int(i) for i in np.argwhere(g.mesh.devices == s.device)[0]): np.asarray(s.data)
            for s in cols1.data.addressable_shards}
        out["e1"] = np.asarray(j_bt_band(hh, _jmat(g, out["v_data"], v.dist)).data)
        cols2 = j_sbr.sbr_back_transform(tr, cols1, out_cols=True)
        out["cols2"] = _cols(cols2)
        out["e2"] = np.asarray(j_sbr.sbr_back_transform(tr, _jmat(g, out["e1"], v.dist)).data)
        out["e3_from_cols"] = j_bt_r2b(cols2, band_mat, taus).to_global()
        out["e3"] = j_bt_r2b(_jmat(g, out["e2"], v.dist), band_mat, taus).to_global()
        res = j_heev("L", dt.DistributedMatrix.from_global(g, np.tril(a), (NB, NB)),
                     backend="pipeline")
        out["heev_w"] = res.eigenvalues
    return out


def _tol(ref):
    return tu.tol_for(ref["dtype"], N)


def _port_tr(ref):
    """The JAX package's SBR transforms as the port's (chunks on the CPU)."""
    jt = ref["tr"]
    return t_sbr.SbrTransforms([(s, torch.from_numpy(np.array(q))) for s, q in jt.chunks],
                               jt.n, jt.b1, jt.b2)


def _port_cols(ref, key, dist):
    """The JAX package's column panels ``ref[key]`` as the port's."""
    return cpan.from_global(torch.from_numpy(np.array(ref[key])), N, N, grid_like((2, 4)), dist)


def test_band_gather_matches_jax(ref):
    """The band of the JAX package's 2x4 band matrix, gathered from its
    owners' tiles: bit for bit."""
    band_mat = carry(grid_like((2, 4)), ref["band_data"], ref["band_dist"])
    ab = t_b2t.extract_band_storage(band_mat, BAND)
    assert np.array_equal(ab.numpy(), ref["ab"])


def test_column_panels_are_the_jax_shards(ref):
    """Rank (r, c)'s panel is the shard of the JAX package's column panels
    on mesh device (r, c), bit for bit: the flat order r * Pc + c."""
    dist = carry(grid_like((2, 4)), ref["v_data"], ref["v_dist"]).dist
    cp = _port_cols(ref, "cols1", dist)
    assert set(ref["cols1_shards"]) == {(r, c) for r in range(2) for c in range(4)}
    for (r, c), shard in ref["cols1_shards"].items():
        np.testing.assert_array_equal(cp.data[r, c].numpy(), shard)
    np.testing.assert_array_equal(cpan.to_global(cp).numpy(), ref["cols1"][:N, :N])


def test_back_transforms_match_jax(ref):
    """bt_band, bt_sbr and bt_red2band on 2x4, each on the JAX package's
    input and in both forms: stacked in and out, and column panels."""
    tol = _tol(ref)
    grid = grid_like((2, 4))
    v = carry(grid, ref["v_data"], ref["v_dist"])
    dist = v.dist
    band_mat = carry(grid, ref["band_data"], ref["band_dist"])
    taus = carry(grid, ref["taus"])
    with knobs(**KNOBS):
        e1 = t_bt_band(ref["hh"], carry(grid, ref["v_data"], ref["v_dist"]))
        assert _rel(e1.data.numpy(), ref["e1"]) <= tol
        c1 = t_bt_band(ref["hh"], v, out_cols=True)
        assert isinstance(c1, cpan.ColPanels) and tuple(c1.data.shape[:2]) == (2, 4)
        assert _rel(cpan.to_global(c1).numpy(), ref["cols1"][:N, :N]) <= tol
        e2 = t_sbr.sbr_back_transform(_port_tr(ref), carry(grid, ref["e1"], ref["v_dist"]))
        assert _rel(e2.data.numpy(), ref["e2"]) <= tol
        c2 = t_sbr.sbr_back_transform(_port_tr(ref), _port_cols(ref, "cols1", dist), out_cols=True)
        assert _rel(cpan.to_global(c2).numpy(), ref["cols2"][:N, :N]) <= tol
        e3 = t_bt_r2b(carry(grid, ref["e2"], ref["v_dist"]), band_mat, taus)
        assert _rel(e3.to_global(), ref["e3"]) <= tol
        e3c = t_bt_r2b(_port_cols(ref, "cols2", dist), band_mat, taus)
        assert _rel(e3c.to_global(), ref["e3_from_cols"]) <= tol


def _gapped_tridiagonal(n, seed):
    """(d, e) of a symmetric matrix with eigenvalues 1..n (gaps of 1)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    h = sla.hessenberg(q @ np.diag(np.arange(1.0, n + 1)) @ q.T)
    return np.diag(h).copy(), np.diag(h, -1).copy()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_tridiag_dc_matches_jax_on_2x4(grid_2x4, dtype):
    """The D&C on 2x4 (three merge levels, padding poles, B10's flag on in
    both packages) on a spectrum with gaps: eigenvalues, and eigenvectors
    up to column sign, against the JAX package's on its 2x4 mesh and
    against the port's own on 1x1, each at tol_for."""
    d, e = (x.astype(dtype) for x in _gapped_tridiagonal(N, seed=7))
    with knobs(**KNOBS):
        jw, jv = j_dc(grid_2x4, d, e, NB, dtype=dtype)
        tw, tv = t_dc(grid_like((2, 4)), d, e, NB, dtype=dtype)
        ow, ov = t_dc(grid_like((1, 1)), d, e, NB, dtype=dtype)
    tol = tu.tol_for(dtype, N)
    tv = tv.to_global()
    for w_ref, v_ref in ((jw, jv.to_global()), (ow, ov.to_global())):
        assert _rel(tw, w_ref) <= tol
        sign = np.sign(np.sum(v_ref.astype(np.float64) * tv, axis=0))
        assert _rel(tv * sign, v_ref) <= tol


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_tridiag_dc_deflation_rotations_on_2x4(dtype):
    """Repeated eigenvalues make the merges rotate close poles (the (P G)
    pass, its panels summed over 'c' like the U pass's): eigenvalues
    against LAPACK, residual and orthogonality at tol_for."""
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    lam = np.repeat(np.arange(1.0, N // 4 + 1), 4)
    h = sla.hessenberg(q @ np.diag(lam) @ q.T)
    d, e = np.diag(h).astype(dtype), np.diag(h, -1).astype(dtype)
    with knobs(**KNOBS):
        w, v = t_dc(grid_like((2, 4)), d, e, NB, dtype=dtype)
    tol = tu.tol_for(dtype, N)
    assert _rel(w, lam) <= tol
    tri = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    check_eig(tri, w, v.to_global(), tol)


@pytest.mark.parametrize("shape", MULTI, ids=[f"{r}x{c}" for r, c in MULTI])
def test_pipeline_matches_jax(ref, shape):
    """hermitian_eigensolver(backend='pipeline') on every multi-rank shape:
    eigenvalues against the JAX package's, residual and orthogonality, and
    every stage clocked."""
    a = ref["a"]
    mat = DistributedMatrix.from_global(grid_like(shape), np.tril(a), (NB, NB))
    with knobs(**KNOBS):
        stagetimer.start()
        res = t_heev("L", mat, backend="pipeline")
        times = stagetimer.stop()
    assert list(times) == STAGES
    assert tuple(res.eigenvectors.data.shape[:2]) == shape
    tol = _tol(ref)
    assert _rel(res.eigenvalues, ref["heev_w"]) <= tol
    check_eig(a, res.eigenvalues, res.eigenvectors.to_global(), tol)


def test_upper_storage_and_auto_on_2x4(ref):
    """'U' with ``backend='auto'``: the upper triangle runs through the
    hermitized mirror, and 'auto' takes the pipeline on a multi-rank grid
    (the JAX package's rule), so every stage runs."""
    a = ref["a"]
    mat = DistributedMatrix.from_global(grid_like((2, 4)), np.triu(a), (NB, NB))
    with knobs(**KNOBS):
        stagetimer.start()
        res = t_heev("U", mat, backend="auto")
        times = stagetimer.stop()
    assert list(times) == STAGES
    tol = _tol(ref)
    assert _rel(res.eigenvalues, ref["heev_w"]) <= tol
    check_eig(a, res.eigenvalues, res.eigenvectors.to_global(), tol)


@pytest.mark.parametrize("shape", MULTI + [(1, 1)])
def test_sub_matrix_matches_jax(comm_grids, shape):
    """``sub_matrix`` at an origin off the tile grid, against the JAX
    package's (``window_extract`` on its multi-rank meshes): the same
    distribution and the same stacked tiles, bit for bit."""
    a = np.arange(21 * 23, dtype=np.float64).reshape(21, 23)
    jgrid = _jgrid(comm_grids, shape)
    want = j_sub_matrix(dt.DistributedMatrix.from_global(jgrid, a, (4, 4)), (3, 5), (13, 11))
    got = t_sub_matrix(DistributedMatrix.from_global(grid_like(shape), a, (4, 4)), (3, 5), (13, 11))
    assert tuple(got.dist.size) == tuple(want.dist.size)
    assert tuple(got.dist.source_rank) == tuple(want.dist.source_rank)
    np.testing.assert_array_equal(got.to_stacked(), np.asarray(want.data))


# ------------------------------------------------------------------- HEGV

_JAX_HEGV: dict = {}


def _hegv_inputs():
    return (tu.random_hermitian_pd(N, np.float64, seed=5),
            tu.random_hermitian_pd(N, np.float64, seed=6))


def check_generalized(a, b, evals, evecs, tol):
    """Residual ``max|A V - B V diag(w)|`` relative to ``max|A| + max|B|
    max|w|`` and B-orthogonality ``max|V^T B V - I|``."""
    w = np.asarray(evals, np.float64)
    res = a @ evecs - (b @ evecs) * w[None, :]
    scale = np.abs(a).max() + np.abs(b).max() * np.abs(w).max()
    assert np.max(np.abs(res)) < tol * scale, np.max(np.abs(res))
    ortho = evecs.T @ b @ evecs - np.eye(evecs.shape[1])
    assert np.max(np.abs(ortho)) < tol, np.max(np.abs(ortho))


def _jax_hegv_w(grid):
    """The JAX package's generalized eigenvalues (L, f64) on ``grid``."""
    key = tuple(grid.grid_size)
    if key not in _JAX_HEGV:
        a, b = _hegv_inputs()
        with knobs(**KNOBS):
            _JAX_HEGV[key] = j_hegv("L", dt.DistributedMatrix.from_global(grid, np.tril(a), (NB, NB)),
                                    dt.DistributedMatrix.from_global(grid, np.tril(b), (NB, NB))
                                    ).eigenvalues
    return _JAX_HEGV[key]


@pytest.mark.parametrize("uplo,factorized", [("L", False), ("U", False), ("L", True)],
                         ids=["L", "U", "L-factorized"])
def test_generalized_eigensolver_on_2x4(grid_2x4, uplo, factorized):
    """hermitian_generalized_eigensolver on the 2x4 grid (the pipeline:
    every stage over the grid) from either triangle, and from B's factor:
    the eigenvalues against the JAX package's on its 2x4 mesh, the
    generalized residual and the B-orthogonality within tol_for(f64, N),
    every stage clocked, A not modified."""
    a, b = _hegv_inputs()
    tri = np.tril if uplo == "L" else np.triu
    w_ref = _jax_hegv_w(grid_2x4)
    grid = grid_like((2, 4))
    mat_a = DistributedMatrix.from_global(grid, tri(a), (NB, NB))
    mat_b = DistributedMatrix.from_global(grid, tri(b), (NB, NB))
    with knobs(**KNOBS):
        if factorized:
            from dlaf_tpu_torch.algorithms.cholesky import cholesky_factorization

            mat_b = cholesky_factorization(uplo, mat_b)
        stagetimer.start()
        res = t_hegv(uplo, mat_a, mat_b, factorized=factorized)
        times = stagetimer.stop()
    assert list(times) == ["cholesky_b", "gen_to_std", *STAGES, "back_subst"]
    np.testing.assert_array_equal(mat_a.to_global(), tri(a))
    tol = tu.tol_for(np.float64, N)
    assert _rel(res.eigenvalues, w_ref) <= tol
    assert tuple(res.eigenvectors.data.shape[:2]) == (2, 4)
    check_generalized(a, b, res.eigenvalues, res.eigenvectors.to_global(), tol)


def test_generalized_eigensolver_auto_on_1x1(comm_grids):
    """The 1x1 grid's route (the dense Cholesky, the dense solves and one
    ``torch.linalg.eigh``), against the JAX package's on its 1x1 grid, with
    the fused backend asked for (a 1x1 grid takes the composed one)."""
    a, b = _hegv_inputs()
    w_ref = _jax_hegv_w(_jgrid(comm_grids, (1, 1)))
    mats = [DistributedMatrix.from_global(grid_like((1, 1)), np.tril(v), (NB, NB)) for v in (a, b)]
    with knobs(**KNOBS, gen_to_std_backend="fused"):
        res = t_hegv("L", *mats)
    tol = tu.tol_for(np.float64, N)
    assert _rel(res.eigenvalues, w_ref) <= tol
    assert _rel(res.eigenvalues, sla.eigh(a, b, eigvals_only=True)) <= tol
    check_generalized(a, b, res.eigenvalues, res.eigenvectors.to_global(), tol)


SPECTRA = [(0, 11), (17, 30), (40, 47)]


@pytest.mark.parametrize("spectrum", SPECTRA, ids=[f"{il}-{iu}" for il, iu in SPECTRA])
def test_partial_spectrum_matches_jax(ref, spectrum):
    """``spectrum=(il, iu)`` on 2x4: the D&C's eigenvectors cut to the k
    columns, the three back-transforms on those; the eigenvalues against
    the window of the JAX package's pipeline on its 2x4 mesh (its partial
    spectrum cuts the same D&C solve), every stage clocked."""
    a = ref["a"]
    il, iu = spectrum
    mat = DistributedMatrix.from_global(grid_like((2, 4)), np.tril(a), (NB, NB))
    with knobs(**KNOBS):
        stagetimer.start()
        res = t_heev("L", mat, spectrum=spectrum)
        times = stagetimer.stop()
    assert list(times) == STAGES
    assert tuple(res.eigenvectors.size) == (N, iu - il + 1)
    tol = _tol(ref)
    assert _rel(res.eigenvalues, ref["heev_w"][il:iu + 1]) <= tol
    check_eig(a, res.eigenvalues, res.eigenvectors.to_global(), tol)


@pytest.mark.parametrize("spectrum", [None, (5, 20)], ids=["all", "5-20"])
def test_partial_spectrum_on_1x1_and_hegv(comm_grids, spectrum):
    """The 1x1 route (one ``torch.linalg.eigh``, its columns cut) and HEGV
    with a window on 2x4, against the JAX package's."""
    a, b = _hegv_inputs()
    sl = slice(None) if spectrum is None else slice(spectrum[0], spectrum[1] + 1)
    w_all = np.linalg.eigvalsh(a)
    mat = DistributedMatrix.from_global(grid_like((1, 1)), np.tril(a), (NB, NB))
    jmat = dt.DistributedMatrix.from_global(_jgrid(comm_grids, (1, 1)), np.tril(a), (NB, NB))
    tol = tu.tol_for(np.float64, N)
    with knobs(**KNOBS):
        res = t_heev("L", mat, spectrum=spectrum)
        jw = j_heev("L", jmat, spectrum=spectrum).eigenvalues
        assert _rel(res.eigenvalues, jw) <= tol and _rel(res.eigenvalues, w_all[sl]) <= tol
        check_eig(a, res.eigenvalues, res.eigenvectors.to_global(), tol)
        if spectrum is None:
            return
        g = _jgrid(comm_grids, (2, 4))
        mats = [DistributedMatrix.from_global(grid_like((2, 4)), np.tril(v), (NB, NB))
                for v in (a, b)]
        res = t_hegv("L", *mats, spectrum=spectrum)
        jw = j_hegv("L", *(dt.DistributedMatrix.from_global(g, np.tril(v), (NB, NB))
                           for v in (a, b)), spectrum=spectrum).eigenvalues
    assert tuple(res.eigenvectors.size) == (N, spectrum[1] - spectrum[0] + 1)
    assert _rel(res.eigenvalues, jw) <= tol
    assert _rel(res.eigenvalues, sla.eigh(a, b, eigvals_only=True)[sl]) <= tol
    check_generalized(a, b, res.eigenvalues, res.eigenvectors.to_global(), tol)


@pytest.mark.parametrize("shape", [(2, 4), (1, 1)])
@pytest.mark.parametrize("uplo,spectrum", [("L", None), ("U", (3, 40))])
def test_eigenvalues_only_match_jax(comm_grids, shape, uplo, spectrum):
    """``hermitian_eigenvalues``: red2band, the SBR stage and the rotation
    chase with no transform, then LAPACK's tridiagonal solver (``eigh`` on
    1x1), against the JAX package's and LAPACK's."""
    from dlaf_tpu.algorithms.eigensolver import hermitian_eigenvalues as j_eigvals
    from dlaf_tpu_torch.algorithms.eigensolver import hermitian_eigenvalues as t_eigvals

    a = tu.random_hermitian_pd(N, np.float64, seed=5)
    tri = np.tril(a) if uplo == "L" else np.triu(a)
    sl = slice(None) if spectrum is None else slice(spectrum[0], spectrum[1] + 1)
    with knobs(**KNOBS):
        stagetimer.start()
        w = t_eigvals(uplo, DistributedMatrix.from_global(grid_like(shape), tri, (NB, NB)),
                      spectrum=spectrum)
        times = stagetimer.stop()
        jw = j_eigvals(uplo, dt.DistributedMatrix.from_global(_jgrid(comm_grids, shape), tri,
                                                              (NB, NB)), spectrum=spectrum)
    if shape != (1, 1):
        assert list(times) == ["red2band", "sbr", "chase"]
    tol = tu.tol_for(np.float64, N)
    assert _rel(w, jw) <= tol
    assert _rel(w, np.linalg.eigvalsh(a)[sl]) <= tol
