"""The port's HEEV pipeline against the JAX package's, stage by stage and
end to end, on the 1x1 grid at a small size with the same knobs in both
packages: band 8 below nb=16, the SBR stage on (band 4), the native host
chase, the secular kernel flag on, the fused trailing-update tier, D&C
leaves of 16 (three merge levels), compact-WY groups of 4.

Each stage's input is the JAX package's output of the stage before,
carried across as numpy (``DistributedMatrix.from_stacked`` and the
``carry`` helper), so every stage is held to the reference on the same
input.  Tolerance: ``tol_for(dtype, N)`` (``dlaf_tpu/testing/__init__.py:55``)
of the error relative to the largest entry of the reference, except where
a test states otherwise: the frameworks sum in different orders.
"""
import contextlib

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
from dlaf_tpu.algorithms.reduction_to_band import reduction_to_band as j_r2b
from dlaf_tpu.algorithms.tridiag_dc_dist import tridiag_dc_distributed as j_dc
from dlaf_tpu_torch import health, native, tune
from dlaf_tpu_torch.algorithms import band_reduction as t_sbr
from dlaf_tpu_torch.algorithms import band_to_tridiag as t_b2t
from dlaf_tpu_torch.algorithms.bt_band_hh import bt_band_to_tridiagonal_hh_dist as t_bt_band
from dlaf_tpu_torch.algorithms.bt_reduction_to_band import bt_reduction_to_band as t_bt_r2b
from dlaf_tpu_torch.algorithms.eigensolver import hermitian_eigensolver as t_heev
from dlaf_tpu_torch.algorithms.eigensolver import hermitian_generalized_eigensolver as t_hegv
from dlaf_tpu_torch.algorithms.reduction_to_band import get_band_size, reduction_to_band as t_r2b
from dlaf_tpu_torch.algorithms.tridiag_dc_dist import tridiag_dc_distributed as t_dc
from dlaf_tpu_torch.algorithms.tridiag_solver import tridiagonal_eigensolver
from dlaf_tpu_torch.comm.grid import Grid
from dlaf_tpu_torch.common import stagetimer
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix, carry
from dlaf_tpu_torch.ops import trailing_update

N, NB, BAND, B2 = 112, 16, 8, 4
KNOBS = dict(eigensolver_min_band=BAND, eigensolver_sbr_band=B2, band_chase_backend="native",
             dc_secular_pallas=True, trailing_update_impl="fused", dc_leaf_size=16,
             bt_band_hh_group_size=4)
DTYPES = [np.float32, np.float64]


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


def _cpu():
    return Grid.create(device="cpu")


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


def _dense_band(ab, b, n):
    """Symmetric dense matrix of compact lower-band storage."""
    a = np.zeros((n, n))
    for d in range(b + 1):
        a[np.arange(d, n), np.arange(n - d)] = ab[d, : n - d]
    return np.tril(a) + np.tril(a, -1).T


def check_eig(a, evals, evecs, tol):
    """Residual and orthogonality, as the JAX package's check_eig, at the
    stated tolerance (max-entry norms)."""
    n = a.shape[0]
    a64, v = a.astype(np.float64), evecs.astype(np.float64)
    res = a64 @ v - v * np.asarray(evals, np.float64)[None, :]
    assert np.max(np.abs(res)) < tol * max(1.0, np.abs(a64).max()), np.max(np.abs(res))
    ortho = v.T @ v - np.eye(n)
    assert np.max(np.abs(ortho)) < tol, np.max(np.abs(ortho))


@pytest.fixture(scope="module", params=DTYPES, ids=["f32", "f64"])
def ref(request, grid_1x1):
    """The JAX package's pipeline at (N, NB), stage by stage (numpy), and
    end to end."""
    dtype = request.param
    out = {"dtype": dtype}
    a = tu.random_hermitian_pd(N, dtype, seed=5)
    out["a"] = a
    with knobs(**KNOBS):
        jm = dt.DistributedMatrix.from_global(grid_1x1, np.tril(a), (NB, NB))
        out["a_data"], out["a_dist"] = np.asarray(jm.data), jm.dist
        band_mat, taus = j_r2b(jm, band=BAND)
        out["band_data"], out["band_dist"] = np.asarray(band_mat.data), band_mat.dist
        out["taus"] = np.asarray(taus)
        ab = j_b2t.extract_band_storage(band_mat, BAND)
        out["ab"] = ab
        ab2, tr = j_sbr.sbr_reduce(ab, BAND, B2)
        out["ab2"], out["tr"] = ab2, tr
        hh = j_b2t.band_to_tridiagonal_hh_storage(ab2, B2, np.dtype(dtype))
        out["hh"] = hh
        w, v = j_dc(grid_1x1, hh[0], hh[1], NB, dtype=dtype)
        out["w"], out["v_data"], out["v_dist"] = w, np.asarray(v.data), v.dist
        e1 = j_bt_band(hh, v)
        out["e1_data"] = np.array(e1.data)
        e2 = j_sbr.sbr_back_transform(tr, e1)
        out["e2_data"] = np.array(e2.data)
        e3 = j_bt_r2b(e2, band_mat, taus)
        out["e3"] = e3.to_global()
        res = j_heev("L", dt.DistributedMatrix.from_global(grid_1x1, np.tril(a), (NB, NB)),
                     backend="pipeline")
        out["heev_w"], out["heev_v"] = res.eigenvalues, res.eigenvectors.to_global()
    return out


def _tol(ref):
    return tu.tol_for(ref["dtype"], N)


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_reduction_to_band_matches_jax(ref, grid_1x1, impl):
    mat = carry(_cpu(), ref["a_data"], ref["a_dist"])
    if impl == "fused":
        want_band, want_taus = ref["band_data"], ref["taus"]
    else:
        with knobs(**{**KNOBS, "trailing_update_impl": "xla"}):
            jm = dt.DistributedMatrix.from_global(grid_1x1, np.tril(ref["a"]), (NB, NB))
            jb, jt = j_r2b(jm, band=BAND)
            want_band, want_taus = np.asarray(jb.data), np.asarray(jt)
    with knobs(**{**KNOBS, "trailing_update_impl": impl}):
        before = trailing_update.launches
        band_mat, taus = t_r2b(mat, band=BAND)
    assert trailing_update.launches == before  # CPU: the plain version
    assert _rel(np.tril(band_mat.to_global()), np.tril(carry(_cpu(), want_band, ref["band_dist"]).to_global())) <= _tol(ref)
    assert _rel(taus.numpy(), want_taus) <= _tol(ref)
    assert np.array_equal(mat.to_global(), np.asarray(np.tril(ref["a"])))  # input untouched


def test_extract_band_storage_matches_jax(ref):
    band_mat = carry(_cpu(), ref["band_data"], ref["band_dist"])
    ab = t_b2t.extract_band_storage(band_mat, BAND)
    assert np.array_equal(ab.numpy(), ref["ab"])


def test_sbr_reduce_matches_jax(ref):
    """The reduced band at tol_for; the Q chunks have the JAX chunks' layout
    and, applied as a similarity, reproduce the input band at tol_for.  Each
    Q is the QR of a block the earlier steps computed in another summation
    order, and the QR amplifies that difference by the block's condition,
    so Q entries are held at 10 tol_for."""
    ab2, tr = t_sbr.sbr_reduce(carry(_cpu(), ref["ab"]), BAND, B2)
    tol = _tol(ref)
    assert _rel(ab2, ref["ab2"]) <= tol and not np.any(ab2[B2 + 1])
    assert [(s, tuple(q.shape)) for s, q in tr.chunks] == [(s, q.shape) for s, q in ref["tr"].chunks]
    for (_, q), (_, jq) in zip(tr.chunks, ref["tr"].chunks):
        assert _rel(q.numpy(), jq) <= 10 * tol
    eye = DistributedMatrix.from_global(_cpu(), np.eye(N, dtype=ref["dtype"]), (NB, NB))
    q = t_sbr.sbr_back_transform(tr, eye).to_global().astype(np.float64)
    b1 = _dense_band(ref["ab"].astype(np.float64), BAND, N)
    assert _rel(q @ _dense_band(ab2.astype(np.float64), B2, N) @ q.T, b1) <= tol


def test_chase_matches_jax_native(ref):
    """The port's build of the chase against the JAX package's build:
    bitwise where the two builds agree; else the tridiagonals' eigenvalues
    agree at tol_for and the port's reflectors reproduce the band at
    tol_for (the reduction is backward stable; its entries are not forward
    stable, and the builds' flags differ)."""
    from dlaf_tpu.native import band2trid_hh as jax_native

    ab2 = ref["ab2"]
    mine = native.band2trid_hh(ab2, B2)
    theirs = jax_native(ab2, B2)
    if all(np.array_equal(x, y) for x, y in zip(mine, theirs)):
        return
    tol = _tol(ref)
    d, e, v, tau = mine
    w_mine = sla.eigh_tridiagonal(d.astype(np.float64), e.astype(np.float64), eigvals_only=True)
    w_theirs = sla.eigh_tridiagonal(theirs[0].astype(np.float64), theirs[1].astype(np.float64),
                                    eigvals_only=True)
    assert _rel(w_mine, w_theirs) <= tol
    hh = (d, e, np.ones(N, ref["dtype"]), v, tau, B2)
    eye = DistributedMatrix.from_global(_cpu(), np.eye(N, dtype=ref["dtype"]), (NB, NB))
    q = t_bt_band(hh, eye, group_size=4).to_global().astype(np.float64)
    tri = np.diag(d.astype(np.float64)) + np.diag(e.astype(np.float64), 1) + np.diag(e.astype(np.float64), -1)
    assert _rel(q @ tri @ q.T, _dense_band(ab2.astype(np.float64), B2, N)) <= tol


def _gapped_tridiagonal(n, seed):
    """(d, e) of a symmetric matrix with eigenvalues 1..n (gaps of 1)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    h = sla.hessenberg(q @ np.diag(np.arange(1.0, n + 1)) @ q.T)
    return np.diag(h).copy(), np.diag(h, -1).copy()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_tridiag_dc_matches_jax(grid_1x1, dtype):
    """Several merge levels (leaves of 16), B10's flag on in both packages,
    on a spectrum with gaps: eigenvalues, and eigenvectors up to column
    sign, at tol_for."""
    d, e = (x.astype(dtype) for x in _gapped_tridiagonal(N, seed=7))
    with knobs(**KNOBS):
        jw, jv = j_dc(grid_1x1, d, e, NB, dtype=dtype)
        tw, tv = t_dc(_cpu(), d, e, NB, dtype=dtype)
    jv, tv = jv.to_global(), tv.to_global()
    tol = tu.tol_for(dtype, N)
    assert _rel(tw, jw) <= tol
    sign = np.sign(np.sum(jv.astype(np.float64) * tv, axis=0))
    assert _rel(tv * sign, jv) <= tol


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_tridiag_dc_deflation_rotations(dtype):
    """A spectrum with repeated eigenvalues makes the merges rotate close
    poles (the (P G) pass): eigenvalues against LAPACK, residual and
    orthogonality at tol_for."""
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    lam = np.repeat(np.arange(1.0, N // 4 + 1), 4)
    h = sla.hessenberg(q @ np.diag(lam) @ q.T)
    d, e = np.diag(h).astype(dtype), np.diag(h, -1).astype(dtype)
    with knobs(**KNOBS):
        w, v = t_dc(_cpu(), d, e, NB, dtype=dtype)
    tol = tu.tol_for(dtype, N)
    assert _rel(w, lam) <= tol
    tri = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    check_eig(tri, w, v.to_global(), tol)


def test_tridiag_dc_eigenvalues_of_the_pipeline(ref):
    with knobs(**KNOBS):
        w, _ = tridiagonal_eigensolver(_cpu(), ref["hh"][0], ref["hh"][1], NB, dtype=ref["dtype"])
    assert _rel(w, ref["w"]) <= _tol(ref)


def test_back_transforms_match_jax(ref):
    """bt_band, bt_sbr and bt_red2band, each on the JAX package's input."""
    tol = _tol(ref)
    v = carry(_cpu(), ref["v_data"], ref["v_dist"])
    with knobs(**KNOBS):
        e1 = t_bt_band(ref["hh"], v)
        assert _rel(e1.data.numpy(), ref["e1_data"]) <= tol
        e2 = t_sbr.sbr_back_transform(_port_tr(ref), carry(_cpu(), ref["e1_data"], ref["v_dist"]))
        assert _rel(e2.data.numpy(), ref["e2_data"]) <= tol
        band_mat = carry(_cpu(), ref["band_data"], ref["band_dist"])
        e3 = t_bt_r2b(carry(_cpu(), ref["e2_data"], ref["v_dist"]), band_mat, carry(_cpu(), ref["taus"]))
        assert _rel(e3.to_global(), ref["e3"]) <= tol


def _port_tr(ref):
    """The JAX package's SBR transforms as the port's (chunks on the CPU)."""
    jt = ref["tr"]
    return t_sbr.SbrTransforms([(s, torch.from_numpy(np.array(q))) for s, q in jt.chunks], jt.n, jt.b1, jt.b2)


def test_pipeline_matches_jax(ref):
    """hermitian_eigensolver(backend='pipeline'): eigenvalues against the
    JAX package's, residual and orthogonality at tol_for(dtype, N)."""
    a = ref["a"]
    mat = DistributedMatrix.from_global(_cpu(), np.tril(a), (NB, NB))
    with knobs(**KNOBS):
        stagetimer.start()
        res = t_heev("L", mat, backend="pipeline")
        times = stagetimer.stop()
    assert list(times) == ["red2band", "sbr", "chase", "tridiag", "bt_band", "bt_sbr", "bt_red2band"]
    tol = _tol(ref)
    assert _rel(res.eigenvalues, ref["heev_w"]) <= tol
    check_eig(a, res.eigenvalues, res.eigenvectors.to_global(), tol)
    check_eig(a, ref["heev_w"], ref["heev_v"], tol)


@pytest.mark.parametrize("backend", ["pipeline", "auto"])
def test_upper_storage_and_auto(backend):
    a = tu.random_hermitian_pd(48, np.float64, seed=9)
    mat = DistributedMatrix.from_global(_cpu(), np.triu(a), (16, 16))
    with knobs(**KNOBS):
        res = t_heev("U", mat, backend=backend)
    tol = tu.tol_for(np.float64, 48)
    assert _rel(res.eigenvalues, np.linalg.eigvalsh(a)) <= tol
    check_eig(a, res.eigenvalues, res.eigenvectors.to_global(), tol)


#: what every message of a HEEV stage left to port names: its ROADMAP item
ITEM_5 = r"ROADMAP\.md §A, item 5: the rest of the eigensolver"


def test_accelerator_defaults_and_guards():
    tp = tune.get_tune_parameters()
    assert (tp.dc_leaf_size, tp.eigensolver_matmul_precision) == (512, "float32")
    with knobs(eigensolver_min_band=-1):
        assert get_band_size(512, "cuda") == 128 and get_band_size(256, "cpu") == 64
    with knobs(band_chase_backend="auto"):
        assert t_b2t.resolve_chase_backend("cpu") == "native"
        with pytest.raises(NotImplementedError, match=ITEM_5):
            t_b2t.resolve_chase_backend("cuda")
    with knobs(band_chase_backend="device"):
        with pytest.raises(NotImplementedError, match=ITEM_5):
            t_b2t.resolve_chase_backend("cpu")
    with pytest.raises(health.ConfigurationError, match="ROADMAP"):
        tp.update(eigensolver_matmul_precision="high")
    with pytest.raises(health.ConfigurationError):
        tp.update(band_chase_backend="gpu")
    for backend in ("dc", "host"):
        with pytest.raises(NotImplementedError, match=ITEM_5):
            tridiagonal_eigensolver(_cpu(), np.ones(4), np.ones(3), 2, backend=backend)
    mat = DistributedMatrix.from_global(_cpu(), np.eye(8), (4, 4))
    for kw in ({"checkpoint_every": 1}, {"checkpoint_path": "ck"}, {"resume_from": "ck"}):
        with pytest.raises(NotImplementedError, match=ITEM_5) as err:
            t_r2b(mat, **kw)
        assert "item 7: robustness, observability, plan" in str(err.value)
    # item 4: the matmul precision hints other than full float32
    with pytest.raises(health.ConfigurationError, match="queue A item 4"):
        tp.update(eigensolver_matmul_precision="high")
    with pytest.raises(health.ConfigurationError, match="queue A item 4"):
        with tune.matmul_precision("bfloat16"):
            pass
    for p in tune.MATMUL_PRECISIONS:
        with tune.matmul_precision(p):
            pass
    # item 5: complex dtypes, in every eigensolver entry point
    from dlaf_tpu_torch.algorithms import eig_refine as t_er
    from dlaf_tpu_torch.algorithms.eigensolver import hermitian_eigenvalues as t_eigvals

    mc = mat.astype(np.complex128)
    for name, call in (("hermitian_eigensolver", lambda: t_heev("L", mc)),
                       ("hermitian_eigenvalues", lambda: t_eigvals("L", mc)),
                       ("hermitian_generalized_eigensolver", lambda: t_hegv("L", mc, mc.astype(mc.dtype))),
                       ("hermitian_eigensolver_mixed", lambda: t_er.hermitian_eigensolver_mixed("L", mc)),
                       ("refine_eigenpairs", lambda: t_er.refine_eigenpairs("L", mc, mc)),
                       ("refine_partial_eigenpairs",
                        lambda: t_er.refine_partial_eigenpairs("L", mc, mc, np.ones(8), (0, 3)))):
        with pytest.raises(NotImplementedError, match=ITEM_5) as err:
            call()
        assert name in str(err.value)
    # partial spectra are ported: only a window outside [0, n) raises
    for sp in ((-1, 3), (0, 8), (5, 4)):
        with pytest.raises(ValueError, match="spectrum"):
            t_heev("L", mat, spectrum=sp)
        with pytest.raises(ValueError, match="spectrum"):
            t_hegv("L", mat, mat.astype(mat.dtype), spectrum=sp)



def test_tridiagonal_eigensolver_names_the_first_non_finite_eigenvalue(monkeypatch):
    from dlaf_tpu_torch.algorithms import tridiag_dc_dist

    def broken(grid, d, e, block_size, dtype=np.float64, spectrum=None):
        return np.array([1.0, 2.0, np.nan, np.inf]), None

    monkeypatch.setattr(tridiag_dc_dist, "tridiag_dc_distributed", broken)
    with pytest.raises(health.ConvergenceError) as err:
        tridiagonal_eigensolver(_cpu(), np.ones(4), np.ones(3), 2, raise_on_failure=True)
    assert err.value.info == 3


def test_check_finite_names_the_stage(monkeypatch):
    a = tu.random_hermitian_pd(32, np.float64, seed=1)
    a[5, 3] = np.nan
    mat = DistributedMatrix.from_global(_cpu(), np.tril(a), (8, 8))
    monkeypatch.setenv("DLAF_TPU_CHECK_LEVEL", "2")
    with knobs(**KNOBS), pytest.raises(health.NonFiniteError) as err:
        t_heev("L", mat, backend="pipeline")
    assert err.value.stage == "red2band"
