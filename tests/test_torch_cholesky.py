"""The port's cholesky_factorization against the JAX package's, on the 1x1
grid, at small sizes, with the same tune knobs set in both packages and the
same input state carried across (``DistributedMatrix.from_stacked``).

Variants: bucketed (default), lookahead under the 'xla' tier, lookahead
under the 'fused' tier (the trailing-update kernel, its plain version on
the CPU); ``panel_trsm_pallas`` on and off (the panel-TRSM kernel engages
where mb % 32 == 0).  The lower triangle is compared at
``tol_for(dtype, n)`` of the relative max error
(``dlaf_tpu/testing/__init__.py:55``): the frameworks sum in different
orders.
"""
import contextlib
import itertools

import jax
import numpy as np
import pytest

import dlaf_tpu as dt
import dlaf_tpu.testing as tu
from dlaf_tpu import tune as jtune
from dlaf_tpu_torch import tune as ttune
from dlaf_tpu_torch.algorithms.cholesky import cholesky_factorization
from dlaf_tpu_torch.comm.grid import Grid
from dlaf_tpu_torch.health import NotPositiveDefiniteError
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix

VARIANTS = {
    "bucketed": dict(cholesky_lookahead=False, trailing_update_impl="auto"),
    "lookahead_xla": dict(cholesky_lookahead=True, trailing_update_impl="xla"),
    "lookahead_fused": dict(cholesky_lookahead=True, trailing_update_impl="fused"),
}


def _cases():
    out = []
    for n, mb, dtype, variant in itertools.product(
            (64, 100, 192), (16, 32), (np.float32, np.float64), VARIANTS):
        # mb=16 never meets the panel kernel's gate; at mb=32 one variant
        # per dtype runs with the kernel off
        panel = mb == 32 and not (variant == "bucketed" and dtype == np.float64)
        out.append((n, mb, dtype, variant, panel))
    # complex tiles go to the library behind the kernels' real-only gates
    out += [(64, 8, dtype, variant, False)
            for dtype in (np.complex64, np.complex128) for variant in VARIANTS]
    return out


@contextlib.contextmanager
def knobs(**kw):
    """Set the same knobs in both packages; restore both afterwards."""
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


def _pair(grid_1x1, a, mb):
    jm = dt.DistributedMatrix.from_global(grid_1x1, a, (mb, mb))
    tm = DistributedMatrix.from_stacked(np.asarray(jm.data), jm.dist, Grid.create(device="cpu"))
    return jm, tm


def _rel_err(got, ref):
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


@pytest.mark.parametrize("n,mb,dtype,variant,panel", _cases())
def test_cholesky_matches_jax(grid_1x1, n, mb, dtype, variant, panel):
    a = tu.random_hermitian_pd(n, dtype, seed=n + mb)
    a = np.tril(a) + np.triu(tu.random_matrix(n, n, dtype, seed=1), 1)  # upper not read
    jm, tm = _pair(grid_1x1, a, mb)
    with knobs(panel_trsm_pallas=panel, **VARIANTS[variant]):
        ref = np.tril(dt.cholesky_factorization("L", jm, backend="distributed").to_global())
        out = cholesky_factorization("L", tm, backend="distributed")
    got = np.tril(out.to_global())
    assert out.data is tm.data  # in place
    assert np.isfinite(got).all()
    assert _rel_err(got, ref) <= tu.tol_for(dtype, n)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_info_on_non_spd_matches_jax(grid_1x1, variant):
    n, mb = 96, 32
    a = tu.random_hermitian_pd(n, np.float64, seed=5)
    a[70, 70] = -50.0  # the leading minor of order 71 fails
    jm, tm = _pair(grid_1x1, a, mb)
    with knobs(panel_trsm_pallas=True, **VARIANTS[variant]):
        _, jinfo = dt.cholesky_factorization("L", jm, backend="distributed", return_info=True)
        _, tinfo = cholesky_factorization("L", tm, backend="distributed", return_info=True)
        assert int(tinfo) == int(jinfo) == 71
        with pytest.raises(NotPositiveDefiniteError) as e:
            cholesky_factorization("L", _pair(grid_1x1, a, mb)[1], raise_on_failure=True)
        assert e.value.info == 71


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_dense_paths_of_a_non_spd_matrix_give_nan_like_jax(grid_1x1, dtype):
    """A matrix that is not positive definite: the 1x1 dense path (and
    ``tile.potrf``, which the distributed kernel uses for tiles outside
    the potrf kernel's gate) give NaN, as ``jnp.linalg.cholesky`` does in
    the JAX package, rather than raise (ROADMAP §C, C3)."""
    import torch

    from dlaf_tpu_torch.ops import tile

    n, mb = 24, 8
    a = tu.random_hermitian_pd(n, dtype, seed=9)
    a[13, 13] = -5.0
    jm, tm = _pair(grid_1x1, a, mb)
    ref = dt.cholesky_factorization("L", jm).to_global()
    got = cholesky_factorization("L", tm).to_global()
    low = np.tril_indices(n)
    assert np.isnan(ref[low]).all() and np.isnan(got[low]).all()
    np.testing.assert_array_equal(np.triu(got, 1), np.triu(ref, 1))  # the caller's upper
    tiles = torch.from_numpy(np.stack([a[:8, :8], a[8:16, 8:16]]))
    fac = tile.potrf(tiles).numpy()
    assert not np.isnan(fac[0]).any() and np.isnan(fac[1][np.tril_indices(8)]).all()
    assert not np.triu(fac[1], 1).any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_info_zero_and_dense_auto_path_match_jax(grid_1x1, dtype):
    n, mb = 100, 32
    a = tu.random_hermitian_pd(n, dtype, seed=6)
    jm, tm = _pair(grid_1x1, a, mb)
    _, info = cholesky_factorization("L", tm, backend="distributed", return_info=True)
    assert int(info) == 0
    # backend='auto' on 1x1: the dense path in both packages, upper kept
    jm, tm = _pair(grid_1x1, a, mb)
    ref = dt.cholesky_factorization("L", jm).to_global()
    got = cholesky_factorization("L", tm).to_global()
    assert _rel_err(np.tril(got), np.tril(ref)) <= tu.tol_for(dtype, n)
    np.testing.assert_array_equal(np.triu(got, 1), np.triu(a, 1))


def test_left_out_options_raise():
    """The checkpoints still wait (ROADMAP §A, item 7), in both triangles;
    asked for with ``shift_recovery`` they raise the JAX package's
    DistributionError first."""
    from dlaf_tpu_torch.health import DistributionError

    tm = DistributedMatrix.from_global(Grid.create(device="cpu"), np.eye(8), (4, 4))
    for uplo in ("L", "U"):
        for kw in (dict(checkpoint_every=2), dict(checkpoint_path="ck"), dict(resume_from="x")):
            with pytest.raises(NotImplementedError, match="item 7: robustness"):
                cholesky_factorization(uplo, tm, **kw)
    with pytest.raises(DistributionError, match="mutually exclusive"):
        cholesky_factorization("L", tm, shift_recovery=True, checkpoint_every=2)


# ------------------------------------------------------- multi-rank grids

MULTI_SHAPES = [(2, 2), (2, 4), (4, 2)]
# the real case of every shape, and a complex case on one shape each (the
# real cases keep the ids they had before the complex ones came)
MULTI_CASES = [
    *(pytest.param(s, np.float32, id=f"shape{i}") for i, s in enumerate(MULTI_SHAPES)),
    pytest.param((2, 4), np.complex64, id="shape1-complex64"),
    pytest.param((4, 2), np.complex128, id="shape2-complex128"),
]
TIERS = ["psum", "v2", "pallas"]
MULTI_VARIANTS = {
    "bucketed": dict(cholesky_lookahead=False, trailing_update_impl="auto"),
    "lookahead_xla": dict(cholesky_lookahead=True, trailing_update_impl="xla"),
}
_JAX_MULTI: dict = {}


def _jax_grid(comm_grids, shape):
    return next(g for g in comm_grids if tuple(g.grid_size) == shape)


def _multi_pair(comm_grids, shape, a, mb):
    jm = dt.DistributedMatrix.from_global(_jax_grid(comm_grids, shape), a, (mb, mb))
    tm = DistributedMatrix.from_stacked(np.asarray(jm.data), jm.dist, Grid.create(shape, device="cpu"))
    return jm, tm


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("variant", list(MULTI_VARIANTS))
@pytest.mark.parametrize("shape,dtype", MULTI_CASES)
def test_cholesky_multi_rank_matches_jax(comm_grids, shape, dtype, variant, tier):
    """Bucketed and lookahead Cholesky on rank threads of a 2x2, 2x4 and 4x2
    grid, in each collectives tier (under 'pallas' the lookahead panel is
    B7's twin), against the JAX package on its 8-device mesh; f32, and c64
    and c128 on one shape each (complex panels travel as their real views)."""
    n, mb = 60, 8
    a = tu.random_hermitian_pd(n, dtype, seed=21)
    a = np.tril(a) + np.triu(tu.random_matrix(n, n, dtype, seed=22), 1)  # upper not read
    key = (shape, np.dtype(dtype).str, variant)
    if key not in _JAX_MULTI:
        jm, _ = _multi_pair(comm_grids, shape, a, mb)
        with knobs(**MULTI_VARIANTS[variant]):
            _JAX_MULTI[key] = np.tril(dt.cholesky_factorization("L", jm).to_global())
    _, tm = _multi_pair(comm_grids, shape, a, mb)
    with knobs(collectives_impl=tier, **MULTI_VARIANTS[variant]):
        out, info = cholesky_factorization("L", tm, return_info=True)
    assert out.data is tm.data and int(info) == 0
    got = np.tril(out.to_global())
    assert np.isfinite(got).all()
    assert _rel_err(got, _JAX_MULTI[key]) <= tu.tol_for(dtype, n)


@pytest.mark.parametrize("lookahead", [False, True])
@pytest.mark.parametrize("shape", MULTI_SHAPES)
def test_cholesky_tiers_bitwise(shape, lookahead):
    """psum, v2 and pallas give the same bits for a whole factorization.
    With the panel-TRSM kernel on (nb = 32), the unfused lookahead panel runs
    the same potrf and panel-TRSM arithmetic as B7's twin."""
    n, mb = 96, 32
    a = np.tril(tu.random_hermitian_pd(n, np.float64, seed=23))
    out = {}
    for tier in TIERS:
        mat = DistributedMatrix.from_global(Grid.create(shape, device="cpu"), a, (mb, mb))
        with knobs(collectives_impl=tier, cholesky_lookahead=lookahead,
                   trailing_update_impl="xla", panel_trsm_pallas=True):
            out[tier] = cholesky_factorization("L", mat, backend="distributed").to_stacked()
    np.testing.assert_array_equal(out["psum"], out["v2"])
    np.testing.assert_array_equal(out["pallas"], out["v2"])


@pytest.mark.parametrize("shape", MULTI_SHAPES)
def test_info_multi_rank_matches_jax(comm_grids, shape):
    n, mb = 56, 8
    a = tu.random_hermitian_pd(n, np.float64, seed=24)
    a[37, 37] = -40.0  # the leading minor of order 38 fails
    jm, tm = _multi_pair(comm_grids, shape, a, mb)
    with knobs(collectives_impl="pallas", cholesky_lookahead=True, trailing_update_impl="xla"):
        _, jinfo = dt.cholesky_factorization("L", jm, return_info=True)
        _, tinfo = cholesky_factorization("L", tm, return_info=True)
    assert int(tinfo) == int(jinfo) == 38


@pytest.mark.parametrize("variant", list(MULTI_VARIANTS))
@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_info_from_a_tile_owned_off_rank_00_matches_jax(comm_grids, shape, variant):
    """Each rank scans the diagonal tiles it owns: a first failure in tile 3
    (owned by rank (1, 3) on 2x4, (3, 1) on 4x2) and a later one in tile 5
    (rank (1, 1)) give the least, as the JAX package's every-rank scan."""
    n, mb = 56, 8
    a = tu.random_hermitian_pd(n, np.float64, seed=25)
    a[27, 27] = a[45, 45] = -40.0  # the leading minors of order 28 and 46 fail
    jm, tm = _multi_pair(comm_grids, shape, a, mb)
    with knobs(collectives_impl="pallas", **MULTI_VARIANTS[variant]):
        _, jinfo = dt.cholesky_factorization("L", jm, return_info=True)
        _, tinfo = cholesky_factorization("L", tm, return_info=True)
    assert int(tinfo) == int(jinfo) == 28


def test_fused_tier_on_multi_rank_grids_raises():
    """The lookahead kernel's fused trailing-update tier runs on a grid with
    an axis > 1 now (B6 and B8 on the card; on the CPU the transport plus
    one update) and gives the 'xla' tier's bits there."""
    a = np.tril(tu.random_hermitian_pd(32, np.float64, seed=26))
    out = {}
    for impl in ("xla", "fused"):
        tm = DistributedMatrix.from_global(Grid.create((2, 4), device="cpu"), a, (8, 8))
        with knobs(cholesky_lookahead=True, trailing_update_impl=impl):
            out[impl] = cholesky_factorization("L", tm).to_stacked()
    np.testing.assert_array_equal(out["fused"], out["xla"])
    np.testing.assert_allclose(np.tril(DistributedMatrix.from_stacked(
        out["fused"], tm.dist, tm.grid).to_global()), np.linalg.cholesky(a + np.tril(a, -1).T),
        atol=tu.tol_for(np.float64, 32))


# --------------------------------------------------- the U form, shift recovery

_JAX_UPPER: dict = {}


def _upper_cases():
    """(shape, tier, variant, backend): the dense 1x1 route and the
    distributed kernels, bucketed and lookahead, on 1x1, and on 2x4 in the
    three tiers and on 4x2."""
    return [
        pytest.param((1, 1), "psum", "bucketed", "auto", id="1x1-dense"),
        pytest.param((1, 1), "psum", "bucketed", "distributed", id="1x1-bucketed"),
        pytest.param((1, 1), "psum", "lookahead_fused", "distributed", id="1x1-lookahead"),
        pytest.param((2, 4), "psum", "bucketed", "auto", id="2x4-psum"),
        pytest.param((2, 4), "v2", "lookahead_xla", "auto", id="2x4-v2-lookahead"),
        pytest.param((2, 4), "pallas", "lookahead_xla", "auto", id="2x4-pallas-lookahead"),
        pytest.param((4, 2), "pallas", "bucketed", "auto", id="4x2-pallas"),
    ]


@pytest.mark.parametrize("shape,tier,variant,backend", _upper_cases())
def test_cholesky_upper_matches_jax(comm_grids, shape, tier, variant, backend):
    """cholesky_factorization("U"): the factor in the upper triangle within
    tol_for(f64, n) of the JAX package's (its default route on the same
    grid shape), and the caller's strict lower triangle unchanged, bit for
    bit, as there."""
    n, mb = 60, 8
    a = tu.random_hermitian_pd(n, np.float64, seed=27)
    junk = np.tril(tu.random_matrix(n, n, np.float64, seed=28), -1)
    key = shape
    if key not in _JAX_UPPER:
        jm, _ = _multi_pair(comm_grids, shape, np.triu(a) + junk, mb)
        _JAX_UPPER[key] = dt.cholesky_factorization("U", jm).to_global()
    _, tm = _multi_pair(comm_grids, shape, np.triu(a) + junk, mb)
    with knobs(collectives_impl=tier, **VARIANTS[variant]):
        out = cholesky_factorization("U", tm, backend=backend)
    got = out.to_global()
    assert tm.data is out.data
    np.testing.assert_array_equal(np.tril(got, -1), junk)
    np.testing.assert_array_equal(np.tril(_JAX_UPPER[key], -1), junk)
    assert np.isfinite(got).all()
    assert _rel_err(np.triu(got), np.triu(_JAX_UPPER[key])) <= tu.tol_for(np.float64, n)


@pytest.mark.parametrize("shape", [(1, 1), (2, 4)])
def test_info_on_non_spd_upper_matches_jax(comm_grids, shape):
    """The U mirror has the same leading minors: the same info as the JAX
    package, from the upper triangle."""
    n, mb = 56, 8
    a = tu.random_hermitian_pd(n, np.float64, seed=29)
    a[37, 37] = -40.0  # the leading minor of order 38 fails
    jm, tm = _multi_pair(comm_grids, shape, np.triu(a), mb)
    _, jinfo = dt.cholesky_factorization("U", jm, return_info=True)
    with knobs(collectives_impl="pallas"):
        _, tinfo = cholesky_factorization("U", tm, return_info=True)
    assert int(tinfo) == int(jinfo) == 38


def _near_spd(n, dtype, seed, gap):
    """A - (lambda_min(A) + gap) I: the smallest eigenvalue is -gap."""
    a = tu.random_hermitian_pd(n, np.float64, seed=seed)
    lam = np.linalg.eigvalsh(a)[0]
    return (a - (lam + gap) * np.eye(n)).astype(dtype)


@pytest.mark.parametrize("shape,uplo,attempts", [
    pytest.param((2, 4), "L", 3, id="2x4-L"),
    pytest.param((1, 1), "U", 3, id="1x1-U"),
    pytest.param((4, 2), "L", 1, id="4x2-L-exhausted"),
])
def test_shift_recovery_matches_jax(comm_grids, shape, uplo, attempts):
    """shift_recovery on a matrix whose smallest eigenvalue is -1e-4, in
    f32 at n = 32: the first shift (max(|A|, 1) n eps, about 1e-5) is too
    small and the second (x100) recovers.  The factor, the info, the
    shifts and the health events equal the JAX package's; with one attempt
    allowed both raise NotPositiveDefiniteError with the same info and
    shift."""
    from dlaf_tpu import health as jhealth
    from dlaf_tpu_torch import health as thealth

    n, mb = 32, 8
    a = _near_spd(n, np.float32, 30, 1e-4)
    tri = np.tril(a) if uplo == "L" else np.triu(a)
    jm, tm = _multi_pair(comm_grids, shape, tri, mb)
    if attempts == 1:
        with pytest.raises(dt.NotPositiveDefiniteError) as je:
            dt.cholesky_factorization(uplo, jm, shift_recovery=True, max_shift_attempts=1,
                                      raise_on_failure=True)
        with pytest.raises(NotPositiveDefiniteError) as te:
            cholesky_factorization(uplo, tm, shift_recovery=True, max_shift_attempts=1,
                                   raise_on_failure=True)
        assert (te.value.info, te.value.shift) == (je.value.info, je.value.shift)
        assert te.value.info > 0 and te.value.shift > 0
        return
    with jhealth.capture_events() as jev:
        jfac, jinfo = dt.cholesky_factorization(uplo, jm, shift_recovery=True, return_info=True)
    with thealth.capture_events() as tev:
        tfac, tinfo = cholesky_factorization(uplo, tm, shift_recovery=True, return_info=True)
    assert int(tinfo) == int(jinfo) == 0
    assert [e["event"] for e in tev] == ["cholesky_shift_retry", "cholesky_shift_retry",
                                         "cholesky_shift_recovered"]
    assert tev == jev
    part = np.tril if uplo == "L" else np.triu
    got, ref = part(tfac.to_global()), part(jfac.to_global())
    assert _rel_err(got, ref) <= tu.tol_for(np.float32, n)
    shift = tev[-1]["shift"]
    ell = got.astype(np.float64) if uplo == "L" else got.astype(np.float64).T
    resid = np.abs(ell @ ell.T - (a.astype(np.float64) + shift * np.eye(n))).max()
    assert resid <= tu.tol_for(np.float32, n) * np.abs(a).max()
