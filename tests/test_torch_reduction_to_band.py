"""The port's reduction_to_band (``dlaf_tpu_torch/algorithms/
reduction_to_band.py``) on multi-rank grids of rank threads, against the
JAX package's on its CPU mesh of the same shape.

Cases: the JAX test's own (``tests/test_reduction_to_band.py``: (m, nb) in
{(8, 4), (13, 4), (16, 4), (20, 5)}, float64 and complex128 on 2x4), and
one case on each of 2x2 (float32), 4x2 (complex64) and 1x2 (float32) at
the 'default' and the 'bf16x3' split-GEMM tier.  The JAX reference runs
once per case, under its 'fused' trailing-update tier at the case's
``gemm_precision`` (on its CPU mesh the fused tier is the transport plus
the interpret-mode update, whose complex route conjugates the panel,
``conj_panel=True``).  The port runs both of its tiers, 'xla' and 'fused'.

Checks, per case: the port's 'fused' output and taus are bit for bit its
'xla' ones (on the CPU both route through the same contractions); the
lower triangle of the output (band and reflector tails) and the taus are
within ``tol_for(dtype, m)`` of the JAX package's at 'default', the error
relative to the largest entry of the reference, as
``tests/test_torch_eigensolver.py`` holds the 1x1 case (the frameworks sum
in different orders); at 'bf16x3' within ``tol_for(dtype, m, 100)``, ten
times that budget.  There both packages sum exact bf16 products in
float32, but the two slices of an operand hold it only to about 2^-18
whatever m, and the reflectors amplify that: the JAX package's own bf16x3
reduction of the 2x2 case is 6.1e-5 from its float64 reduction (2.6
``tol_for(f32, 20)``), the port's 3.6e-5 from the JAX package's.  Every
rank thread must then have made its contractions at the case's tier and
at no other.  As the JAX test checks its own output, Q^H A Q rebuilt from
the port's reflectors is band within ``tol_for(dtype, m, 100)``.  No
kernel is launched on the CPU.

On a card, ``chip_smoke.py`` paths R1 and R2 drive the same entry point on
2x4 at N = 8192 (B3 and B6 per panel and rank).
"""
import contextlib

import numpy as np
import pytest

import dlaf_tpu_torch as dtt
from dlaf_tpu_torch import ops, tune
from dlaf_tpu_torch.algorithms.reduction_to_band import reduction_to_band
from dlaf_tpu_torch.ops import tile
from dlaf_tpu_torch.testing import grid_like, random_hermitian_pd, tol_for

# (grid shape, m, nb, dtype, gemm_precision)
CASES = ([((2, 4), m, nb, dt, "default") for dt in (np.float64, np.complex128)
          for m, nb in ((8, 4), (13, 4), (16, 4), (20, 5))]
         + [((2, 2), 20, 5, np.float32, g) for g in ("default", "bf16x3")]
         + [((4, 2), 20, 4, np.complex64, g) for g in ("default", "bf16x3")]
         + [((1, 2), 13, 4, np.float32, g) for g in ("default", "bf16x3")])


def _id(case):
    shape, m, nb, dt, gemm = case
    return f"{shape[0]}x{shape[1]}-m{m}-nb{nb}-{np.dtype(dt).name}-{gemm}"


@contextlib.contextmanager
def knobs(params, **kw):
    old = [{k: getattr(p, k) for k in kw} for p in params]
    for p in params:
        p.update(**kw)
    try:
        yield
    finally:
        for p, o in zip(params, old):
            p.update(**o)


def _rel(got, ref) -> float:
    wide = np.result_type(np.asarray(got).dtype, np.float64)  # complex stays complex
    got, ref = np.asarray(got, wide), np.asarray(ref, wide)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


def _q_of(out, taus, m, nb):
    """Q = H_0 H_1 ... from the stored reflectors (the JAX test's
    ``reconstruct_q``)."""
    q = np.eye(m, dtype=out.dtype)
    for k in range(taus.shape[0]):
        for j in range(nb):
            s, c = (k + 1) * nb + j, k * nb + j
            if s >= m or c >= m:
                break
            v = np.zeros(m, dtype=out.dtype)
            v[s] = 1.0
            v[s + 1:] = out[s + 1:, c]
            q = q @ (np.eye(m, dtype=out.dtype) - taus[k, j] * np.outer(v, v.conj()))
    return q


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_reduction_to_band_on_grids_matches_jax(comm_grids, case):
    pytest.importorskip("jax")
    import dlaf_tpu as dt
    from dlaf_tpu import tune as jtune
    from dlaf_tpu.algorithms.reduction_to_band import reduction_to_band as j_r2b

    shape, m, nb, dtype, gemm = case
    a = random_hermitian_pd(m, dtype, seed=m)
    jgrid = next(g for g in comm_grids if tuple(g.grid_size) == shape)
    with knobs([jtune.get_tune_parameters()], trailing_update_impl="fused", gemm_precision=gemm):
        jout, jtaus = j_r2b(dt.DistributedMatrix.from_global(jgrid, np.tril(a), (nb, nb)))
        ref, ref_taus = np.tril(jout.to_global()), np.asarray(jtaus)
    out = {}
    ops.reset_launch_counts()
    tile.contract_counts.clear()
    for impl in ("xla", "fused"):
        mat = dtt.DistributedMatrix.from_global(grid_like(shape), np.tril(a), (nb, nb))
        with knobs([tune.get_tune_parameters()], trailing_update_impl=impl, gemm_precision=gemm,
                   collectives_impl="pallas"):
            band_mat, taus = reduction_to_band(mat)
        assert band_mat.band_size == nb and tuple(taus.shape) == ref_taus.shape
        assert np.array_equal(mat.to_global(), np.tril(a))  # the input is not modified
        out[impl] = (band_mat.to_stacked(), band_mat.to_global(), taus.numpy())
    assert set(ops.launch_counts().values()) == {0}  # CPU: the plain versions
    ranks = {f"dlaf-rank-{r}-{c}" for r in range(shape[0]) for c in range(shape[1])}
    tiers = {(th, tr) for th, tr in tile.contract_counts if th in ranks}
    assert {th for th, _ in tiers} == ranks and {tr for _, tr in tiers} == {gemm}
    np.testing.assert_array_equal(out["fused"][0], out["xla"][0])
    np.testing.assert_array_equal(out["fused"][2], out["xla"][2])
    got, got_taus = np.tril(out["fused"][1]), out["fused"][2]
    tol = tol_for(dtype, m, 10.0 if gemm == "default" else 100.0)
    assert np.isfinite(got).all()
    assert _rel(got, ref) <= tol and _rel(got_taus, ref_taus) <= tol
    q = _q_of(out["fused"][1], got_taus, m, nb)
    i, j = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    off = (q.conj().T @ a @ q)[np.abs(i - j) > nb]
    assert off.size == 0 or np.max(np.abs(off)) < tol_for(dtype, m, 100.0)


def test_eigensolver_names_the_stages_left_on_grids():
    """reduction_to_band runs on a multi-rank grid, and so does every later
    stage of the eigensolver: on 2x2 the pipeline's eigenvalues are
    LAPACK's, with residual and orthogonality, at tol_for(f64, 16) (the
    stages are held to the JAX package in
    ``tests/test_torch_eigensolver_grid.py``)."""
    a = random_hermitian_pd(16, np.float64, seed=16)
    mat = dtt.DistributedMatrix.from_global(grid_like((2, 2)), np.tril(a), (4, 4))
    with knobs([tune.get_tune_parameters()], eigensolver_min_band=2, dc_leaf_size=4,
               band_chase_backend="native"):
        res = dtt.hermitian_eigensolver("L", mat, backend="pipeline")
    tol = tol_for(np.float64, 16)
    w, v = res.eigenvalues, res.eigenvectors.to_global()
    assert np.max(np.abs(w - np.linalg.eigvalsh(a))) <= tol * np.max(np.abs(a))
    assert np.max(np.abs(a @ v - v * w)) <= tol * np.max(np.abs(a))
    assert np.max(np.abs(v.T @ v - np.eye(16))) <= tol
