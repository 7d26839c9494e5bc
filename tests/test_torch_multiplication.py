"""The port's multiplication family (GEMM, TRMM, HEMM, and the product of
sub-matrix windows, ``general_sub_multiplication``), ``max_norm`` and
POTRI (``inverse_from_cholesky_factor``) against the JAX package's, on CPU
grids of rank threads of the JAX fixture's shapes, with the cases of
``tests/test_multiplication.py``.  Each case runs on one of the six
fixture shapes (the cases cycle through them), the same inputs through
both packages.

Tolerance: the JAX test's ``tol_for(dtype, k, 50.0)`` of the relative max
error, k the contraction length, against the JAX package's result and
against numpy's product.
"""
import itertools

import jax
import numpy as np
import pytest

import dlaf_tpu as dt
import dlaf_tpu.testing as tu
from dlaf_tpu import tune as jtune
from dlaf_tpu.algorithms import multiplication as jmul
from dlaf_tpu.matrix.ref import MatrixRef as JRef
from dlaf_tpu_torch import (MatrixRef, general_multiplication, general_sub_multiplication,
                            hermitian_multiplication, inverse_from_cholesky_factor, max_norm,
                            triangular_multiplication)
from dlaf_tpu_torch import tune as ttune
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.testing import GRID_SHAPES, grid_like

SIDES = {"L": "Left", "R": "Right"}


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_state():
    yield
    jax.clear_caches()


def _op(a, op):
    return {"N": a, "T": a.T, "C": a.conj().T}[op]


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


def _jgrid(comm_grids, shape):
    return next(g for g in comm_grids if tuple(g.grid_size) == tuple(shape))


def _pair(comm_grids, shape, a, block):
    jm = dt.DistributedMatrix.from_global(_jgrid(comm_grids, shape), a, block)
    tm = DistributedMatrix.from_stacked(np.asarray(jm.data), jm.dist, grid_like(shape))
    return jm, tm


def _cases(items):
    """Each case on one of the fixture shapes, in turn."""
    return [pytest.param(GRID_SHAPES[i % len(GRID_SHAPES)], *c,
                         id="-".join(map(str, (GRID_SHAPES[i % len(GRID_SHAPES)],) + c)))
            for i, c in enumerate(items)]


def _check(out, ref, expected, tol):
    assert _rel_err(out.to_global(), ref.to_global()) <= tol
    assert _rel_err(out.to_global(), expected) <= tol


@pytest.mark.parametrize("shape,opa,opb", _cases(list(itertools.product("NTC", "NTC"))))
def test_gemm_ops_match_jax(comm_grids, shape, opa, opb):
    dtype = np.complex128
    m, n, k, mb = 10, 7, 13, 4
    a = tu.random_matrix(*((m, k) if opa == "N" else (k, m)), dtype, seed=1)
    b = tu.random_matrix(*((k, n) if opb == "N" else (n, k)), dtype, seed=2)
    c = tu.random_matrix(m, n, dtype, seed=3)
    alpha, beta = 1.5 - 0.5j, 0.75 + 0.25j
    mats = [_pair(comm_grids, shape, v, (mb, mb)) for v in (a, b, c)]
    ref = jmul.general_multiplication(opa, opb, alpha, *(m_[0] for m_ in mats[:2]), beta,
                                      mats[2][0])
    out = general_multiplication(opa, opb, alpha, *(m_[1] for m_ in mats[:2]), beta, mats[2][1])
    assert out.data is mats[2][1].data  # C in place
    _check(out, ref, alpha * (_op(a, opa) @ _op(b, opb)) + beta * c, tu.tol_for(dtype, k, 50.0))


@pytest.mark.parametrize("shape", GRID_SHAPES)
@pytest.mark.parametrize("dtype", [np.float64, np.complex64], ids=str)
def test_gemm_grids_match_jax(comm_grids, shape, dtype):
    m, n, k, mb = 12, 9, 6, 4
    a = tu.random_matrix(m, k, dtype, seed=1)
    b = tu.random_matrix(k, n, dtype, seed=2)
    mats = [_pair(comm_grids, shape, v, (mb, mb)) for v in (a, b, np.zeros((m, n), dtype))]
    ref = jmul.general_multiplication("N", "N", 1.0, mats[0][0], mats[1][0], 0.0, mats[2][0])
    out = general_multiplication("N", "N", 1.0, mats[0][1], mats[1][1], 0.0, mats[2][1])
    _check(out, ref, a @ b, tu.tol_for(dtype, k, 50.0))


@pytest.mark.parametrize("shape,side,uplo,op,diag",
                         _cases(list(itertools.product("LR", "LU", "NTC", "NU"))))
def test_trmm_combos_match_jax(comm_grids, shape, side, uplo, op, diag):
    dtype = np.complex128 if op == "C" else np.float64
    m, n, mb = 11, 6, 4
    an = m if side == "L" else n
    a = tu.random_matrix(an, an, dtype, seed=4)  # full random; only uplo is read
    b = tu.random_matrix(m, n, dtype, seed=5)
    tri = np.tril(a) if uplo == "L" else np.triu(a)
    if diag == "U":
        np.fill_diagonal(tri, 1.0)
    opa = _op(tri, op)
    expected = 0.5 * (opa @ b) if side == "L" else 0.5 * (b @ opa)
    (ja, ta), (jb, tb) = _pair(comm_grids, shape, a, (mb, mb)), _pair(comm_grids, shape, b, (mb, mb))
    ref = jmul.triangular_multiplication(SIDES[side], uplo, op, diag, 0.5, ja, jb)
    b_before = tb.to_global().copy()
    out = triangular_multiplication(SIDES[side], uplo, op, diag, 0.5, ta, tb)
    np.testing.assert_array_equal(tb.to_global(), b_before)  # a new matrix
    _check(out, ref, expected, tu.tol_for(dtype, an, 50.0))


@pytest.mark.parametrize("shape,side,uplo,dtype",
                         _cases([(s, u, d) for d in ("float64", "complex128")
                                 for s, u in itertools.product("LR", "LU")]))
def test_hemm_matches_jax(comm_grids, shape, side, uplo, dtype):
    dtype = np.dtype(dtype)
    m, n, mb = 10, 7, 4
    an = m if side == "L" else n
    h = tu.random_hermitian_pd(an, dtype, seed=6)
    # one triangle stored, the other poisoned to catch reads of it
    a = np.tril(h) if uplo == "L" else np.triu(h)
    a = a + (np.triu(np.ones_like(h), 1) if uplo == "L" else np.tril(np.ones_like(h), -1)) * 3.3
    b = tu.random_matrix(m, n, dtype, seed=7)
    c = tu.random_matrix(m, n, dtype, seed=8)
    mats = [_pair(comm_grids, shape, v, (mb, mb)) for v in (a, b, c)]
    ref = jmul.hermitian_multiplication(SIDES[side], uplo, 1.25, mats[0][0], mats[1][0], -0.5,
                                        mats[2][0])
    out = hermitian_multiplication(SIDES[side], uplo, 1.25, mats[0][1], mats[1][1], -0.5,
                                   mats[2][1])
    expected = 1.25 * (h @ b) - 0.5 * c if side == "L" else 1.25 * (b @ h) - 0.5 * c
    _check(out, ref, expected, tu.tol_for(dtype, an, 50.0))


@pytest.mark.parametrize("tier", ["bf16x3", "bf16x6"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)])
def test_gemm_split_tiers_match_jax(comm_grids, shape, tier):
    """The distributed GEMM under a split tier, as
    ``tests/test_precision.py::test_distributed_gemm_tier_parity`` drives
    it: within the tier's bound of the f64 product, and within
    tol_for(f32, k) of the JAX package's."""
    m, k, n, mb = 40, 48, 24, 8
    a = tu.random_matrix(m, k, np.float32, seed=21)
    b = tu.random_matrix(k, n, np.float32, seed=22)
    mats = [_pair(comm_grids, shape, v, (mb, mb)) for v in (a, b, np.zeros((m, n), np.float32))]
    jp, tp = jtune.get_tune_parameters(), ttune.get_tune_parameters()
    old = (jp.gemm_precision, tp.gemm_precision)
    try:
        jp.update(gemm_precision=tier)
        tp.update(gemm_precision=tier)
        ref = jmul.general_multiplication("N", "N", 1.0, mats[0][0], mats[1][0], 0.0, mats[2][0])
        out = general_multiplication("N", "N", 1.0, mats[0][1], mats[1][1], 0.0, mats[2][1])
    finally:
        jp.update(gemm_precision=old[0])
        tp.update(gemm_precision=old[1])
    exact = a.astype(np.float64) @ b.astype(np.float64)
    got = out.to_global()
    assert np.abs(got - exact).max() / np.abs(exact).max() < (5e-5 if tier == "bf16x3" else 5e-6)
    assert _rel_err(got, ref.to_global()) <= tu.tol_for(np.float32, k)


@pytest.mark.parametrize("shape", GRID_SHAPES)
@pytest.mark.parametrize("uplo", ["G", "L", "U"])
def test_max_norm_matches_jax_and_propagates_nan(comm_grids, shape, uplo):
    from dlaf_tpu.algorithms.norm import max_norm as jmax_norm

    a = tu.random_matrix(13, 10, np.float64, seed=9)
    a[0, 9] = 40.0  # upper triangle only
    a[12, 0] = -30.0  # lower only
    ja, ta = _pair(comm_grids, shape, a, (4, 4))
    assert max_norm(ta, uplo) == float(jmax_norm(ja, uplo))
    a[5, 5] = np.nan
    _, ta = _pair(comm_grids, shape, a, (4, 4))
    assert np.isnan(max_norm(ta, uplo))


@pytest.mark.parametrize("shape,dtype", [((1, 1), np.float64), ((2, 4), np.float64),
                                         ((4, 2), np.complex128), ((2, 2), np.float32)])
def test_inverse_from_cholesky_factor_matches_jax(comm_grids, shape, dtype):
    """POTRI of the lower factor: A^-1 in full Hermitian storage, within
    tol_for(dtype, n) x cond(A) of the JAX package's (cond <= 5 here)."""
    n, mb = 36, 8
    a = tu.random_hermitian_pd(n, dtype, seed=14)
    ell = np.linalg.cholesky(a.astype(np.result_type(dtype, np.float64))).astype(dtype)
    ell = ell + np.triu(tu.random_matrix(n, n, dtype, seed=15), 1)  # the upper is not read
    jl, tl = _pair(comm_grids, shape, ell, (mb, mb))
    ref = dt.inverse_from_cholesky_factor("L", jl).to_global()
    got = inverse_from_cholesky_factor("L", tl).to_global()
    tol = tu.tol_for(dtype, n) * 5
    assert _rel_err(got, ref) <= tol
    assert _rel_err(got, np.linalg.inv(a.astype(np.complex128))) <= tol
    np.testing.assert_allclose(got, got.conj().T, rtol=0, atol=tol)


# (A's origin, B's origin, C's origin, (M, K, N)) on 40 x 48, 48 x 56 and
# 64 x 64 parents of 8 x 8 tiles; on 2x4, the windows' row tile origins
# agree mod 2 and their column origins mod 4 (each rank owns the tiles it
# multiplies), or not (the panel window is gathered over the axis first)
SUB_CASES = {
    "owned": ((8, 16), (0, 8), (16, 16), (16, 24, 16)),
    "gather_rows": ((8, 8), (0, 16), (16, 24), (16, 24, 24)),
    "gather_both": ((16, 0), (0, 16), (8, 24), (24, 48, 40)),
    "whole": ((0, 0), (0, 0), (0, 0), (40, 48, 56)),
    "edge_tiles": ((32, 40), (40, 48), (56, 56), (8, 8, 8)),
    "ragged_edge": ((24, 32), (32, 40), (48, 48), (16, 16, 16)),
    "unaligned": ((3, 5), (2, 7), (1, 9), (17, 13, 11)),
}


@pytest.mark.parametrize("shape", [(2, 4), (1, 1)])
@pytest.mark.parametrize("case", list(SUB_CASES))
def test_general_sub_multiplication_matches_jax(comm_grids, shape, case):
    """C's window := alpha A's window B's window + beta C's window, the
    tiles outside C's window untouched, in place of C's parent."""
    (ra, ca), (rb, cb), (rc, cc), (m, k, n) = SUB_CASES[case]
    dtype = np.float64
    a = tu.random_matrix(40, 48, dtype, seed=1)
    b = tu.random_matrix(48, 56, dtype, seed=2)
    c = tu.random_matrix(64, 64, dtype, seed=3)
    if case == "ragged_edge":  # windows that end inside the parents' last tiles
        a, b, c = a[:38, :44], b[:44, :52], c[:62, :60]
        (m, k, n) = (14, 12, 12)
    mats = [_pair(comm_grids, shape, v, (8, 8)) for v in (a, b, c)]
    alpha, beta = 0.7, -1.3
    jr = [JRef(mats[0][0], (ra, ca), (m, k)), JRef(mats[1][0], (rb, cb), (k, n)),
          JRef(mats[2][0], (rc, cc), (m, n))]
    tr = [MatrixRef(mats[0][1], (ra, ca), (m, k)), MatrixRef(mats[1][1], (rb, cb), (k, n)),
          MatrixRef(mats[2][1], (rc, cc), (m, n))]
    assert [r.aligned for r in tr] == [r.aligned for r in jr]
    assert all(r.aligned for r in tr) == (case != "unaligned")
    ref = jmul.general_sub_multiplication(alpha, jr[0], jr[1], beta, jr[2])
    out = general_sub_multiplication(alpha, tr[0], tr[1], beta, tr[2])
    assert out.data is mats[2][1].data  # in place of C's parent
    want = c.copy()
    want[rc:rc + m, cc:cc + n] = (alpha * a[ra:ra + m, ca:ca + k] @ b[rb:rb + k, cb:cb + n]
                                  + beta * c[rc:rc + m, cc:cc + n])
    _check(out, ref, want, tu.tol_for(dtype, k, 50.0))
    outside = np.ones(want.shape, bool)
    outside[rc:rc + m, cc:cc + n] = False
    np.testing.assert_array_equal(out.to_global()[outside], c[outside])


@pytest.mark.parametrize("shape", [(2, 4), (1, 1)])
@pytest.mark.parametrize("aligned", [True, False])
def test_general_sub_multiplication_windows_of_c_parent(comm_grids, shape, aligned):
    """A's and B's windows in C's parent: every read of the parent ends
    before C's window is written (the rank barrier before the write-back)."""
    x = tu.random_matrix(64, 64, np.float64, seed=4)
    jx, tx = _pair(comm_grids, shape, x, (8, 8))
    o = 0 if aligned else 3
    wins = [((o, o), (32, 24)), ((o, 32), (24, 24)), ((32, 8), (32, 24))]
    ref = jmul.general_sub_multiplication(1.0, *(JRef(jx, *w_) for w_ in wins[:2]), 1.0,
                                          JRef(jx, *wins[2]))
    out = general_sub_multiplication(1.0, *(MatrixRef(tx, *w_) for w_ in wins[:2]), 1.0,
                                     MatrixRef(tx, *wins[2]))
    want = x.copy()
    want[32:64, 8:32] += x[o:o + 32, o:o + 24] @ x[o:o + 24, 32:56]
    _check(out, ref, want, tu.tol_for(np.float64, 24, 50.0))


def test_general_sub_multiplication_checks_its_operands(comm_grids):
    g = grid_like((2, 4))
    a = DistributedMatrix.from_global(g, np.ones((16, 16)), (8, 8))
    with pytest.raises(ValueError, match="sub-gemm"):
        general_sub_multiplication(1.0, MatrixRef(a, (0, 0), (8, 8)),
                                   MatrixRef(a, (0, 0), (16, 8)), 0.0, a)
    with pytest.raises(ValueError, match="block sizes"):
        general_sub_multiplication(1.0, DistributedMatrix.from_global(g, np.ones((16, 16)), (4, 4)),
                                   a, 0.0, a)
    with pytest.raises(ValueError, match="one grid"):
        general_sub_multiplication(1.0, DistributedMatrix.from_global(grid_like((4, 2)),
                                                                      np.ones((16, 16)), (8, 8)),
                                   a, 0.0, a)
