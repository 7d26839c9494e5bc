"""Source ranks other than (0, 0) at every entry point the port decorates
with ``origin_transparent`` (``dlaf_tpu_torch/algorithms/_origin.py``),
against the port's own call at the origin and the JAX package's call at
the same source rank, on a 2x4 grid of rank threads on the CPU.

Every operand is distributed with ``source_rank=(1, 2)``.  The port lifts
it to the origin by a roll of the rank axes and rolls the results back, so
each result, and each operand the call writes in place, is held bit for
bit to the same call on origin-(0, 0) operands; matrix results keep the
caller's source rank.  Against the JAX package: within ``tol_for(f64, N,
100)`` of the error relative to the largest entry (the frameworks sum in
different orders), eigenvalues the same way, and eigenvectors by their
residual and orthogonality (their signs are free).  N = 32, nb 8, the
eigensolver knobs of ``tests/test_torch_eigensolver_grid.py``.
"""
import contextlib
import dataclasses

import jax
import numpy as np
import pytest

import dlaf_tpu as dt
import dlaf_tpu.testing as tu
from dlaf_tpu import tune as jtune
from dlaf_tpu.algorithms import eig_refine as j_er
from dlaf_tpu.algorithms.eigensolver import hermitian_eigenvalues as j_eigvals
from dlaf_tpu.algorithms.permutations import permute as j_permute
import dlaf_tpu_torch as dtt
from dlaf_tpu_torch import tune
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.testing import grid_like

N, NB, SRC = 32, 8, (1, 2)
KNOBS = dict(eigensolver_min_band=4, eigensolver_sbr_band=2, band_chase_backend="native",
             dc_secular_pallas=True, trailing_update_impl="fused", dc_leaf_size=8,
             bt_band_hh_group_size=2)

A = tu.random_hermitian_pd(N, np.float64, seed=11)
B = tu.random_matrix(N, 6, np.float64, seed=12)
C = tu.random_matrix(N, 6, np.float64, seed=13)
L = np.linalg.cholesky(A)
BPD = tu.random_hermitian_pd(N, np.float64, seed=14)
LB = np.linalg.cholesky(BPD)
W32, V32 = np.linalg.eigh(A.astype(np.float32))
PERM = np.random.default_rng(15).permutation(N)


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_state():
    yield
    jax.clear_caches()


@contextlib.contextmanager
def knobs():
    jp, tp = jtune.get_tune_parameters(), tune.get_tune_parameters()
    jold = {k: getattr(jp, k) for k in KNOBS}
    told = {k: getattr(tp, k) for k in KNOBS}
    jp.update(**KNOBS)
    tp.update(**KNOBS)
    try:
        yield
    finally:
        jp.update(**jold)
        tp.update(**told)


# name: (the package's entry point, (its arguments: numpy arrays become
# matrices, other values pass as they are), the arguments it writes in place)
def _cases(pkg):
    er = j_er if pkg is dt else dtt
    perm = j_permute if pkg is dt else dtt.permute
    eigvals = j_eigvals if pkg is dt else dtt.hermitian_eigenvalues
    return {
        "cholesky_factorization": (pkg.cholesky_factorization, ("L", np.tril(A)), (1,)),
        "triangular_solver": (pkg.triangular_solver, ("Left", "L", "N", "N", 1.0, L, B), (6,)),
        "cholesky_solver": (pkg.cholesky_solver, ("L", L, B), (2,)),
        "positive_definite_solver": (pkg.positive_definite_solver, ("L", np.tril(A), B), (1, 2)),
        "positive_definite_solver_mixed": (pkg.positive_definite_solver_mixed,
                                           ("L", np.tril(A), B), ()),
        "triangular_inverse": (pkg.triangular_inverse, ("L", "N", L), (2,)),
        "inverse_from_cholesky_factor": (pkg.inverse_from_cholesky_factor, ("L", L), (1,)),
        "general_multiplication": (pkg.general_multiplication,
                                   ("N", "T", 1.5, B, C, 0.5, A), (6,)),
        "triangular_multiplication": (pkg.triangular_multiplication,
                                      ("Left", "L", "N", "N", 2.0, L, B), ()),
        "hermitian_multiplication": (pkg.hermitian_multiplication,
                                     ("Left", "L", 1.0, np.tril(A), B, 0.5, C), (6,)),
        "reduction_to_band": (pkg.reduction_to_band, (np.tril(A), 4), ()),
        "generalized_to_standard": (pkg.generalized_to_standard, ("L", np.tril(A), LB), (1,)),
        "hermitian_eigensolver": (pkg.hermitian_eigensolver, ("L", np.tril(A)), ()),
        "hermitian_generalized_eigensolver": (pkg.hermitian_generalized_eigensolver,
                                              ("L", np.tril(A), np.tril(BPD)), (2,)),
        "hermitian_eigenvalues": (eigvals, ("L", np.tril(A), (3, 20)), ()),
        "permute": (perm, (A, PERM, "cols"), ()),
        "refine_eigenpairs": (er.refine_eigenpairs, ("L", np.tril(A), V32.astype(np.float64)), ()),
        "refine_partial_eigenpairs": (er.refine_partial_eigenpairs,
                                      ("L", np.tril(A), V32, W32, (4, 11)), ()),
        "hermitian_eigensolver_mixed": (er.hermitian_eigensolver_mixed, ("L", np.tril(A)), ()),
    }


def _port_call(name, src):
    fn, args, written = _cases(dtt)[name]
    g = grid_like((2, 4))
    mats = [DistributedMatrix.from_global(g, a, (NB, NB), source_rank=src)
            if isinstance(a, np.ndarray) and a.ndim == 2 else a for a in args]
    with knobs():
        out = fn(*mats)
    return out, [mats[i] for i in written]


# The JAX package's cholesky_solver and positive_definite_solver donate B's
# buffer without repointing the caller's handle, so their decorator's copy
# back onto that handle reads a deleted array and raises at every source
# rank but (0, 0) (ROADMAP.md §C): for these two the reference is the JAX
# call at the origin, the same values in the origin layout.
JAX_AT_ORIGIN = {"cholesky_solver", "positive_definite_solver"}


def _jax_call(grid, name):
    fn, args, _ = _cases(dt)[name]
    src = (0, 0) if name in JAX_AT_ORIGIN else SRC
    mats = [dt.DistributedMatrix.from_global(grid, a, (NB, NB), source_rank=src)
            if isinstance(a, np.ndarray) and a.ndim == 2 else a for a in args]
    with knobs():
        return fn(*mats)


def _leaves(res):
    """The arrays of a result, with a tag: 'm' a matrix and 'v'
    eigenvectors (each its global form and source rank), 'w' eigenvalues,
    'a' any other array."""
    if isinstance(res, (DistributedMatrix, dt.DistributedMatrix)):
        return [("m", (np.asarray(res.to_global()), tuple(res.dist.source_rank)))]
    if isinstance(res, (tuple, list)):
        return [leaf for r in res for leaf in _leaves(r)]
    if hasattr(res, "eigenvalues") and hasattr(res, "eigenvectors"):
        return [("w", np.asarray(res.eigenvalues)),
                ("v", (np.asarray(res.eigenvectors.to_global()),
                       tuple(res.eigenvectors.dist.source_rank)))]
    if dataclasses.is_dataclass(res):
        return []  # the info records
    return [("a", np.asarray(res))]


def _tagged(name, res):
    """:func:`_leaves`, the refinements' ``(w, X, info)`` as eigenpairs."""
    leaves = _leaves(res)
    if name.startswith("refine_"):
        (_, w), (_, (x, src)) = leaves
        return [("w", w), ("v", (x, src))]
    return leaves


def _rel(got, ref) -> float:
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


@pytest.mark.parametrize("name", list(_cases(dtt)))
def test_entry_point_at_source_rank_1_2(grid_2x4, name):
    out, written = _port_call(name, SRC)
    out0, written0 = _port_call(name, (0, 0))
    leaves, leaves0 = _tagged(name, out), _tagged(name, out0)
    assert [k for k, _ in leaves] == [k for k, _ in leaves0]
    assert leaves, name
    for (kind, got), (_, want) in zip(leaves, leaves0):
        if kind in "mv":
            assert got[1] == SRC and want[1] == (0, 0)
            got, want = got[0], want[0]
        np.testing.assert_array_equal(got, want)
    for m, m0 in zip(written, written0):  # in-place results on the caller's handles
        assert tuple(m.dist.source_rank) == SRC
        np.testing.assert_array_equal(m.to_global(), m0.to_global())
    jl = _tagged(name, _jax_call(grid_2x4, name))
    tol = tu.tol_for(np.float64, N, 100.0)
    w = None
    for (kind, got), (_, want) in zip(leaves, jl):
        if kind in "mv":
            assert want[1] == ((0, 0) if name in JAX_AT_ORIGIN else SRC)
            got, want = got[0], want[0]
        if kind == "w":
            w = got
        if kind == "v":  # the eigenvectors: residual and (B-)orthogonality
            bmat = BPD if name == "hermitian_generalized_eigensolver" else np.eye(N)
            res = A @ got - bmat @ got * w[None, :]
            ortho = got.T @ bmat @ got - np.eye(got.shape[1])
            assert np.abs(res).max() <= tol * np.abs(A).max() * 10, name
            assert np.abs(ortho).max() <= tol * 10, name
            continue
        assert _rel(got, want) <= tol, (name, kind, _rel(got, want))


def test_operands_of_different_source_ranks_raise():
    g = grid_like((2, 4))
    a = DistributedMatrix.from_global(g, A, (NB, NB), source_rank=SRC)
    b = DistributedMatrix.from_global(g, B, (NB, NB))
    with pytest.raises(ValueError, match="source rank"):
        dtt.cholesky_solver("L", a, b)
    with pytest.raises(ValueError, match="source rank"):
        dtt.general_multiplication("N", "N", 1.0, a, b, 0.0, b)


def test_to_origin_and_back_are_rolls():
    g = grid_like((2, 4))
    a = DistributedMatrix.from_global(g, B, (NB, NB), source_rank=SRC)
    z = a.to_origin()
    assert tuple(z.dist.source_rank) == (0, 0) and z.data is not a.data
    np.testing.assert_array_equal(z.to_global(), B)
    back = z.with_source_rank(SRC)
    np.testing.assert_array_equal(back.to_stacked(), a.to_stacked())
    assert z.to_origin() is z and z.with_source_rank((0, 0)) is z
    with pytest.raises(ValueError, match="source rank"):
        a.with_source_rank((1, 1))
