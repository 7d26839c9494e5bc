"""Positive-definite solvers: POTRS and POSV (counterpart of
``dlaf_tpu/algorithms/solver.py``), compositions of
:func:`cholesky_factorization` and :func:`triangular_solver`.

Not in this slice (see ROADMAP.md): ``refine_to`` and the mixed-precision
solver.
"""
from __future__ import annotations

from dlaf_tpu_torch.algorithms.cholesky import cholesky_factorization
from dlaf_tpu_torch.algorithms.triangular_solver import triangular_solver
from dlaf_tpu_torch.health import DistributionError
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.ops import tile as t


def _check_solve_geometry(what: str, uplo: str, mat_a: DistributedMatrix,
                          mat_b: DistributedMatrix) -> None:
    """B-geometry validation: multi-RHS (N, k) stacks are welcome, only
    the row geometry of B must match A."""
    if uplo not in (t.LOWER, t.UPPER):
        raise DistributionError(f"{what}: uplo must be 'L' or 'U', got {uplo!r}")
    if mat_a.size.rows != mat_a.size.cols:
        raise DistributionError(f"{what}: A must be square, got {mat_a.size}")
    if mat_a.block_size.rows != mat_a.block_size.cols:
        raise DistributionError(f"{what}: A tiles must be square, got {mat_a.block_size}")
    if mat_b.size.rows != mat_a.size.rows:
        raise DistributionError(
            f"{what}: b must have N = {mat_a.size.rows} rows to match A {mat_a.size}, "
            f"got b {mat_b.size}"
        )
    if mat_b.block_size.rows != mat_a.block_size.rows:
        raise DistributionError(
            f"{what}: b row tiling {mat_b.block_size} must match A's {mat_a.block_size}"
        )
    if mat_a.grid is not mat_b.grid and mat_a.grid.grid_size != mat_b.grid.grid_size:
        raise DistributionError(f"{what}: A and b must share the process grid")


def cholesky_solver(uplo: str, mat_l: DistributedMatrix, mat_b: DistributedMatrix,
                    backend: str = "auto") -> DistributedMatrix:
    """POTRS: solve A X = B given the Cholesky factor of A in the lower
    triangle of ``mat_l``; B is updated in place and returned.
    ``backend`` is passed to both triangular solves."""
    _check_solve_geometry("cholesky_solver", uplo, mat_l, mat_b)
    if uplo != t.LOWER:
        raise NotImplementedError(
            "cholesky_solver: only uplo='L' is ported "
            "(ROADMAP.md §A, item 2: the rest of the main path)"
        )
    y = triangular_solver(t.LEFT, t.LOWER, t.NO_TRANS, t.NON_UNIT, 1.0, mat_l, mat_b,
                          backend=backend)
    return triangular_solver(t.LEFT, t.LOWER, t.CONJ_TRANS, t.NON_UNIT, 1.0, mat_l, y,
                             backend=backend)


def positive_definite_solver(uplo: str, mat_a: DistributedMatrix, mat_b: DistributedMatrix,
                             return_info: bool = False, raise_on_failure: bool = False,
                             refine_to: str | None = None):
    """POSV: factor ``mat_a`` in place (its lower triangle holds the
    Cholesky factor on return) and solve A X = B; returns the updated B,
    or ``(x, info)`` with ``return_info=True`` (LAPACK-style 1-based first
    failing pivot, 0 on success).  ``raise_on_failure=True`` raises
    :class:`~dlaf_tpu_torch.health.NotPositiveDefiniteError` instead of
    letting NaNs flow into the triangular solves."""
    if refine_to is not None:
        raise NotImplementedError(
            "positive_definite_solver: refine_to is not ported yet "
            "(ROADMAP.md §A, item 4: split-GEMM tiers, refinement, mixed precision)"
        )
    _check_solve_geometry("positive_definite_solver", uplo, mat_a, mat_b)
    if return_info or raise_on_failure:
        fac, info = cholesky_factorization(
            uplo, mat_a, return_info=True, raise_on_failure=raise_on_failure
        )
        x = cholesky_solver(uplo, fac, mat_b)
        return (x, info) if return_info else x
    fac = cholesky_factorization(uplo, mat_a)
    return cholesky_solver(uplo, fac, mat_b)
