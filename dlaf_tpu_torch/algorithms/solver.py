"""Positive-definite solvers: POTRS and POSV (counterpart of
``dlaf_tpu/algorithms/solver.py``), compositions of
:func:`cholesky_factorization` and :func:`triangular_solver`, and the
mixed-precision solver :func:`positive_definite_solver_mixed` (LAPACK
dsposv's scheme: factor in low precision, refine with residuals at the
target precision).

``positive_definite_solver(..., refine_to='input')`` is the companion of
the bf16 split-GEMM tiers (``tune.gemm_precision``): up to
``refine_sweeps`` residual corrections (``algorithms/refine.py``), the
residual a full-precision ``hermitian_multiplication``.  Every entry
point takes ``uplo`` 'L' or 'U'.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dlaf_tpu_torch import health
from dlaf_tpu_torch.algorithms._origin import origin_transparent
from dlaf_tpu_torch.algorithms.cholesky import cholesky_factorization
from dlaf_tpu_torch.algorithms.multiplication import hermitian_multiplication
from dlaf_tpu_torch.algorithms.norm import max_norm
from dlaf_tpu_torch.algorithms.triangular_solver import triangular_solver
from dlaf_tpu_torch.health import DistributionError
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix, _torch_dtype
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


@origin_transparent
def cholesky_solver(uplo: str, mat_l: DistributedMatrix, mat_b: DistributedMatrix,
                    backend: str = "auto") -> DistributedMatrix:
    """POTRS: solve A X = B given the Cholesky factor of A in the ``uplo``
    triangle of ``mat_l`` (A = L L^H, or A = U^H U for 'U'); B is updated
    in place and returned.  ``backend`` is passed to both triangular
    solves."""
    _check_solve_geometry("cholesky_solver", uplo, mat_l, mat_b)
    first, second = ((t.NO_TRANS, t.CONJ_TRANS) if uplo == t.LOWER
                     else (t.CONJ_TRANS, t.NO_TRANS))
    y = triangular_solver(t.LEFT, uplo, first, t.NON_UNIT, 1.0, mat_l, mat_b, backend=backend)
    return triangular_solver(t.LEFT, uplo, second, t.NON_UNIT, 1.0, mat_l, y, backend=backend)


@origin_transparent
def positive_definite_solver(uplo: str, mat_a: DistributedMatrix, mat_b: DistributedMatrix,
                             return_info: bool = False, raise_on_failure: bool = False,
                             refine_to: str | None = None, refine_sweeps: int = 2):
    """POSV: factor ``mat_a`` in place (its ``uplo`` triangle holds the
    Cholesky factor on return) and solve A X = B; returns the solution, or
    ``(x, info)`` with ``return_info=True`` (LAPACK-style 1-based first
    failing pivot, 0 on success).  ``raise_on_failure=True`` raises
    :class:`~dlaf_tpu_torch.health.NotPositiveDefiniteError` instead of
    letting NaNs flow into the triangular solves.

    ``refine_to='input'`` appends up to ``refine_sweeps`` residual
    corrections (``algorithms/refine.py``): the residual ``B - A X`` at full
    precision (``gemm_precision_scope('default')``), each correction a
    solve with the fast-tier factor.  It keeps copies of A and B from
    before the factorization (two more buffers) and returns a new matrix;
    without it the solution is written into ``mat_b``."""
    from dlaf_tpu_torch.algorithms import refine as _refine

    _refine.validate_refine_to(refine_to)
    _check_solve_geometry("positive_definite_solver", uplo, mat_a, mat_b)
    snap = None
    if refine_to is not None:
        # fresh copies: the factorization and the solves overwrite A and B,
        # and the max-norm is read before A is factored
        snap = (mat_a.astype(mat_a.dtype), mat_b.astype(mat_b.dtype), max_norm(mat_a, uplo))
    if return_info or raise_on_failure:
        fac, info = cholesky_factorization(
            uplo, mat_a, return_info=True, raise_on_failure=raise_on_failure
        )
        x = cholesky_solver(uplo, fac, mat_b)
        if snap is not None:
            x = _posv_refined(uplo, fac, x, snap, refine_sweeps)
        return (x, info) if return_info else x
    fac = cholesky_factorization(uplo, mat_a)
    x = cholesky_solver(uplo, fac, mat_b)
    if snap is not None:
        x = _posv_refined(uplo, fac, x, snap, refine_sweeps)
    return x


def _posv_refined(uplo, fac, x, snap, refine_sweeps):
    """The ``refine_to='input'`` tail of :func:`positive_definite_solver`."""
    from dlaf_tpu_torch.algorithms.refine import refine_tolerance, residual_refine

    a_full, b_full, anorm = snap
    x, _ = residual_refine(
        x,
        # the multiplication reads A and X and overwrites its C: a copy of B
        lambda xc: hermitian_multiplication(t.LEFT, uplo, -1.0, a_full, xc, 1.0,
                                            b_full.astype(b_full.dtype)),
        lambda r: cholesky_solver(uplo, fac, r),
        tol=refine_tolerance(anorm, a_full.size.rows, a_full.dtype),
        anorm=anorm,
        max_sweeps=refine_sweeps,
    )
    return x


@dataclass
class MixedSolveInfo:
    iters: int  # refinement sweeps performed (0 = the first solve was enough)
    converged: bool  # met the dsposv criterion in <= max_iters sweeps
    fallback: bool  # the full-precision factorization was used instead
    backward_error: float  # final ||r||_max / (||x||_max * ||A||_max)


def _lower_dtype(dtype, factor_dtype):
    """The factorization's dtype: ``factor_dtype`` when given, else one
    step below ``dtype`` (f64 -> f32, c128 -> c64)."""
    if factor_dtype is not None:
        return _torch_dtype(factor_dtype)
    dt = _torch_dtype(dtype)
    if dt == torch.complex128:
        return torch.complex64
    if dt == torch.float64:
        return torch.float32
    raise ValueError(
        f"positive_definite_solver_mixed: no default low precision below {dt}; "
        "pass factor_dtype explicitly"
    )


@origin_transparent
def positive_definite_solver_mixed(uplo: str, mat_a: DistributedMatrix,
                                   mat_b: DistributedMatrix, factor_dtype=None,
                                   max_iters: int = 30, fallback: bool = True,
                                   raise_on_failure: bool = False):
    """Solve A X = B to ``mat_a.dtype`` accuracy from a low-precision
    Cholesky factorization plus iterative refinement (LAPACK dsposv /
    zcposv).  ``mat_a`` must be f64 / c128 (or pass ``factor_dtype``);
    neither ``mat_a`` nor ``mat_b`` is modified.

    Returns ``(x, info)``, ``x`` a new matrix and ``info`` a
    :class:`MixedSolveInfo`.  If refinement has not met the dsposv
    criterion after ``max_iters`` sweeps (or the iterate went NaN / Inf)
    and ``fallback=True``, the system is solved again from a
    full-precision factorization (dsposv's ITER < 0 path), recorded as the
    health event ``mixed_solve_fallback``; with ``fallback=False`` the best
    iterate is returned with ``converged=False`` and the event
    ``mixed_solve_stalled``.  ``raise_on_failure=True`` raises
    :class:`~dlaf_tpu_torch.health.ConvergenceError` carrying the info
    instead of returning an unconverged solve."""
    target = mat_a.dtype
    low = _lower_dtype(target, factor_dtype)
    n = mat_a.size.rows
    if n == 0 or mat_b.size.cols == 0:
        return mat_b.like(mat_b.data.clone()), MixedSolveInfo(0, True, False, 0.0)
    eps = float(torch.finfo(target).eps)
    anorm = max_norm(mat_a, uplo)
    tol = float(anorm) * np.sqrt(n) * eps

    fac_lo = cholesky_factorization(uplo, mat_a.astype(low))
    x = cholesky_solver(uplo, fac_lo, mat_b.astype(low)).astype(target)

    info = MixedSolveInfo(0, False, False, np.inf)
    for it in range(max_iters + 1):
        # r = B - A x at the target precision (A's uplo triangle read as the
        # Hermitian matrix); the copy of B is the multiplication's C
        r = hermitian_multiplication(t.LEFT, uplo, -1.0, mat_a, x, 1.0, mat_b.astype(target))
        rnorm = max_norm(r)
        xnorm = max_norm(x)
        info.iters = it
        info.backward_error = rnorm / (xnorm * float(anorm)) if xnorm else 0.0
        if rnorm <= xnorm * tol:
            info.converged = True
            return x, info
        if it == max_iters or not (np.isfinite(rnorm) and np.isfinite(xnorm)):
            # a NaN / Inf iterate: the low-precision factorization failed,
            # and refinement cannot recover it
            break
        d = cholesky_solver(uplo, fac_lo, r.astype(low))
        x = x.like(x.data + d.data.to(target))

    if not fallback:
        health.record("mixed_solve_stalled", iters=info.iters,
                      backward_error=info.backward_error)
        if raise_on_failure:
            raise health.ConvergenceError(
                f"mixed-precision refinement stalled after {info.iters} sweeps "
                f"(backward error {info.backward_error:.3e}) and fallback is off",
                info=info,
            )
        return x, info
    # refinement stalled: full-precision factorization, as dsposv's
    # negative-ITER exit into dpotrf / dpotrs
    info.fallback = True
    health.record("mixed_solve_fallback", iters=info.iters,
                  factor_dtype=str(low).replace("torch.", ""))
    fac = cholesky_factorization(uplo, mat_a.astype(target))
    x = cholesky_solver(uplo, fac, mat_b.astype(target))
    r = hermitian_multiplication(t.LEFT, uplo, -1.0, mat_a, x, 1.0, mat_b.astype(target))
    rnorm, xnorm = max_norm(r), max_norm(x)
    info.backward_error = rnorm / (xnorm * float(anorm)) if xnorm else 0.0
    info.converged = rnorm <= xnorm * tol
    if not info.converged and raise_on_failure:
        raise health.ConvergenceError(
            "positive_definite_solver_mixed did not converge even after the "
            f"full-precision fallback (backward error {info.backward_error:.3e})",
            info=info,
        )
    return x, info
