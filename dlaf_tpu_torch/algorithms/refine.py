"""Solver-level residual-correction refinement (counterpart of
``dlaf_tpu/algorithms/refine.py``), shared by ``positive_definite_solver``
and ``triangular_solver`` (``refine_to=``).  Solve cheaply (the bf16
split-GEMM tiers of ``tune.gemm_precision``), then restore the target
accuracy with a few correction sweeps:

    r = residual(x)          # full precision: gemm_precision_scope('default')
    d = correct(r)           # the cheap factorization / solve again
    x = x + d

The residual is the only step that must be exact; the corrections keep the
ambient (fast) tier.  Convergence is LAPACK dsposv's criterion
``||r||_max <= ||x||_max * tol`` with ``tol = ||A||_max * sqrt(N) *
eps(target)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from dlaf_tpu_torch.algorithms.norm import masked_max_abs
from dlaf_tpu_torch.health import ConfigurationError
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix

#: accepted values of the solvers' ``refine_to=``: None (no refinement) or
#: 'input' (the input dtype's rounding level)
REFINE_TARGETS = (None, "input")


def validate_refine_to(value):
    if value not in REFINE_TARGETS:
        raise ConfigurationError(f"refine_to must be one of {REFINE_TARGETS}, got {value!r}")
    return value


@dataclass
class RefineInfo:
    sweeps: int  # correction sweeps applied (0 = the first solve was enough)
    converged: bool  # met ||r||_max <= ||x||_max * tol
    residual: float  # final ||r||_max
    backward_error: float  # final ||r||_max / (||x||_max * ||A||_max)


def _real_eps(dtype) -> float:
    """eps of the real part of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return float(torch.finfo(dtype).eps)  # a complex dtype's is its real part's
    return float(np.finfo(np.dtype(dtype).type(0).real.dtype).eps)


def refine_tolerance(anorm: float, n: int, dtype) -> float:
    """dsposv's tolerance ``||A||_max * sqrt(N) * eps(target)``."""
    return float(anorm) * float(np.sqrt(max(n, 1))) * _real_eps(dtype)


def convergence_floor(n: int, dtype, factor: float = 50.0) -> float:
    """Attainable floor ``n * eps * factor`` of a residual-derived metric."""
    return float(n) * _real_eps(dtype) * float(factor)


def max_abs(data, dist) -> float:
    """NaN-propagating max-abs over the in-bounds region of a stacked
    tensor (padding excluded)."""
    return float(masked_max_abs(data, dist))


def residual_refine(
    x: DistributedMatrix,
    residual_fn: Callable[[DistributedMatrix], DistributedMatrix],
    correct_fn: Callable[[DistributedMatrix], DistributedMatrix],
    *,
    tol: float,
    anorm: float = 1.0,
    max_sweeps: int = 2,
) -> tuple[DistributedMatrix, RefineInfo]:
    """Refine ``x`` with up to ``max_sweeps`` residual-correction sweeps.
    ``residual_fn(x)`` returns the true residual as a new matrix and runs
    under ``gemm_precision_scope('default')`` (rank threads included);
    ``correct_fn(r)`` solves for the correction at the ambient tier (it may
    overwrite ``r``).  Stops early on convergence, and on a NaN or Inf
    iterate."""
    from dlaf_tpu_torch.tune import gemm_precision_scope

    info = RefineInfo(0, False, np.inf, np.inf)
    for sweep in range(max_sweeps + 1):
        with gemm_precision_scope("default"):
            r = residual_fn(x)
        rnorm = max_abs(r.data, r.dist)
        xnorm = max_abs(x.data, x.dist)
        info.sweeps = sweep
        info.residual = rnorm
        info.backward_error = rnorm / (xnorm * float(anorm)) if xnorm and anorm else 0.0
        if rnorm <= xnorm * tol:
            info.converged = True
            return x, info
        if sweep == max_sweeps or not (np.isfinite(rnorm) and np.isfinite(xnorm)):
            return x, info
        d = correct_fn(r)
        x = x.like(x.data + d.data.to(x.dtype))
    return x, info
