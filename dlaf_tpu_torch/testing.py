"""Test utilities: copies of ``dlaf_tpu/testing/__init__.py:24-58``, so the
port's tests and ``chip_smoke.py`` build the same inputs and budgets as
the JAX package's, and grids of the shapes the JAX package's tests use."""
from __future__ import annotations

import numpy as np

#: the grid shapes of the JAX package's test fixture (``tests/conftest.py``:
#: square-ish, degenerate and non-divisible grids on 8 devices)
GRID_SHAPES = [(2, 4), (4, 2), (2, 2), (1, 2), (2, 1), (1, 1)]


def grid_like(grid_or_shape, device="cpu"):
    """A port grid of the same shape as a JAX package grid (anything with a
    ``grid_size``) or a ``(rows, cols)`` pair; on the CPU by default, where
    every kernel wrapper takes its plain version."""
    from dlaf_tpu_torch.comm.grid import Grid

    shape = getattr(grid_or_shape, "grid_size", grid_or_shape)
    return Grid.create(tuple(shape), device=device)



def random_hermitian_pd(n: int, dtype, seed: int = 0) -> np.ndarray:
    """Random Hermitian positive-definite matrix with condition O(n)."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "c":
        b = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    else:
        b = rng.standard_normal((n, n))
    a = (b @ b.conj().T) / n + np.eye(n)
    return a.astype(dt)


def random_matrix(m: int, n: int, dtype, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "c":
        a = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    else:
        a = rng.standard_normal((m, n))
    return a.astype(dt)


def random_triangular(n: int, dtype, lower: bool = True, unit: bool = False, seed: int = 0):
    """Well-conditioned random triangular matrix."""
    a = random_matrix(n, n, dtype, seed)
    a = np.tril(a) if lower else np.triu(a)
    d = np.abs(np.diagonal(a)) + n  # diagonal dominance for conditioning
    np.fill_diagonal(a, 1.0 if unit else d)
    return a.astype(np.dtype(dtype))


def tol_for(dtype, n: int, factor: float = 10.0) -> float:
    """Error budget scaled with N, as in the reference checks."""
    eps = np.finfo(np.dtype(dtype)).eps
    return factor * max(n, 1) * float(eps)
