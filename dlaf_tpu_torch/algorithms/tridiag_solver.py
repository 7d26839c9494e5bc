"""Symmetric tridiagonal eigensolver entry point (counterpart of
``dlaf_tpu/algorithms/tridiag_solver.py``).

Only the default backend is ported: 'dc_dist', the multi-level D&C of
``tridiag_dc_dist.py``.  The host MRRR backend ('host') and the
single-device jitted D&C ('dc') raise, naming ROADMAP.md.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from dlaf_tpu_torch.comm.grid import Grid
from dlaf_tpu_torch.health import ConvergenceError
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix


def tridiagonal_eigensolver(
    grid: Grid,
    d: np.ndarray,
    e: np.ndarray,
    block_size: int,
    dtype=np.float64,
    spectrum: Optional[Tuple[int, int]] = None,
    backend: str = "dc_dist",
    raise_on_failure: bool = False,
) -> Tuple[np.ndarray, DistributedMatrix]:
    """Eigendecomposition of the real symmetric tridiagonal (d, e): returns
    (eigenvalues ascending on the host, eigenvector DistributedMatrix n x k
    over ``grid``).  ``raise_on_failure=True`` raises
    :class:`ConvergenceError` with the 1-based index of the first
    non-finite eigenvalue."""
    if backend in ("dc", "host"):
        raise NotImplementedError(
            f"tridiagonal_eigensolver(backend={backend!r}) is not ported: only "
            "'dc_dist' is (ROADMAP.md §A, item 5: the rest of the eigensolver)")
    if backend != "dc_dist":
        raise ValueError(f"tridiagonal_eigensolver: unknown backend {backend!r}")
    from dlaf_tpu_torch.algorithms.tridiag_dc_dist import tridiag_dc_distributed

    w, mat = tridiag_dc_distributed(grid, d, e, block_size, dtype=dtype, spectrum=spectrum)
    if raise_on_failure:
        finite = np.isfinite(w)
        if not finite.all():
            info = int(np.argmax(~finite)) + 1
            raise ConvergenceError(
                f"tridiagonal eigensolver (dc_dist) produced a non-finite eigenvalue "
                f"at 1-based index {info}", info=info)
    return w, mat
