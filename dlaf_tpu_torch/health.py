"""Error taxonomy of the port (counterpart of ``dlaf_tpu/health.py:38-84``).

Only the four exception classes the Cholesky/POSV slice raises are ported;
the NaN sentinels and the health event stream wait for the observability
items of ROADMAP queue A.  LAPACK conventions carry over: ``info == 0`` is
success, ``info == k > 0`` names the 1-based first failing pivot.
"""
from __future__ import annotations


class DlafError(Exception):
    """Base of the dlaf_tpu_torch error taxonomy."""


class NotPositiveDefiniteError(DlafError, ArithmeticError):
    """A Cholesky-based driver met a non-positive pivot.

    ``info`` is the LAPACK-style 1-based index of the first failing pivot
    (the leading minor of order ``info`` is not positive definite).
    ``shift`` is the last diagonal shift tried when bounded recovery was
    on (0.0 when recovery was off)."""

    def __init__(self, info: int, message: str | None = None, shift: float = 0.0):
        self.info = int(info)
        self.shift = float(shift)
        if message is None:
            message = (
                f"matrix is not positive definite: the leading minor of "
                f"order {self.info} failed (LAPACK info={self.info})"
            )
            if shift:
                message += f"; last diagonal shift tried: {shift:g}"
        super().__init__(message)


class DistributionError(DlafError, ValueError):
    """Invalid matrix/grid distribution or API misuse (bad descriptor,
    non-square tiles, shape mismatch)."""


class ConfigurationError(DlafError, ValueError):
    """A tune/config knob holds a value outside its documented domain."""
