"""Error taxonomy of the port (counterpart of ``dlaf_tpu/health.py:38-84``).

Only the exception classes the ported slices raise are ported, with the
stage-boundary NaN/Inf sentinel :func:`check_finite` and the health event
stream's :func:`record` / :func:`capture_events` (``dlaf_tpu/health.py:
209-236``); the stream's ``obs.metrics`` sink waits for the observability
item of ROADMAP queue A (item 7).  LAPACK conventions carry over: ``info
== 0`` is success, ``info == k > 0`` names the 1-based first failing
pivot.
"""
from __future__ import annotations

import os
from contextlib import contextmanager


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


class ConvergenceError(DlafError, RuntimeError):
    """An iterative stage did not converge (e.g. a non-finite eigenvalue out
    of the tridiagonal solver).  ``info`` carries the solver's detail."""

    def __init__(self, message: str, info=None):
        self.info = info
        super().__init__(message)


class DeadlineExceededError(DlafError, TimeoutError):
    """A bounded wait did not complete within its budget
    (``dlaf_tpu/health.py:98``).  In the port every wait of the rank
    runtime (``comm/_ranks.py``) and of the ring kernels
    (``ops/panel_exchange.py``) is bounded and raises this instead of
    hanging.  ``budget_s`` is the bound that ran out; ``label`` names the
    bounded operation.  Subclasses ``TimeoutError`` so generic timeout
    handlers keep working."""

    def __init__(self, budget_s: float, label: str | None = None,
                 message: str | None = None):
        self.budget_s = float(budget_s)
        self.label = label
        if message is None:
            what = f" ({label})" if label else ""
            message = f"operation{what} exceeded its deadline of {self.budget_s:g} s"
        super().__init__(message)


class NonFiniteError(DlafError, ArithmeticError):
    """A stage-boundary sentinel found NaN/Inf.  ``stage`` names the first
    pipeline stage whose output went non-finite."""

    def __init__(self, stage: str, message: str | None = None):
        self.stage = stage
        super().__init__(
            message
            or f"non-finite values (NaN/Inf) first appeared after stage {stage!r}"
        )


def check_level() -> int:
    """``DLAF_TPU_CHECK_LEVEL``, read on every call (default 1), as the JAX
    package reads it (``dlaf_tpu/common/checks.py:23``)."""
    try:
        return int(os.environ.get("DLAF_TPU_CHECK_LEVEL", "1"))
    except ValueError:
        return 1


def check_finite(stage: str, *operands) -> None:
    """NaN/Inf sentinel at a pipeline stage boundary
    (``dlaf_tpu/health.py:237``).  Below check level 2 it returns at once
    and touches no operand; at level 2 and above every operand (a
    ``DistributedMatrix``, ``ColPanels``, tensor or numpy array) is reduced
    with ``isfinite`` in one host synchronisation, and the first non-finite
    one raises :class:`NonFiniteError` naming ``stage``."""
    if check_level() < 2:
        return
    import numpy as np
    import torch

    flags = []
    for op in operands:
        if op is None:
            continue
        d = getattr(op, "data", op)
        if isinstance(d, np.ndarray):
            d = torch.from_numpy(d)
        flags.append(torch.isfinite(d).all())
    if flags and not bool(torch.stack([f.to(flags[0].device) for f in flags]).all()):
        raise NonFiniteError(stage)


# ----------------------------------------------------------- event stream

_captured: list | None = None


def record(event: str, **fields) -> None:
    """Record one health event (a fallback, a stall) into the innermost
    :func:`capture_events` list; free when nothing captures."""
    if _captured is not None:
        _captured.append({"event": event, **fields})


@contextmanager
def capture_events():
    """Collect health events into the yielded list (for tests).  Nested
    captures see only their own events; the outer one resumes when the
    inner one exits."""
    global _captured
    prev, _captured = _captured, []
    try:
        yield _captured
    finally:
        _captured = prev
