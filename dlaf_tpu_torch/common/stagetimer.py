"""Opt-in per-stage wall-time breakdown of the pipeline algorithms
(counterpart of ``dlaf_tpu/common/stagetimer.py``).

Off by default, and then free: :func:`stage` yields at once.  While
collecting, each stage boundary synchronises the card
(``torch.cuda.synchronize``), so a stage's device work is charged to that
stage and not to the next one's clock.  That serialises the host and the
card, so an instrumented run is a run of its own, never the timed one.
"""
from __future__ import annotations

import contextlib
import time

_times: dict | None = None


def start() -> None:
    """Begin collecting; resets any previous breakdown."""
    global _times
    _times = {}


def stop() -> dict:
    """Stop collecting and return {stage: seconds} in insertion order."""
    global _times
    t, _times = _times or {}, None
    return t


def _sync(device) -> None:
    import torch

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage(name: str, device=None):
    """Accumulate the wall time of the body under ``name``, synchronising
    ``device`` (a CUDA device; nothing to wait for on the CPU) at both
    ends; a no-op when not collecting."""
    if _times is None:
        yield
        return
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if _times is not None:
            _sync(device)
            _times[name] = _times.get(name, 0.0) + time.perf_counter() - t0
