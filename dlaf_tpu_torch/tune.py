"""Tunable algorithm parameters of the port (counterpart of
``dlaf_tpu/tune.py``).

Only the knobs the Cholesky/POSV slice reads are ported.  They keep the
JAX package's names, defaults and ``DLAF_TPU_*`` environment variables, so
one environment configures both packages, and the same precedence:
defaults, then the environment (read when the parameters are built), then
explicit :meth:`TuneParameters.update` calls.

- ``cholesky_lookahead`` / ``trsm_lookahead``: use the lookahead kernel
  (panel k+1 factored before the bulk trailing update) instead of the
  bucketed default.
- ``trailing_update_impl``: 'xla' = the bulk lookahead update as a plain
  ``torch.einsum``; 'fused' = the hand-written trailing-update kernel
  (``ops/trailing_update.py``); 'auto' resolves to 'xla', as the JAX
  package does when no autotune profile is loaded.
- ``panel_trsm_pallas``: route the Cholesky-panel triangular solve through
  the hand-written panel-TRSM kernel (``ops/panel_trsm.py``).  The name is
  the JAX package's (where it selects the Pallas kernel) so that one
  environment variable, ``DLAF_TPU_PANEL_TRSM_PALLAS``, configures both.
- ``gemm_precision``: only 'default' (full operand precision) is ported;
  the bf16 split tiers wait in ROADMAP (queue A, item 4).
- ``bucket_segment_ratio``: window-shrink factor per bucketed segment
  (``algorithms._spmd.halving_segments``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field, fields

from dlaf_tpu_torch.health import ConfigurationError

TRAILING_UPDATE_IMPLS = ("xla", "fused", "auto")
#: the JAX package's domain; every value but 'default' raises here
GEMM_PRECISIONS = ("default", "bf16x3", "bf16x6", "auto")


def _env(name: str, default, cast):
    v = os.environ.get(f"DLAF_TPU_{name.upper()}")
    if v is None:
        return default
    if cast is bool:
        return v.lower() in ("1", "true", "yes", "on")
    return cast(v)


@dataclass
class TuneParameters:
    gemm_precision: str = field(default_factory=lambda: _env("gemm_precision", "default", str))
    bucket_segment_ratio: float = field(
        default_factory=lambda: _env("bucket_segment_ratio", 1.26, float)
    )
    cholesky_lookahead: bool = field(default_factory=lambda: _env("cholesky_lookahead", False, bool))
    trsm_lookahead: bool = field(default_factory=lambda: _env("trsm_lookahead", False, bool))
    trailing_update_impl: str = field(
        default_factory=lambda: _env("trailing_update_impl", "auto", str)
    )
    panel_trsm_pallas: bool = field(default_factory=lambda: _env("panel_trsm_pallas", False, bool))

    def update(self, **kwargs) -> "TuneParameters":
        names = {f.name for f in fields(self)}
        for k, v in kwargs.items():
            if k not in names:
                raise ValueError(f"unknown tune parameter {k!r}")
            if k == "trailing_update_impl":
                validate_trailing_update_impl(v)
            elif k == "gemm_precision":
                validate_gemm_precision(v)
            setattr(self, k, v)
        return self


def validate_trailing_update_impl(value) -> str:
    if value not in TRAILING_UPDATE_IMPLS:
        raise ConfigurationError(
            f"trailing_update_impl must be one of {TRAILING_UPDATE_IMPLS}, "
            f"got {value!r} (env DLAF_TPU_TRAILING_UPDATE_IMPL)"
        )
    return value


def validate_gemm_precision(value) -> str:
    if value not in GEMM_PRECISIONS:
        raise ConfigurationError(
            f"gemm_precision must be one of {GEMM_PRECISIONS}, "
            f"got {value!r} (env DLAF_TPU_GEMM_PRECISION)"
        )
    if value != "default":
        raise ConfigurationError(
            f"gemm_precision={value!r} is not ported yet: the bf16 split "
            "tiers wait in ROADMAP.md queue A, item 4 (split tiers in "
            "contract and in the trailing-update kernel)"
        )
    return value


def trailing_update_tier() -> str:
    """The resolved lookahead trailing-update tier: 'xla' or 'fused'."""
    impl = validate_trailing_update_impl(get_tune_parameters().trailing_update_impl)
    return "xla" if impl == "auto" else impl


def resolved_gemm_precision() -> str:
    return validate_gemm_precision(get_tune_parameters().gemm_precision)


_params: TuneParameters | None = None


def get_tune_parameters() -> TuneParameters:
    """Module singleton, mutable between algorithm calls."""
    global _params
    if _params is None:
        _params = TuneParameters()
    return _params


def initialize(**overrides) -> TuneParameters:
    """Reset the parameters from defaults and environment, then apply
    ``overrides``."""
    global _params
    _params = TuneParameters()
    return _params.update(**overrides)
