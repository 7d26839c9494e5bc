"""Tunable algorithm parameters of the port (counterpart of
``dlaf_tpu/tune.py``).

Only the knobs the Cholesky/POSV, HEEV and HEGV slices read are ported.  They keep the
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
- ``collectives_impl``: the tier of the one-contributor collectives on a
  grid axis of size > 1 (``comm/collectives.py``): 'psum' (a masked
  all-reduce), 'v2' (the doubling forward chain), 'pallas' (the ring
  kernels of ``ops/panel_exchange.py``: B5 and B7 on the card, their
  plain protocol twin on the CPU) or 'auto', which resolves as the JAX
  package's rule does: 'v2' on the card, 'psum' on the CPU, never
  'pallas'.
- ``gemm_precision``: the split-GEMM tier of ``ops.tile.contract`` and of
  the trailing-update kernels B3 and B9: 'default' (full operand
  precision), 'bf16x3' / 'bf16x6' (two / three bf16 slices per operand,
  f32 accumulation) or 'auto' (per call site, from the operands' device
  and contracted extent).  :func:`gemm_precision_scope` overrides it for
  the calls inside it, in this thread and in the rank threads that
  ``comm._ranks.spmd`` starts from it.
- ``bucket_segment_ratio``: window-shrink factor per bucketed segment
  (``algorithms._spmd.halving_segments``).
- ``gen_to_std_backend``: 'composed' (default: hermitize, then two full
  triangular solves) or 'fused' (the hegst tile recursion with the
  trailing solve deferred to one TRSM, ``algorithms/gen_to_std.py``); a
  1x1 grid always takes 'composed', as in the JAX package.

The eigensolver knobs (HEEV slice).  Where the JAX package resolves an
'auto' value (-1) by "the default JAX backend is an accelerator", the port
asks whether the grid's device is CUDA (:func:`on_accelerator`):

- ``eigensolver_min_band``: lower bound of ``get_band_size``'s band; -1 =
  33 on the CPU, 100 on the card (band 128 at nb=512).
- ``eigensolver_sbr_band``: target band of the SBR second stage; 0 = off,
  -1 = 32 on the card, off on the CPU.
- ``bt_band_hh_group_size``: reflector sweeps per compact-WY group of the
  band back-transform; -1 = 32 on the CPU, 128 on the card.
- ``dc_leaf_size``: leaf size of the distributed D&C tridiagonal solver.
- ``eigensolver_matmul_precision``: only full float32 products ('float32',
  its alias 'f32', or 'highest'; no TF32) are ported; every other value
  raises.
- ``band_chase_backend``: 'native' (the threaded host chase,
  ``csrc/host/band2trid.cpp``) or 'auto' (the device chase on the card,
  the native one on the CPU).  The device wavefront chase is not ported:
  'device', and 'auto' on the card, raise ``NotImplementedError``.
- ``dc_secular_pallas``: read from the JAX package's environment and kept
  for it, but it selects nothing in the port: the D&C secular bisection
  always goes through ``ops/secular.py`` for f32 (the kernel on the card,
  the plain loop for CPU tensors), and f64 takes the plain loop, as the
  JAX gate.  The card has no second route for f32.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass, field, fields

from dlaf_tpu_torch.health import ConfigurationError

TRAILING_UPDATE_IMPLS = ("xla", "fused", "auto")
COLLECTIVES_IMPLS = ("psum", "v2", "pallas", "auto")
#: the JAX package's domains; values outside the ported subset raise
BAND_CHASE_BACKENDS = ("native", "device", "auto")
#: the values that mean full float32 products, the only ones ported
FULL_F32_PRECISIONS = ("float32", "f32", "highest")
#: the split-GEMM tiers (``ops/tile.py``)
GEMM_PRECISIONS = ("default", "bf16x3", "bf16x6", "auto")
#: the backends of ``generalized_to_standard``
GEN_TO_STD_BACKENDS = ("composed", "fused")


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
    collectives_impl: str = field(default_factory=lambda: _env("collectives_impl", "auto", str))
    trailing_update_impl: str = field(
        default_factory=lambda: _env("trailing_update_impl", "auto", str)
    )
    panel_trsm_pallas: bool = field(default_factory=lambda: _env("panel_trsm_pallas", False, bool))
    eigensolver_min_band: int = field(default_factory=lambda: _env("eigensolver_min_band", -1, int))
    eigensolver_sbr_band: int = field(default_factory=lambda: _env("eigensolver_sbr_band", -1, int))
    bt_band_hh_group_size: int = field(
        default_factory=lambda: _env("bt_band_hh_group_size", -1, int)
    )
    dc_leaf_size: int = field(default_factory=lambda: _env("dc_leaf_size", 512, int))
    eigensolver_matmul_precision: str = field(
        default_factory=lambda: _env("eigensolver_matmul_precision", "float32", str)
    )
    band_chase_backend: str = field(
        default_factory=lambda: _env("band_chase_backend", "auto", str)
    )
    dc_secular_pallas: bool = field(default_factory=lambda: _env("dc_secular_pallas", False, bool))
    gen_to_std_backend: str = field(
        default_factory=lambda: _env("gen_to_std_backend", "composed", str)
    )

    def update(self, **kwargs) -> "TuneParameters":
        names = {f.name for f in fields(self)}
        for k, v in kwargs.items():
            if k not in names:
                raise ValueError(f"unknown tune parameter {k!r}")
            if k == "trailing_update_impl":
                validate_trailing_update_impl(v)
            elif k == "collectives_impl":
                validate_collectives_impl(v)
            elif k == "gemm_precision":
                validate_gemm_precision(v)
            elif k == "eigensolver_matmul_precision":
                validate_eigensolver_matmul_precision(v)
            elif k == "band_chase_backend":
                validate_band_chase_backend(v)
            elif k == "gen_to_std_backend":
                validate_gen_to_std_backend(v)
            elif k == "dc_leaf_size" and int(v) < 1:
                raise ConfigurationError(f"dc_leaf_size must be >= 1, got {v!r}")
            setattr(self, k, v)
        return self


def validate_trailing_update_impl(value) -> str:
    if value not in TRAILING_UPDATE_IMPLS:
        raise ConfigurationError(
            f"trailing_update_impl must be one of {TRAILING_UPDATE_IMPLS}, "
            f"got {value!r} (env DLAF_TPU_TRAILING_UPDATE_IMPL)"
        )
    return value


def validate_collectives_impl(value) -> str:
    """Checked on ``update(collectives_impl=...)`` and again when the
    collectives resolve the knob, which catches a typo in
    ``DLAF_TPU_COLLECTIVES_IMPL`` (``dlaf_tpu/tune.py:569``)."""
    if value not in COLLECTIVES_IMPLS:
        raise ConfigurationError(
            f"collectives_impl must be one of {COLLECTIVES_IMPLS}, "
            f"got {value!r} (env DLAF_TPU_COLLECTIVES_IMPL)"
        )
    return value


def collectives_tier(device) -> str:
    """The resolved collectives tier on ``device``: 'psum', 'v2' or
    'pallas'; 'auto' is 'v2' on the card and 'psum' on the CPU
    (``dlaf_tpu/plan/autotune.py:143`` without a loaded profile)."""
    impl = validate_collectives_impl(get_tune_parameters().collectives_impl)
    if impl == "auto":
        return "v2" if on_accelerator(device) else "psum"
    return impl


def validate_gemm_precision(value) -> str:
    if value not in GEMM_PRECISIONS:
        raise ConfigurationError(
            f"gemm_precision must be one of {GEMM_PRECISIONS}, "
            f"got {value!r} (env DLAF_TPU_GEMM_PRECISION)"
        )
    return value


def validate_eigensolver_matmul_precision(value) -> str:
    if value not in FULL_F32_PRECISIONS:
        raise ConfigurationError(
            f"eigensolver_matmul_precision={value!r} is not ported: the port runs "
            f"the eigensolver in full float32 only, {FULL_F32_PRECISIONS} (no TF32, "
            "no bf16 passes; env DLAF_TPU_EIGENSOLVER_MATMUL_PRECISION); see "
            "ROADMAP.md, queue A item 4"
        )
    return value


#: the matmul precision strings the JAX package's knobs accept that mean
#: full float32 in the port ('' and 'default' keep the global setting,
#: which the port pins to full float32, ``ops/tile.py``)
MATMUL_PRECISIONS = ("", "default", "float32", "highest")


@contextlib.contextmanager
def matmul_precision(p: str, knob: str = "matmul_precision"):
    """Scope of one matmul precision (``dlaf_tpu/tune.py:790``).  The port
    runs its float32 products in full float32 and refuses TF32, so every
    accepted value means the same thing: the scope checks that TF32 is off
    on entry.  Any other value raises :class:`ConfigurationError`."""
    import torch

    if p not in MATMUL_PRECISIONS:
        raise ConfigurationError(
            f"{knob}={p!r} is not ported: the port's float32 products are full float32 "
            f"only, {MATMUL_PRECISIONS} (no TF32, no bf16 passes); see ROADMAP.md, "
            "queue A item 4"
        )
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise ConfigurationError(
            f"{knob}={p!r}: float32 products must be full float32 "
            "(torch.backends.cuda.matmul.allow_tf32 False, "
            "torch.get_float32_matmul_precision() == 'highest')")
    yield p


def validate_band_chase_backend(value) -> str:
    if value not in BAND_CHASE_BACKENDS:
        raise ConfigurationError(
            f"band_chase_backend must be one of {BAND_CHASE_BACKENDS}, "
            f"got {value!r} (env DLAF_TPU_BAND_CHASE_BACKEND)"
        )
    return value


def validate_gen_to_std_backend(value) -> str:
    """Checked on ``update(gen_to_std_backend=...)`` and again where
    ``generalized_to_standard`` reads the knob (a typo in the environment)."""
    if value not in GEN_TO_STD_BACKENDS:
        raise ConfigurationError(
            f"gen_to_std_backend must be one of {GEN_TO_STD_BACKENDS}, "
            f"got {value!r} (env DLAF_TPU_GEN_TO_STD_BACKEND)"
        )
    return value


def on_accelerator(device) -> bool:
    """The port's reading of the JAX package's "accelerator backend": the
    grid's device is a CUDA device."""
    import torch

    return torch.device(device).type == "cuda"


def trailing_update_tier() -> str:
    """The resolved lookahead trailing-update tier: 'xla' or 'fused'."""
    impl = validate_trailing_update_impl(get_tune_parameters().trailing_update_impl)
    return "xla" if impl == "auto" else impl


# The ambient split-GEMM tier override (``dlaf_tpu/tune.py:466-486``): the
# refinement loops (``algorithms/refine.py``) compute their residuals under
# gemm_precision_scope('default') while the factorization and the solves
# keep the fast tier.  A context variable, so that rank threads started
# inside the scope see it (``comm._ranks.spmd`` runs each rank body in a
# copy of the caller's context).
_gemm_precision_override: contextvars.ContextVar = contextvars.ContextVar(
    "dlaf_tpu_torch_gemm_precision_override", default=None
)


@contextlib.contextmanager
def gemm_precision_scope(tier: str):
    """Force the split-GEMM tier of the contractions made inside the scope,
    overriding ``gemm_precision``."""
    validate_gemm_precision(tier)
    token = _gemm_precision_override.set(tier)
    try:
        yield tier
    finally:
        _gemm_precision_override.reset(token)


def resolved_gemm_precision() -> str:
    """The split-GEMM tier in effect in the calling thread: the active
    :func:`gemm_precision_scope`, else the (validated) knob.  'auto' is
    returned as it is: ``ops.tile.contract`` resolves it per call site."""
    override = _gemm_precision_override.get()
    if override is not None:
        return override
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
