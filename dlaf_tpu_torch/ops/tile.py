"""Tile-level operations (counterpart of ``dlaf_tpu/ops/tile.py``).

A "tile stack" is a tensor ``[..., mb, nb]``; every op broadcasts over the
leading axes.  Where the JAX package leaves a tile op to XLA (``potrf`` of
complex tiles, every ``trsm`` but the Cholesky panel, the ``contract``
einsum), the port leaves it to the matching PyTorch call; the Cholesky-panel
``trsm`` goes to the hand-written kernel of ``ops/panel_trsm.py`` under
``tune.panel_trsm_pallas``, behind the JAX package's gate.

Float32 matrix products run in full float32: importing this module sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.set_float32_matmul_precision("highest")``.  The default tier of
``contract`` is a full-precision einsum in the JAX package, and TF32 (about
three decimal digits) would change it.
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch import tune
from dlaf_tpu_torch.ops import panel_trsm as _ptrsm

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# blas::Side / Uplo / Op / Diag analogues
LOWER = "L"
UPPER = "U"
LEFT = "Left"
RIGHT = "Right"
NO_TRANS = "N"
TRANS = "T"
CONJ_TRANS = "C"
UNIT = "U"
NON_UNIT = "N"


def _adj(a):
    return a.transpose(-1, -2).conj()


def op_tile(a, op: str):
    """Apply blas::Op to a tile stack."""
    if op == NO_TRANS:
        return a
    if op == TRANS:
        return a.transpose(-1, -2)
    if op == CONJ_TRANS:
        return _adj(a)
    raise ValueError(f"bad op {op}")


def potrf(a, lower: bool = True):
    """Cholesky of a (batch of) Hermitian tile(s); only the ``lower`` (or
    upper) triangle is read.  Returns the factor with the other triangle
    zero."""
    if lower:
        herm = torch.tril(a) + _adj(torch.tril(a, -1))
        return torch.linalg.cholesky(herm)
    herm = torch.triu(a) + _adj(torch.triu(a, 1))
    return _adj(torch.linalg.cholesky(_adj(herm)))


def trsm(side: str, uplo: str, op: str, diag: str, alpha, a, b):
    """B := alpha * op(A)^-1 B (Left) or alpha * B op(A)^-1 (Right), A
    triangular (only its ``uplo`` triangle is read).  Batched over leading
    axes; returns a contiguous tensor.

    ``tune.panel_trsm_pallas`` routes the Cholesky-panel case through the
    hand-written panel-TRSM kernel (``ops/panel_trsm.py``), as the JAX
    package routes it through its Pallas kernel (``tile.py:73-86``)."""
    bb = b if alpha == 1 else alpha * b
    if tune.get_tune_parameters().panel_trsm_pallas and _ptrsm.supported(side, uplo, op, diag, a, b):
        flat = bb.reshape(-1, b.shape[-1]).contiguous()
        out = _ptrsm.panel_trsm_right_lower_t(a.contiguous(), flat, op == CONJ_TRANS)
        return out.reshape(b.shape)
    lower = uplo == LOWER
    tri = op_tile(torch.tril(a) if lower else torch.triu(a), op)
    out = torch.linalg.solve_triangular(
        tri, bb,
        upper=lower == (op in (TRANS, CONJ_TRANS)),
        left=side == LEFT,
        unitriangular=diag == UNIT,
    )
    return out.contiguous()


def contract(subscripts, a, b, tier: str | None = None):
    """Two-operand contraction of the trailing updates.  Only the 'default'
    tier (a plain full-precision ``torch.einsum``) is ported; ``tier=None``
    resolves ``tune.gemm_precision``, whose other values raise."""
    tune.validate_gemm_precision(tune.resolved_gemm_precision() if tier is None else tier)
    return torch.einsum(subscripts, a, b)
