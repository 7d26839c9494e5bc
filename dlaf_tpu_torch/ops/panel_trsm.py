"""Panel triangular solve X op(L) = B: the hand-written CUDA kernel
``csrc/panel_trsm.cu`` and its plain PyTorch version.

Replaces ``dlaf_tpu/ops/pallas_panel_trsm.py`` (``panel_trsm_right_lower_t``
/ ``_kernel``): Right / Lower / op in {T, C} / non-unit, the solve of every
Cholesky panel against the factored diagonal tile.  Rows of X are
independent: ``x[r, j] = (b[r, j] - sum_{s<j} x[r, s] L[j, s]) / L[j, j]``,
in the TPU kernel's W=32 column blocks.

At the main path's tallest panel (15872 x 512 f32) the solve takes 4.2
GFlop and moves 66 MB, so on the H100 it is bound by operations.  The
kernel (body ``solve_rows`` in ``csrc/panel_trsm.cuh``) gives each warp a
few rows and keeps every later column block's GEMM sum of them in
registers, grown as each block is solved; the substitution runs on every
lane (lane = column, the solved value handed on by a warp shuffle); L
streams through shared memory in slabs by ``cp.async``; a block takes 1 to
8 warps, so short panels still spread over the SMs.  B7 and B8's tail run
the same body on runs of rows of the root's panel (``csrc/factor_send.cuh``).
Its first body (``solve_strip``: one block per 32-row strip), which no
main-path kernel runs any more, stays as :func:`panel_trsm_reference`, with
the same bits.
See ``PERF.md`` for the measured times.
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch.ops import _build

#: launches of the CUDA kernel since the last reset
launches = 0

W = 32  # column-block width, the TPU kernel's
MAX_NB = 1024


def supported(side, uplo, op, diag, a, b) -> bool:
    """The JAX package's gate (``pallas_panel_trsm.supported``) without its
    TPU-only "f32 only" clause: the card has f64."""
    from dlaf_tpu_torch.ops import tile as t

    rows = 1
    for s in b.shape[:-1]:
        rows *= s
    return (
        side == t.RIGHT
        and uplo == t.LOWER
        and op in (t.TRANS, t.CONJ_TRANS)
        and diag == t.NON_UNIT
        and a.dtype in (torch.float32, torch.float64)
        and a.dim() == 2
        and b.dim() in (2, 3)
        and b.shape[-1] == a.shape[-1]
        and a.shape[-1] % W == 0
        and 0 < a.shape[-1] <= MAX_NB
        and rows % 8 == 0
    )


def panel_trsm_plain(ell: torch.Tensor, b: torch.Tensor, conj: bool = False) -> torch.Tensor:
    """The TPU kernel's W=32 column-blocked schedule in PyTorch: per column
    block, a GEMM update from the solved blocks, then a W-step
    substitution against the diagonal block of U = tril(L)^T (a last
    block narrower than W when nb is not a multiple of W)."""
    nb = ell.shape[-1]
    if conj:
        ell = ell.conj()
    u = torch.tril(ell).T
    x = torch.zeros_like(b)
    for c0 in range(0, nb, W):
        bj = b[:, c0:c0 + W]
        if c0:
            bj = bj - x[:, :c0] @ u[:c0, c0:c0 + W]
        ujj = u[c0:c0 + W, c0:c0 + W]
        xj = torch.zeros_like(bj)
        for t in range(bj.shape[1]):
            contrib = xj[:, :t] @ ujj[:t, t]
            xj[:, t] = (bj[:, t] - contrib) / ujj[t, t]
        x[:, c0:c0 + W] = xj
    return x


def panel_trsm_right_lower_t(ell: torch.Tensor, b: torch.Tensor, conj: bool = False) -> torch.Tensor:
    """X with X @ op(L) = B, op = L^T (``conj=False``) or L^H; ``ell`` is
    the (nb, nb) lower factor (its upper triangle is not read), ``b`` is
    (m, nb).  A new tensor.  CPU tensors take :func:`panel_trsm_plain`;
    CUDA tensors launch the kernel or raise."""
    global launches
    if b.device.type == "cpu" and ell.device.type == "cpu":
        return panel_trsm_plain(ell, b, conj)
    x = _launch(ell, b, "dlaf_panel_trsm")
    with _build.COUNT_LOCK:  # rank threads launch concurrently
        launches += 1
    return x


def panel_trsm_reference(ell: torch.Tensor, b: torch.Tensor, conj: bool = False) -> torch.Tensor:
    """The same solve by B2's first body (``solve_strip``: one block of 256
    threads per 32-row strip, 16 in f64), the reference of the kernel's
    before/after check: the same bits.  CUDA tensors only (no plain
    version to fall back on); counts nothing."""
    return _launch(ell, b, "dlaf_panel_trsm_ref")


def _launch(ell: torch.Tensor, b: torch.Tensor, entry: str) -> torch.Tensor:
    """Check the operands and launch ``entry``_f32 / _f64 into a new X."""
    if ell.device.type != "cuda" or b.device != ell.device:
        raise ValueError(f"panel_trsm: operands on {ell.device} and {b.device}")
    if ell.dtype not in (torch.float32, torch.float64) or b.dtype != ell.dtype:
        raise TypeError(f"panel_trsm: dtypes {ell.dtype}, {b.dtype}; need one real dtype")
    nb = ell.shape[-1]
    if (ell.dim() != 2 or ell.shape[0] != nb or nb % W or not 0 < nb <= MAX_NB
            or b.dim() != 2 or b.shape[1] != nb or b.shape[0] % 8):
        raise ValueError(
            f"panel_trsm: need L (nb, nb) with nb % {W} == 0, nb <= {MAX_NB}, "
            f"and B (rows % 8 == 0, nb); got {tuple(ell.shape)}, {tuple(b.shape)}"
        )
    if not (ell.is_contiguous() and b.is_contiguous()):
        raise ValueError("panel_trsm: operands must be contiguous")
    # real dtypes only: op = C is op = T
    x = torch.empty_like(b)
    fn = getattr(_build.lib(), entry + ("_f32" if b.dtype == torch.float32 else "_f64"))
    rc = fn(ell.data_ptr(), b.data_ptr(), x.data_ptr(), b.shape[0], nb, _build.stream_of(b))
    _build.check(rc, entry)
    return x
