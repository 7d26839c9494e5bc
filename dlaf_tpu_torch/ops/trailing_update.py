"""Trailing update ``x - contract(subscripts, a, b)``: the hand-written CUDA
kernel ``csrc/trailing_update.cu`` and its plain PyTorch version.

Replaces ``dlaf_tpu/ops/pallas_trailing_update.py`` (``trailing_update`` /
``_update_kernel``, and the one-rank branch of ``fused_transpose_update``),
tier 'default' only: the in-kernel bf16x3/bf16x6 split of the TPU kernel
waits in ROADMAP with ``gemm_precision``.  Two contractions, as the slice
uses them:

* ``iab,jcb->ijac``: ``x[i, j] -= a[i] @ b[j]^T`` (a [L, M, K], b [C, N, K]),
  the lookahead Cholesky bulk update;
* ``iab,jbc->ijac``: ``x[i, j] -= a[i] @ b[j]`` (b [C, K, N]), the lookahead
  triangular-solve bulk update.

* the same ``iab,jcb->ijac`` form at K = band (128 at nb=512) twice per
  panel of ``reduction_to_band`` under the fused tier, on a contiguous copy
  of the trailing window.

Both write into ``x`` in place (the JAX kernel returns a new array): on the
1x1 lookahead path ``x`` is the whole local tile stack, 1 GiB at N=16384 f32,
and a second copy buys nothing.

On the H100 the update at N=16384, nb=512 is 275 GFlop over 2.2 GB, so it is
bound by operations.  The kernel is a shared-memory-tiled FMA GEMM over the
tile batch: each 256-thread block computes one 64 x 64 output tile of one
(i, j) pair, 16-deep k slices staged in shared memory, a 4 x 4 register
tile per thread.  Its grid is one-dimensional (L*C*ceil(M/64)*ceil(N/64)
blocks, 65536 at N=16384) so it never meets the 65535 limit of ``gridDim.y``
and ``gridDim.z``.  It computes the masked zero slots too, as the TPU kernel
does.  No tensor cores yet: ``wgmma`` and TMA are later work.  See
``PERF.md`` for its measured time.
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch.ops import _build

#: launches of the CUDA kernel since the last reset
launches = 0

CHOLESKY_SUBSCRIPTS = "iab,jcb->ijac"
TRSM_SUBSCRIPTS = "iab,jbc->ijac"
_B_IS_NK = {CHOLESKY_SUBSCRIPTS: True, TRSM_SUBSCRIPTS: False}


def update_kernel_ok(dtype) -> bool:
    """Whether the kernel takes this dtype (real only; complex payloads go
    to ``x - contract(...)``, as on the JAX package's compiled TPU path)."""
    return dtype in (torch.float32, torch.float64)


def trailing_update_plain(x, a, b, subscripts: str = CHOLESKY_SUBSCRIPTS):
    """``x -= einsum(subscripts, a, b)``, in place; returns ``x``."""
    return x.sub_(torch.einsum(subscripts, a, b))


def trailing_update(x, a, b, subscripts: str = CHOLESKY_SUBSCRIPTS):
    """``x - contract(subscripts, a, b)`` written into ``x``; returns ``x``.
    CPU tensors take :func:`trailing_update_plain`; CUDA tensors launch the
    kernel or raise."""
    global launches
    if subscripts not in _B_IS_NK:
        raise ValueError(f"trailing_update: subscripts {subscripts!r} not in {tuple(_B_IS_NK)}")
    if all(t.device.type == "cpu" for t in (x, a, b)):
        return trailing_update_plain(x, a, b, subscripts)
    if x.device.type != "cuda" or a.device != x.device or b.device != x.device:
        raise ValueError(f"trailing_update: operands on {x.device}, {a.device}, {b.device}")
    if not update_kernel_ok(x.dtype) or a.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"trailing_update: dtypes {x.dtype}, {a.dtype}, {b.dtype}; need one real dtype")
    b_is_nk = _B_IS_NK[subscripts]
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 3:
        raise ValueError("trailing_update: need x [L, C, M, N], a [L, M, K], b 3-D")
    L, C, M, N = x.shape
    K = a.shape[2]
    want_b = (C, N, K) if b_is_nk else (C, K, N)
    if tuple(a.shape) != (L, M, K) or tuple(b.shape) != want_b:
        raise ValueError(
            f"trailing_update[{subscripts}]: x {tuple(x.shape)}, a {tuple(a.shape)}, "
            f"b {tuple(b.shape)} (b must be {want_b})"
        )
    if not (x.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("trailing_update: operands must be contiguous")
    if x.numel() == 0:
        return x
    lib = _build.lib()
    fn = lib.dlaf_trailing_update_f32 if x.dtype == torch.float32 else lib.dlaf_trailing_update_f64
    rc = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), L, C, M, N, K, int(b_is_nk),
            _build.stream_of(x))
    _build.check(rc, "trailing_update")
    with _build.COUNT_LOCK:  # rank threads launch concurrently
        launches += 1
    return x


def fused_transpose_update(x, cp, taken, have, suppress):
    """The fused tier's exchange-and-consume of one panel
    (``dlaf_tpu/ops/pallas_trailing_update.py:425``), one-rank branch:
    ``(taken, have)`` are the ``_parts`` of a ``transpose_panel*`` call, and
    on a size-1 axis the exchange moves nothing, so the row panel is
    ``rp = where(have, taken, 0)``.  ``suppress`` masks the slots whose
    update the caller applies elsewhere.  Applies
    ``x -= contract('iab,jcb->ijac', cp, rp_bulk.conj())`` through
    :func:`trailing_update` (the kernel on the card) and returns
    ``(x, rp)``; ``x`` is updated in place."""
    def expand(mask, t):
        return mask.reshape(mask.shape + (1,) * (t.dim() - mask.dim()))

    zero = torch.zeros((), dtype=taken.dtype, device=taken.device)
    rp = torch.where(expand(have, taken), taken, zero)
    rp_bulk = torch.where(expand(suppress, rp), zero, rp)
    b = rp_bulk.conj().contiguous()
    if update_kernel_ok(x.dtype):
        trailing_update(x, cp.contiguous(), b, CHOLESKY_SUBSCRIPTS)
    else:
        x.sub_(torch.einsum(CHOLESKY_SUBSCRIPTS, cp, b))
    return x, rp
