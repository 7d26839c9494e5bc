"""Secular-equation bisection of the D&C merge: the hand-written CUDA
kernel ``csrc/secular.cu`` and its plain PyTorch version.

Replaces ``dlaf_tpu/ops/pallas_secular.py`` (``secular_bisect`` /
``_kernel``).  For each row ``r`` of the ``(K, S)`` pole table ``dw`` and
weight table ``z2``, ``iters`` rounds of bisection on

    f(x) = 1 + rho[r] * sum_s z2[r, s] / (dw[r, s] - anchor[r] - x)

starting from the bracket ``(lo0[r], hi0[r])``; returns the midpoints of
the final brackets, shape ``(K,)``.

On the HEEV path (N=8192, one rank) the tables are (8192, S) f32 with S =
1024 .. 8192, two launches per merge level.  The plain loop reads both
tables from device memory in every round; the kernel reads them once into
registers, one row per block, and runs every round on the resident row,
one barrier a round, dividing by the IEEE division's fast path without a
branch wherever that gives its bits, and stops a row once a round leaves
its bracket unchanged bit for bit (every later round would leave it so
too: see the source).  Counting 4 flops per element and round (the
subtraction, the IEEE division as one flop, the accumulation as one FMA
of two) over the rounds the rows need, against 2 * K * S * 4 bytes of
tables, its bound on the H100 is the bytes at path H's shapes; a real
IEEE division costs several instructions, so the kernel cannot reach it.  Its results agree with the plain loop's to rounding (the row
sums are taken in another order), not bit for bit; they are bit for bit
those of its first body, which runs every round and stays as
:func:`secular_bisect_reference`.  f32 only, as the JAX package's gate
(``tridiag_dc_dist.py:283-285``); an f64 caller takes the plain loop.
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch.ops import _build

#: launches of the CUDA kernel since the last reset
launches = 0


def secular_bisect_plain(dw, z2w, rho, anchor, lo0, hi0, iters: int):
    """The JAX package's XLA bisection (``tridiag_dc_dist.py:297-308``)."""
    tiny = torch.finfo(dw.dtype).tiny
    ag = dw - anchor[:, None]
    lo, hi = lo0, hi0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        diff = ag - mid[:, None]
        safe = torch.where(diff == 0, tiny, diff)
        fm = 1.0 + rho * torch.sum(z2w / safe, dim=1)
        neg = fm < 0
        lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
    return 0.5 * (lo + hi)


def secular_rounds_plain(dw, z2w, rho, anchor, lo0, hi0, iters: int):
    """For each row, the last of the plain loop's ``iters`` rounds that
    changed its bracket (0 if none did): the rounds the row needs.  The
    ends are compared by their bits, as the kernel compares them, so a NaN
    bracket counts as fixed and a -0.0 / +0.0 flip as a change.  A row
    that needs ``n < iters`` rounds reaches the fixed point that the
    kernel stops at; its answer is the plain loop's after all ``iters``.
    (The kernel sums each row in another order, so the rounds it runs
    differ where that order gives f(mid) another sign.)  Int64, shape
    ``(K,)``; for the tests and the measurements, not the main path."""
    tiny = torch.finfo(dw.dtype).tiny
    ibits = torch.int32 if dw.element_size() == 4 else torch.int64
    ag = dw - anchor[:, None]
    lo, hi = lo0, hi0
    last = torch.zeros(lo0.shape, dtype=torch.int64, device=lo0.device)
    for it in range(iters):
        mid = 0.5 * (lo + hi)
        diff = ag - mid[:, None]
        safe = torch.where(diff == 0, tiny, diff)
        fm = 1.0 + rho * torch.sum(z2w / safe, dim=1)
        neg = fm < 0
        nlo, nhi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
        moved = (nlo.view(ibits) != lo.view(ibits)) | (nhi.view(ibits) != hi.view(ibits))
        last = torch.where(moved, it + 1, last)
        lo, hi = nlo, nhi
    return last


def secular_bisect(dw, z2w, rho, anchor, lo0, hi0, iters: int):
    """Roots (offsets from ``anchor``) of the secular function, one per row.
    CPU tensors take :func:`secular_bisect_plain`; CUDA tensors launch the
    kernel or raise."""
    global launches
    if all(t.device.type == "cpu" for t in (dw, z2w, rho, anchor, lo0, hi0)):
        return secular_bisect_plain(dw, z2w, rho, anchor, lo0, hi0, iters)
    out = _launch("dlaf_secular_bisect_f32", dw, z2w, rho, anchor, lo0, hi0, iters)
    with _build.COUNT_LOCK:  # rank threads launch concurrently
        launches += 1
    return out


def secular_bisect_reference(dw, z2w, rho, anchor, lo0, hi0, iters: int):
    """The same roots by B10's first body (every one of the ``iters``
    rounds, two barriers each), the reference of the kernel's before/after
    check: the same bits.  CUDA tensors only (no plain version to fall back
    on); counts nothing."""
    return _launch("dlaf_secular_bisect_ref_f32", dw, z2w, rho, anchor, lo0, hi0, iters)


def _launch(entry: str, dw, z2w, rho, anchor, lo0, hi0, iters: int):
    """Check the operands and launch ``entry`` into a new ``(K,)`` tensor."""
    ops_ = (dw, z2w, rho, anchor, lo0, hi0)
    if dw.device.type != "cuda" or any(t.device != dw.device for t in ops_):
        raise ValueError(f"secular_bisect: operands on {[str(t.device) for t in ops_]}")
    if any(t.dtype != torch.float32 for t in ops_):
        raise TypeError(f"secular_bisect: the kernel takes float32 only, got {dw.dtype}")
    if dw.dim() != 2 or z2w.shape != dw.shape:
        raise ValueError(f"secular_bisect: dw {tuple(dw.shape)}, z2w {tuple(z2w.shape)}")
    K, S = dw.shape
    if any(tuple(t.shape) != (K,) for t in ops_[2:]):
        raise ValueError(f"secular_bisect: rho/anchor/lo0/hi0 must have shape ({K},)")
    if not all(t.is_contiguous() for t in ops_):
        raise ValueError("secular_bisect: operands must be contiguous")
    if K >= 2 ** 31 or S >= 2 ** 31 or iters < 0:
        raise ValueError(f"secular_bisect: K={K}, S={S}, iters={iters} out of range")
    out = torch.empty(K, dtype=dw.dtype, device=dw.device)
    if K == 0:
        return out
    rc = getattr(_build.lib(), entry)(
        dw.data_ptr(), z2w.data_ptr(), rho.data_ptr(), anchor.data_ptr(), lo0.data_ptr(),
        hi0.data_ptr(), out.data_ptr(), K, S, int(iters), _build.stream_of(dw))
    _build.check(rc, entry)
    return out
