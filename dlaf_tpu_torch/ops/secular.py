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
registers, one row per block, and runs every round on the resident row
(see the source for the design).  Counting 4 flops per element and round
(the subtraction, the IEEE division as one flop, the accumulation as one
FMA of two) against 2 * K * S * 4 bytes of tables, it is bound by
operations on the H100; a real IEEE division costs several instructions,
so the kernel cannot reach that bound.  Its results agree with the plain loop's to
rounding (the row sums are taken in another order), not bit for bit.  f32
only, as the JAX package's gate (``tridiag_dc_dist.py:283-285``); an f64
caller takes the plain loop.
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


def secular_bisect(dw, z2w, rho, anchor, lo0, hi0, iters: int):
    """Roots (offsets from ``anchor``) of the secular function, one per row.
    CPU tensors take :func:`secular_bisect_plain`; CUDA tensors launch the
    kernel or raise."""
    global launches
    ops_ = (dw, z2w, rho, anchor, lo0, hi0)
    if all(t.device.type == "cpu" for t in ops_):
        return secular_bisect_plain(dw, z2w, rho, anchor, lo0, hi0, iters)
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
    rc = _build.lib().dlaf_secular_bisect_f32(
        dw.data_ptr(), z2w.data_ptr(), rho.data_ptr(), anchor.data_ptr(), lo0.data_ptr(),
        hi0.data_ptr(), out.data_ptr(), K, S, int(iters), _build.stream_of(dw))
    _build.check(rc, "secular_bisect")
    with _build.COUNT_LOCK:  # rank threads launch concurrently
        launches += 1
    return out
