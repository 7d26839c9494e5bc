"""Shared helpers of the distributed algorithm kernels (counterpart of
``dlaf_tpu/algorithms/_spmd.py``).

The JAX package runs each kernel inside ``shard_map`` with traced indices
and ``lax.dynamic_slice``; the port runs eager loops with Python-int panel
indices, and ordinary slicing of the local tile stack ``x[ltr, ltc, mb, nb]``
takes the place of the dynamic slices.  Window starts are clamped exactly
as the JAX windows clamp (see the bucketed kernels), so every slice here
covers the same slots.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from dlaf_tpu_torch import tune
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.matrix.distribution import Distribution


@dataclass(frozen=True)
class Geometry:
    """Static per-matrix geometry of a stacked block-cyclic matrix."""

    m: int
    n: int
    mb: int
    nb: int
    mt: int  # global tile rows
    nt: int  # global tile cols
    pr: int
    pc: int
    ltr: int  # local row slots
    ltc: int  # local col slots

    @classmethod
    def of(cls, dist: Distribution) -> "Geometry":
        if dist.source_rank != (0, 0):
            raise NotImplementedError("the distributed kernels assume source_rank == (0, 0)")
        return cls(
            m=dist.size.rows,
            n=dist.size.cols,
            mb=dist.block_size.rows,
            nb=dist.block_size.cols,
            mt=dist.nr_tiles.rows,
            nt=dist.nr_tiles.cols,
            pr=dist.grid_size.rows,
            pc=dist.grid_size.cols,
            ltr=dist.local_slots.rows,
            ltc=dist.local_slots.cols,
        )


def bucket_ratio() -> float:
    """The active segment ratio, clamped as :func:`halving_segments` applies it."""
    return max(1.01, float(tune.get_tune_parameters().bucket_segment_ratio))


def halving_segments(n: int, ratio: float | None = None):
    """Panel-index segments [k0, k1) whose trailing extent shrinks by
    ``ratio`` per segment; each segment runs with one trailing-window size.
    Same segments as the JAX package, so window sizes and flop counts
    match."""
    ratio = bucket_ratio() if ratio is None else max(1.01, ratio)
    segs = []
    k0 = 0
    while k0 < n:
        k1 = min(n, n - int((n - k0) / ratio))
        if k1 <= k0:
            k1 = k0 + 1
        segs.append((k0, k1))
        k0 = k1
    return segs


def local_row_tiles(g: Geometry, myr: int, device) -> torch.Tensor:
    """Global row-tile index of each local row slot: gi[li] = li*Pr + myr."""
    return torch.arange(g.ltr, device=device) * g.pr + myr


def local_col_tiles(g: Geometry, myc: int, device) -> torch.Tensor:
    return torch.arange(g.ltc, device=device) * g.pc + myc


def pad_diag_identity(x, g: Geometry, myr: int, myc: int, remove: bool = False):
    """Add (or remove) 1.0 on the padding diagonal elements (global element
    index >= min(m, n) on diagonal tiles), in place, so factorizations of
    padded edge tiles stay non-singular.  Only the diagonal tiles that hold
    padding are touched; returns ``x``."""
    lim = min(g.m, g.n)
    sign = -1.0 if remove else 1.0
    for li in range(g.ltr):
        gi = li * g.pr + myr
        if gi % g.pc != myc:
            continue
        lj = gi // g.pc
        first = max(lim - gi * g.mb, 0)  # first padding row inside the tile
        if lj >= g.ltc or first >= min(g.mb, g.nb):
            continue
        idx = torch.arange(first, min(g.mb, g.nb), device=x.device)
        x[li, lj, idx, idx] += sign
    return x


def take_col(x, lkc: int, g: Geometry):
    """Local tile column ``lkc`` -> [ltr, mb, nb] (a view)."""
    return x[:, lkc]


def put_col(x, col, lkc: int):
    x[:, lkc] = col
    return x


def take_row(x, lkr: int, g: Geometry):
    """Local tile row ``lkr`` -> [ltc, mb, nb] (a view)."""
    return x[lkr]


def put_row(x, row, lkr: int):
    x[lkr] = row
    return x


def take_tile(col, lk: int):
    return col[lk]


def bcast_diag_tile(x, k: int, g: Geometry, myr: int, myc: int):
    """Global diagonal tile (k, k) on every rank, as a fresh tensor."""
    kr, kc = k % g.pr, k % g.pc
    t = take_tile(take_col(x, k // g.pc, g), k // g.pr)
    mine = (myr == kr) and (myc == kc)
    return coll.bcast2d(t.clone() if mine else torch.zeros_like(t), kr, kc)
