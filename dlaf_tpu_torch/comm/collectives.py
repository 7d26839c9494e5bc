"""Grid collectives (counterpart of ``dlaf_tpu/comm/collectives.py``).

Every function runs inside a rank of :func:`spmd` (``comm/_ranks.py``):
``my_rank``/``axis_size`` read the calling rank thread's context, and a
collective over an axis of size > 1 meets the other ranks of this rank's
ring on that axis (the ranks of its row for 'c', of its column for 'r',
every rank of the grid for :data:`BOTH`).  Outside ``spmd`` a caller is the one rank of a 1x1 grid.  A size-1 axis
is the identity everywhere, as in the JAX package.

Every redistribution here has one contributor per output slot, so three
tiers give the same bits (``tune.collectives_impl``):

- 'psum': a masked all-reduce.  Every rank publishes its root-masked
  contribution and sums all of them in ring order (one non-zero addend:
  the sum is that addend, except that ``-0.0 + 0.0`` is ``+0.0``);
- 'v2': the doubling forward chain (:func:`_forward_chain`), the
  ``lax.ppermute`` rounds as in-process exchanges;
- 'pallas': the neighbour ring of ``ops/panel_exchange.py``: on the card the
  hand-written ring kernel (B5), on the CPU its plain twin, which runs the
  same landing-slot protocol with B4's plain merge.

The psum and v2 transports are the runtime's in-process exchange
(``_ranks.exchange``): library copies, as the JAX package's are XLA
collectives.  Multi-contributor sums (:func:`psum_axis`) stay psum in every
tier.  'auto' resolves as the JAX package's rule: v2 on the card, psum on
the CPU, never pallas (``tune.collectives_tier``).
"""
from __future__ import annotations

import contextlib

import torch

from dlaf_tpu_torch import tune
from dlaf_tpu_torch.comm import _ranks
from dlaf_tpu_torch.comm._ranks import spmd  # noqa: F401  (the JAX module's name)
from dlaf_tpu_torch.comm.grid import COL_AXIS, ROW_AXIS


def my_rank():
    """(row, col) coordinates of this rank in the grid."""
    ctx = _ranks.current()
    return ctx.myr, ctx.myc


#: both grid axes, for the collectives over the whole grid (the JAX D&C's
#: ``_BOTH``): one ring of every rank, in flat order ``r * Pc + c``
BOTH = (ROW_AXIS, COL_AXIS)


def axis_size(axis) -> int:
    """Ranks along ``axis`` ('r', 'c' or :data:`BOTH`)."""
    return _ranks.current().axis(axis)[1]


def grid_shape():
    return axis_size(ROW_AXIS), axis_size(COL_AXIS)


def _impl() -> str:
    """The active tier, 'psum' | 'v2' | 'pallas' (a bad knob value raises
    ``ConfigurationError``)."""
    ctx = _ranks.current()
    return tune.collectives_tier(ctx.device if ctx.device is not None else "cpu")


def collectives_trace_key() -> str:
    """The resolved tier (the JAX package keys compiled kernels by it)."""
    return _impl()


@contextlib.contextmanager
def overlap_window():
    """Kept for signature parity: in the JAX package it classifies the
    enclosed collectives' modeled wire bytes as overlapped for ``obs``; the
    port has no ``obs`` yet, so it has no effect."""
    yield


def _expand(mask, x):
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def _forward_chain(y, have, axis: str):
    """Doubling forward chain along ``axis`` (``collectives.py:162``):
    round ``s`` takes the pair of the rank ``s`` positions upstream and
    keeps, per slot, what this rank did not have yet.  After
    ``ceil(log2 P)`` rounds every rank holds every contribution."""
    pos, n, _ = _ranks.current().axis(axis)
    s = 1
    while s < n:
        src = (pos - s) % n
        y_in = _ranks.exchange(axis, y, [src])[src]
        h_in = _ranks.exchange(axis, have, [src])[src]
        take = ~have & h_in
        y = torch.where(_expand(take, y), y_in, y)
        have = have | h_in
        s *= 2
    return y, have


def _psum(x, axis: str):
    """Sum over the ring of ``axis``, in ring order on every rank."""
    _, n, _ = _ranks.current().axis(axis)
    vals = _ranks.exchange(axis, x, list(range(n)))
    out = vals[0].clone()
    for s in range(1, n):
        out += vals[s]
    return out


def bcast(x, root, axis: str, *, consumed: bool = False):
    """Broadcast ``x`` from the rank at position ``root`` of ``axis`` to
    every rank of that axis; the identity on a size-1 axis.  ``consumed``
    only tags the JAX package's comms records and is accepted for
    signature parity."""
    if axis_size(axis) == 1:
        return x
    impl = _impl()
    is_root = _ranks.current().axis(axis)[0] == root
    if impl == "pallas":
        from dlaf_tpu_torch.ops import panel_exchange as px

        return px.ring_bcast(x, is_root, axis)
    if impl == "v2":
        y, _ = _forward_chain(x, torch.full((), is_root, device=x.device), axis)
        return y
    return _psum(x if is_root else torch.zeros_like(x), axis)


def bcast2d(x, root_r, root_c):
    """Broadcast from grid rank (root_r, root_c) to the full grid."""
    return bcast(bcast(x, root_c, COL_AXIS), root_r, ROW_AXIS)


def psum_axis(x, axis):
    """All-reduce along ``axis`` ('r', 'c' or :data:`BOTH`; a
    multi-contributor sum: psum in every tier); the identity on a size-1
    axis."""
    if axis_size(axis) == 1:
        return x
    return _psum(x, axis)


def shift(x, axis: str, offset: int = 1):
    """Ring shift along ``axis``: rank ``i`` receives the value of rank
    ``(i - offset) % P``; a zero net offset is the identity."""
    n = axis_size(axis)
    if offset % n == 0:
        return x
    pos, _, _ = _ranks.current().axis(axis)
    src = (pos - offset) % n
    return _ranks.exchange(axis, x, [src])[src]


def all_gather_axis(x, axis):
    """Gather the local blocks along ``axis`` ('r', 'c' or :data:`BOTH`)
    into a new leading axis of size P, ordered by position (flat rank
    order over :data:`BOTH`); on a size-1 axis that axis is just added."""
    if axis_size(axis) == 1:
        return x[None]
    _, n, _ = _ranks.current().axis(axis)
    vals = _ranks.exchange(axis, x, list(range(n)))
    return torch.stack([vals[s] for s in range(n)])


def _panel_exchange(taken, have, axis: str, kind: str = "exchange"):
    """Shared tail of the ``transpose_panel*`` family: slot ``s`` ends with
    the one contributor's ``taken[s]`` (``have[s]`` set there), or zero
    where no rank of the axis contributes it.  ``kind`` names the ring's
    collective class under the 'pallas' tier (the fused tier's transport is
    ``'consume'``)."""
    if axis_size(axis) == 1:
        return torch.where(_expand(have, taken), taken, torch.zeros_like(taken))
    impl = _impl()
    if impl == "pallas":
        from dlaf_tpu_torch.ops import panel_exchange as px

        y, have_all = px.ring_exchange(taken, have, axis, kind=kind)
        return torch.where(_expand(have_all, y), y, torch.zeros_like(y))
    if impl == "v2":
        y, have_all = _forward_chain(taken, have, axis)
        return torch.where(_expand(have_all, y), y, torch.zeros_like(y))
    return _psum(torch.where(_expand(have, taken), taken, torch.zeros_like(taken)), axis)


def _take(x, idx):
    return x.index_select(0, idx)


def transpose_panel_parts(cp, nr_row_tiles, ltc: int):
    """The (taken, have) pair of :func:`transpose_panel` without the
    exchange."""
    myr, myc = my_rank()
    pr, pc = grid_shape()
    ltr = cp.shape[0]
    jv = torch.arange(ltc, device=cp.device) * pc + myc
    src_slot = torch.clamp(jv // pr, 0, ltr - 1)
    have = (jv % pr == myr) & (jv < nr_row_tiles)
    return _take(cp, src_slot), have


def transpose_panel(cp, nr_row_tiles, ltc: int):
    """Column panel ``cp[ltr, mb, nb]`` -> row panel ``rp[ltc, mb, nb]``
    with ``rp[lj]`` the panel tile of global index ``lj*Pc + myc`` (zero
    where that index is ``>= nr_row_tiles``)."""
    taken, have = transpose_panel_parts(cp, nr_row_tiles, ltc)
    return _panel_exchange(taken, have, ROW_AXIS)


def transpose_panel_windowed_parts(cp, jv, rs, nr_row_tiles):
    myr, _ = my_rank()
    pr, _ = grid_shape()
    L = cp.shape[0]
    src_slot = jv // pr - rs
    have = (jv % pr == myr) & (jv < nr_row_tiles) & (src_slot >= 0) & (src_slot < L)
    return _take(cp, torch.clamp(src_slot, 0, L - 1)), have


def transpose_panel_windowed(cp, jv, rs, nr_row_tiles):
    """Windowed :func:`transpose_panel`: ``cp[L]`` holds the panel tiles of
    local row slots ``rs .. rs+L-1``; returns ``rp[c]`` = panel tile of
    global index ``jv[c]`` (zero where out of range).  ``rs`` may differ
    per rank row."""
    taken, have = transpose_panel_windowed_parts(cp, jv, rs, nr_row_tiles)
    return _panel_exchange(taken, have, ROW_AXIS)


def transpose_panel_rows_windowed_parts(rp, iv, cs, nr_col_tiles):
    _, myc = my_rank()
    _, pc = grid_shape()
    C = rp.shape[0]
    src_slot = iv // pc - cs
    have = (iv % pc == myc) & (iv < nr_col_tiles) & (src_slot >= 0) & (src_slot < C)
    return _take(rp, torch.clamp(src_slot, 0, C - 1)), have


def transpose_panel_rows_windowed(rp, iv, cs, nr_col_tiles):
    """Row panel -> column panel, windowed mirror of
    :func:`transpose_panel_windowed`."""
    taken, have = transpose_panel_rows_windowed_parts(rp, iv, cs, nr_col_tiles)
    return _panel_exchange(taken, have, COL_AXIS)


def transpose_panel_rows(rp, nr_col_tiles, ltr: int):
    """Row panel ``rp[ltc, ...]`` -> column panel ``cp[ltr, ...]`` with
    ``cp[li]`` the panel tile of global index ``li*Pr + myr`` (zero where
    that index is ``>= nr_col_tiles``)."""
    myr, myc = my_rank()
    pr, pc = grid_shape()
    ltc = rp.shape[0]
    iv = torch.arange(ltr, device=rp.device) * pr + myr
    src_slot = torch.clamp(iv // pc, 0, ltc - 1)
    have = (iv % pc == myc) & (iv < nr_col_tiles)
    return _panel_exchange(_take(rp, src_slot), have, COL_AXIS)
