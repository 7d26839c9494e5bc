"""Grid collectives with the size-1-axis semantics (counterpart of
``dlaf_tpu/comm/collectives.py``).

On the 1x1 grid, the only grid this slice runs, every collective degenerates
to the local gathers below: a broadcast is the identity and a panel
redistribution is a masked gather within the one rank.  They are written
with the JAX package's general slot arithmetic (``pr``/``pc``/``myr``/
``myc``), so each output matches the JAX function slot for slot.  A call
over an axis of size > 1 raises ``NotImplementedError``: the
``torch.distributed`` transports are the next slice (ROADMAP.md, queue A
item 3).
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch.comm.grid import COL_AXIS, ROW_AXIS


def my_rank():
    """(row, col) coordinates of this rank in the grid."""
    return 0, 0


def axis_size(axis: str) -> int:
    if axis not in (ROW_AXIS, COL_AXIS):
        raise ValueError(f"unknown grid axis {axis!r}")
    return 1


def grid_shape():
    return axis_size(ROW_AXIS), axis_size(COL_AXIS)


def _multi_rank(what: str, axis: str):
    raise NotImplementedError(
        f"{what} over a grid axis {axis!r} of size > 1 waits for the "
        "torch.distributed slice (ROADMAP.md, queue A item 3)"
    )


def bcast(x, root, axis: str, *, consumed: bool = False):
    """Broadcast ``x`` from the rank ``root`` along ``axis``; the identity
    on a size-1 axis.  ``consumed`` only tags the JAX package's comms
    records and is accepted for signature parity."""
    if axis_size(axis) == 1:
        return x
    _multi_rank("bcast", axis)


def bcast2d(x, root_r, root_c):
    """Broadcast from grid rank (root_r, root_c) to the full grid."""
    return bcast(bcast(x, root_c, COL_AXIS), root_r, ROW_AXIS)


def psum_axis(x, axis: str):
    """All-reduce along ``axis``; the identity on a size-1 axis."""
    if axis_size(axis) == 1:
        return x
    _multi_rank("psum_axis", axis)


def all_gather_axis(x, axis: str):
    """Gather the local blocks along ``axis`` into a new leading axis of
    size P; on a size-1 axis that axis is just added."""
    if axis_size(axis) == 1:
        return x[None]
    _multi_rank("all_gather_axis", axis)


def _expand(mask, x):
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def _panel_exchange(taken, have, axis: str):
    """Shared tail of the ``transpose_panel*`` family: slot ``s`` keeps
    ``taken[s]`` where this rank contributes it and is zero elsewhere."""
    if axis_size(axis) == 1:
        return torch.where(_expand(have, taken), taken, torch.zeros_like(taken))
    _multi_rank("panel exchange", axis)


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
    global index ``jv[c]`` (zero where out of range)."""
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


def local(x):
    """Strip the two size-1 leading grid axes of a stacked tensor."""
    return x.reshape(x.shape[2:])


def relocal(x):
    """Restore the two size-1 leading grid axes (inverse of :func:`local`)."""
    return x.reshape((1, 1) + tuple(x.shape))
