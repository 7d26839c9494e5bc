"""Back-transform of eigenvectors by the reduction-to-band reflectors,
``E <- Q1 E`` with ``Q1 = prod_p (I - V_p T_p V_p^H)`` (counterpart of
``dlaf_tpu/algorithms/bt_reduction_to_band.py``).

Panels in reverse order, once per rank (``coll.spmd``); per panel every
rank rebuilds the same V from the stored reflector strip (gathered over
'r' from the band matrix's tiles, broadcast over 'c' from the tile
column that holds it: B5 under the 'pallas' collectives tier), unit heads,
zero above, tau == 0 columns dropped, recomputes T
(``reduction_to_band._t_factor``, as the reference recomputes it) and
applies ``E -= V T (V^H E)`` to its share of E:

- the column panels of the back-transform chain (:class:`ColPanels`):
  every rank holds all rows of its columns, so the update is three local
  products; V is zero above the panel's first eliminated row, so they run
  on the rows from there down.  This entry packs the chain's panels back
  to the stacked layout;
- a stacked matrix: each rank holds its tiles of E, and ``V^H E`` is
  summed over 'r'.
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch.algorithms import _spmd
from dlaf_tpu_torch.algorithms.reduction_to_band import _t_factor
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm.grid import COL_AXIS, ROW_AXIS
from dlaf_tpu_torch.matrix import colpanels as cpan
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.ops import tile as t


def _panel_v_tmat(a, taus, p: int, g_a: _spmd.Geometry, band: int):
    """Panel ``p``'s reflector block ``V[np_, band]`` and its T factor, the
    same on every rank, from this rank's band tile stack ``a``."""
    np_ = g_a.ltr * g_a.pr * g_a.mb
    dev = a.device
    rows = torch.arange(np_, device=dev)
    pb = p * band
    kt = pb // g_a.nb
    co = pb % g_a.nb
    kc = kt % g_a.pc
    lkc = kt // g_a.pc
    xcb = _spmd.take_col(a, lkc, g_a)[:, :, co:co + band]
    gat = coll.all_gather_axis(xcb, ROW_AXIS)
    col = gat.permute(1, 0, 2, 3).reshape(np_ // g_a.mb, g_a.mb, band)
    col = coll.bcast(col, kc, COL_AXIS).reshape(np_, band)
    start = (p + 1) * band
    j_idx = torch.arange(band, device=dev)[None, :]
    head = rows[:, None] == start + j_idx
    below = rows[:, None] > start + j_idx
    zero = torch.zeros((), dtype=col.dtype, device=dev)
    one = torch.ones((), dtype=col.dtype, device=dev)
    v = torch.where(head, one, torch.where(below, col, zero))
    tau_k = taus[p]
    v = torch.where((tau_k == 0)[None, :], zero, v)
    return v, _t_factor(v, tau_k, band)


def bt_reduction_to_band(mat_e, mat_band: DistributedMatrix, taus: torch.Tensor) -> DistributedMatrix:
    """E := Q1 E, Q1 the accumulated ``reduction_to_band`` transformation
    stored in ``mat_band`` (reflector tails below the band) and ``taus``.
    ``mat_e`` is a stacked DistributedMatrix or the :class:`ColPanels` of
    the back-transform chain; returns a stacked DistributedMatrix."""
    in_cols = isinstance(mat_e, cpan.ColPanels)
    dist = mat_e.dist
    g_a = _spmd.Geometry.of(mat_band.dist)
    g_e = _spmd.Geometry.of(dist)
    if g_a.mb != g_e.mb or g_a.pr != g_e.pr or g_a.mt != g_e.mt:
        raise ValueError("bt_reduction_to_band: E row distribution must match A")
    n_panels, band = int(taus.shape[0]), int(taus.shape[1])
    if n_panels == 0 or g_e.nt == 0:
        return cpan.pack_to_matrix(mat_e) if in_cols else mat_e
    np_ = g_a.ltr * g_a.pr * g_a.mb
    if not in_cols:
        def stacked(a, e):
            """This rank's tiles of E; W = V^H E summed over 'r'."""
            gi = _spmd.local_row_tiles(g_a, coll.my_rank()[0], a.device)
            for s in range(n_panels):
                p = n_panels - 1 - s
                v, tmat = _panel_v_tmat(a, taus, p, g_a, band)
                vr = v.reshape(np_ // g_a.mb, g_a.mb, band).index_select(0, gi)
                w = coll.psum_axis(t.contract("iab,ijac->jbc", vr.conj(), e), ROW_AXIS)
                e -= t.contract("iab,jbc->ijac", vr, t.contract("ab,jbc->jac", tmat, w))

        coll.spmd(mat_e.grid, stacked, mat_band.data, mat_e.data)
        return mat_e._inplace(mat_e.data)

    # align rows to np_ (V's extent): rows past n are zero and V has no
    # support there, so the slice loses nothing
    data = mat_e.data
    if data.shape[2] < np_:
        data = torch.nn.functional.pad(data, (0, 0, 0, np_ - data.shape[2]))
    elif data.shape[2] > np_:
        data = data[:, :, :np_].contiguous()

    def cols(a, e):
        """This rank's column panel, every row of it: three local products."""
        for s in range(n_panels):
            p = n_panels - 1 - s
            v, tmat = _panel_v_tmat(a, taus, p, g_a, band)
            start = (p + 1) * band
            vs, es = v[start:], e[start:]
            es -= t.contract("ab,bc->ac", vs, tmat @ t.contract("ka,kb->ab", vs.conj(), es))

    coll.spmd(mat_e.grid, cols, mat_band.data, data)
    return cpan.pack_to_matrix(cpan.ColPanels(data, mat_e.n, mat_e.k, mat_e.grid, dist))
