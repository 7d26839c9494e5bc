"""Back-transform of eigenvectors by the reduction-to-band reflectors,
``E <- Q1 E`` with ``Q1 = prod_p (I - V_p T_p V_p^H)`` (counterpart of
``dlaf_tpu/algorithms/bt_reduction_to_band.py``).

Panels in reverse order; per panel the stored reflector strip is gathered
from the band matrix, V rebuilt (unit heads, zero above, tau == 0 columns
dropped), T recomputed (``reduction_to_band._t_factor``, as the reference
recomputes it), and ``E -= V T (V^H E)``.  On the one rank of a 1x1 grid
E is the whole padded column panel; V is zero above the panel's first
eliminated row, so the products run on the rows from there down.  This
stage packs the chain's column panels back to the stacked layout.
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch.algorithms import _spmd
from dlaf_tpu_torch.algorithms.reduction_to_band import _t_factor
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm.grid import COL_AXIS, ROW_AXIS
from dlaf_tpu_torch.matrix import colpanels as cpan
from dlaf_tpu_torch.matrix import layout
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix


def _panel_v_tmat(a, taus, p: int, g_a: _spmd.Geometry, band: int):
    """Panel ``p``'s reflector block ``V[np_, band]`` and its T factor."""
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
    if mat_band.grid.size != 1:
        raise NotImplementedError(
            "bt_reduction_to_band on a multi-rank grid is not ported yet "
            "(ROADMAP.md §A, item 3: the HEEV stages on Pr×Pc)")
    n_panels, band = int(taus.shape[0]), int(taus.shape[1])
    if n_panels == 0 or g_e.nt == 0:
        return cpan.pack_to_matrix(mat_e) if in_cols else mat_e
    np_ = g_a.ltr * g_a.pr * g_a.mb
    if in_cols:
        e = mat_e.data
        n, k = mat_e.n, mat_e.k
    else:
        n, k = dist.size
        e = layout.unpad_global(layout.unpack(mat_e.data, dist), dist)
    # align rows to np_ (V's extent): rows past n are zero and V has no
    # support there, so the slice loses nothing
    r = e.shape[0]
    if r < np_:
        e = torch.nn.functional.pad(e, (0, 0, 0, np_ - r))
    elif r > np_:
        e = e[:np_]
    if not in_cols:
        e = e.contiguous()
    a = coll.local(mat_band.data)
    for s in range(n_panels):
        p = n_panels - 1 - s
        v, tmat = _panel_v_tmat(a, taus, p, g_a, band)
        start = (p + 1) * band
        vs, es = v[start:], e[start:]
        es -= vs @ (tmat @ (vs.conj().transpose(0, 1) @ es))
    out = cpan.pack_to_matrix(cpan.ColPanels(e, n, k, mat_e.grid, dist))
    return out if in_cols else mat_e._inplace(out.data)
