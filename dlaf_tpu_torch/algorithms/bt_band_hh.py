"""Blocked compact-WY band-stage back-transform ``E <- Q2 E`` (counterpart
of ``dlaf_tpu/algorithms/bt_band_hh.py``).

The host chase (``native.band2trid_hh``) emits Householder reflectors
(sweep s, chase step m) with head row ``1 + s + m*b`` and length <= b; Q2
is their product in generation order, applied to E last reflector first.
Groups of ``g`` consecutive sweeps at one chase level form one compact-WY
factor ``I - V T V^H`` over a window of ``w = b + g - 1`` rows, applied as
three products, in the JAX package's order: sweep blocks descending, chase
levels ascending.  ``T^{-1} = diag(1/tau) + triu(V^H V, 1)`` (larft,
forward, columnwise).  Groups whose windows are disjoint commute; the port
applies them a dependency level at a time (:func:`group_levels`: every
overlapping pair keeps the JAX package's order), three batched products
a level where the JAX package's loop runs three per group.

E's columns are independent: E is relaid once into the column panels of
the back-transform chain (``matrix/colpanels.py``), and every rank runs
the whole group loop on its own ``kloc`` columns (``coll.spmd``), with
no communication, as each JAX device does.  The schedule and the padded
factors are built once on the device with array operations (the JAX
package assembles them on the host in Python loops, one reflector at a
time, and hands every device a copy), and so is the level schedule; each
rank computes its T factors, as each JAX device does.
"""
from __future__ import annotations

import numpy as np
import torch

from dlaf_tpu_torch import tune
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.matrix import colpanels as cpan
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix


def _resolve_group_size(group_size, device):
    """``tune.bt_band_hh_group_size``; -1 = 32 on the CPU, 128 on the card."""
    if group_size is None:
        group_size = tune.get_tune_parameters().bt_band_hh_group_size
    if group_size < 0:
        group_size = 128 if tune.on_accelerator(device) else 32
    return group_size


def hh_schedule(n: int, b: int, g: int):
    """Group schedule in application order, as arrays.

    Returns ``(base_s[G], cols, w)``: ``base_s`` the first window row of
    each group; ``cols = (grp, ci, row_off, slot)`` one entry per reflector
    (group index, its column in the group's V, its head offset inside the
    window, its slot in the ``[R, b]`` reflector array); ``w = b + g - 1``
    the window height.  The same groups, columns and order as the JAX
    package's ``hh_schedule``."""
    empty = np.zeros(0, np.int64)
    if b <= 1 or n <= 2:
        return empty, (empty, empty, empty, empty), 0
    nsweeps = n - 2  # sweeps s = 0 .. n-3
    counts = (n - 3 - np.arange(nsweeps)) // b + 1
    offs = np.concatenate([[0], np.cumsum(counts)])
    w = b + g - 1
    n_pad = max(n, w)
    first_block = ((nsweeps - 1) // g) * g
    bases, grp, ci, row_off, slot = [], [], [], [], []
    gcount = 0
    for j0 in range(first_block, -1, -g):
        j1 = min(j0 + g, nsweeps)
        m = np.arange((n - 3 - j0) // b + 1)
        base = 1 + j0 + m * b
        base_s = np.minimum(base, n_pad - w)
        delta = base - base_s
        s = np.arange(j0, j1)
        valid = (1 + s[None, :] + m[:, None] * b) <= n - 2  # [M, g]
        mi, si = np.nonzero(valid)
        bases.append(base_s)
        grp.append(gcount + mi)
        ci.append(si)
        row_off.append(delta[mi] + si)
        slot.append(offs[j0 + si] + m[mi])
        gcount += m.shape[0]
    cat = np.concatenate
    return cat(bases), (cat(grp), cat(ci), cat(row_off), cat(slot)), w


def _build_factors(v_refl, taus, base_s, cols, w: int, g: int, b: int, device, dtype):
    """Padded per-group V windows ``[G, w, g]`` and taus ``[G, g]`` on the
    device; padding columns keep ``v = 0, tau = 1`` (an identity factor),
    as do reflectors whose tau is 0."""
    grp, ci, row_off, slot = cols
    G = base_s.shape[0]
    t = torch.from_numpy(np.ascontiguousarray(taus)).to(device=device, dtype=dtype)
    vr = torch.from_numpy(np.ascontiguousarray(v_refl)).to(device=device, dtype=dtype)
    grp_t = torch.from_numpy(grp).to(device)
    ci_t = torch.from_numpy(ci).to(device)
    ro_t = torch.from_numpy(row_off).to(device)
    sl_t = torch.from_numpy(slot).to(device)
    tau_c = t[sl_t]
    live = tau_c != 0
    tau_all = torch.ones((G, g), dtype=dtype, device=device)
    tau_all[grp_t[live], ci_t[live]] = tau_c[live]
    V_all = torch.zeros((G, w, g), dtype=dtype, device=device)
    r = torch.arange(b, device=device)
    rows = ro_t[:, None] + r[None, :]  # [ncols, b]
    ok = live[:, None] & (rows < w)
    gi = grp_t[:, None].expand_as(rows)
    cj = ci_t[:, None].expand_as(rows)
    V_all[gi[ok], rows[ok], cj[ok]] = vr[sl_t][:, :b][ok]
    return V_all, tau_all


def group_levels(base_s, w: int):
    """Each group's level in the application order: one more than the
    highest level of an earlier group whose window of ``w`` rows overlaps
    its own (0 if none).  Groups of one level touch disjoint rows, so they
    commute, and applying the levels in turn applies every overlapping
    pair in the schedule's order: the same product, one batched update a
    level.  At N = 8192, band 32 and groups of 32: 765 levels for 32,896
    groups."""
    last = [0] * (int(base_s.max()) + w if len(base_s) else 0)
    levels = np.empty(len(base_s), np.int64)
    for i, b0 in enumerate(base_s.tolist()):
        lv = max(last[b0:b0 + w])
        levels[i] = lv
        last[b0:b0 + w] = [lv + 1] * w
    return levels


def level_schedule(V_all, tau_all, base_s, w: int):
    """The factors in level order (:func:`group_levels`, stable), the rows
    of their windows ``rows[G * w]`` on the factors' device, and the bounds
    of each level's run of groups."""
    levels = group_levels(base_s, w)
    order = np.argsort(levels, kind="stable")
    bounds = np.searchsorted(levels[order], np.arange(int(levels.max()) + 2)).tolist()
    dev = V_all.device
    perm = torch.from_numpy(order).to(dev)
    rows = (torch.from_numpy(base_s[order]).to(dev)[:, None]
            + torch.arange(w, device=dev)[None, :]).reshape(-1)
    return V_all.index_select(0, perm), tau_all.index_select(0, perm), rows, bounds


def _wy_group_loop(e_pad, V, tau, rows, bounds, w: int, g: int):
    """Apply the grouped compact-WY factors of :func:`level_schedule` to
    ``e_pad`` in place, one level at a time: the level's windows are
    gathered, updated by three batched products and scattered back.
    ``T^{-1} = diag(1/tau) + triu(V^H V, 1)`` (larft forward/columnwise)."""
    if V.shape[0] == 0:
        return e_pad
    M = V.conj().transpose(1, 2) @ V
    eye = torch.eye(g, dtype=V.dtype, device=V.device)
    tinv = torch.triu(M, 1) + eye[None] / tau[:, None, :]
    T = torch.linalg.solve_triangular(tinv, eye.expand_as(tinv), upper=True)
    Vh = V.conj().transpose(1, 2)
    k = e_pad.shape[1]
    for a, b in zip(bounds[:-1], bounds[1:]):
        idx = rows[a * w:b * w]
        ew = e_pad.index_select(0, idx).view(b - a, w, k)
        ew -= V[a:b] @ (T[a:b] @ (Vh[a:b] @ ew))
        e_pad.index_copy_(0, idx, ew.view(-1, k))
    return e_pad


def bt_band_to_tridiagonal_hh_dist(hh, mat_e: DistributedMatrix, group_size: int | None = None,
                                   out_cols: bool = False):
    """E := Q2 E with E a DistributedMatrix on any grid.  ``out_cols=True``
    returns the :class:`ColPanels` carrier for the next row-transform stage
    instead of packing."""
    d, e_, phases, v_refl, taus, band = hh
    grid, dist = mat_e.grid, mat_e.dist
    n, k = dist.size
    dt = mat_e.dtype
    if dt.is_complex:
        raise NotImplementedError("bt_band_to_tridiagonal_hh_dist: complex dtypes are not ported")
    dev = mat_e.data.device
    has_refl = v_refl.shape[0] > 0 and n > 2 and k > 0 and band > 1
    if not has_refl:
        return cpan.from_matrix(mat_e, n) if out_cols else mat_e
    group_size = _resolve_group_size(group_size, dev)
    g = max(1, min(group_size, band, n - 2))
    base_s, cols, w = hh_schedule(n, band, g)
    V, tau, rows, bounds = level_schedule(
        *_build_factors(v_refl, taus, base_s, cols, w, g, band, dev, dt), base_s, w)
    cp = cpan.from_matrix(mat_e, max(n, w))
    coll.spmd(grid, lambda e: _wy_group_loop(e, V, tau, rows, bounds, w, g), cp.data)
    if out_cols:
        return cp
    return mat_e._inplace(cpan.pack_to_matrix(cp).data)
