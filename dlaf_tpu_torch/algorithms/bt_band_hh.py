"""Blocked compact-WY band-stage back-transform ``E <- Q2 E`` (counterpart
of ``dlaf_tpu/algorithms/bt_band_hh.py``).

The host chase (``native.band2trid_hh``) emits Householder reflectors
(sweep s, chase step m) with head row ``1 + s + m*b`` and length <= b; Q2
is their product in generation order, applied to E last reflector first.
Groups of ``g`` consecutive sweeps at one chase level form one compact-WY
factor ``I - V T V^H`` over a window of ``w = b + g - 1`` rows, applied as
three products, in the JAX package's order: sweep blocks descending, chase
levels ascending.  ``T^{-1} = diag(1/tau) + triu(V^H V, 1)`` (larft,
forward, columnwise).

E's columns are independent, so on the one rank of a 1x1 grid the whole
padded E is the column panel.  The schedule and the padded factors are
built with array operations (the JAX package assembles them in Python
loops, one reflector at a time); the group loop is eager, three small
products per group.
"""
from __future__ import annotations

import numpy as np
import torch

from dlaf_tpu_torch import tune
from dlaf_tpu_torch.matrix import colpanels as cpan
from dlaf_tpu_torch.matrix import layout
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


def _wy_group_loop(e_pad, V_all, tau_all, offs, w: int, g: int):
    """Apply the grouped compact-WY factors to ``e_pad`` in place."""
    G = V_all.shape[0]
    if G == 0:
        return e_pad
    M = V_all.conj().transpose(1, 2) @ V_all
    eye = torch.eye(g, dtype=V_all.dtype, device=V_all.device)
    tinv = torch.triu(M, 1) + eye[None] / tau_all[:, None, :]
    T_all = torch.linalg.solve_triangular(tinv, eye.expand_as(tinv), upper=True)
    Vh = V_all.conj().transpose(1, 2)
    for i, off in enumerate(offs.tolist()):
        ew = e_pad[off:off + w]
        ew -= V_all[i] @ (T_all[i] @ (Vh[i] @ ew))
    return e_pad


def bt_band_to_tridiagonal_hh_dist(hh, mat_e: DistributedMatrix, group_size: int | None = None,
                                   out_cols: bool = False):
    """E := Q2 E with E a DistributedMatrix (1x1 grid).  ``out_cols=True``
    returns the :class:`ColPanels` carrier for the next row-transform stage
    instead of packing."""
    d, e_, phases, v_refl, taus, band = hh
    grid, dist = mat_e.grid, mat_e.dist
    if grid.size != 1:
        raise NotImplementedError(
            "bt_band_to_tridiagonal_hh_dist on a multi-rank grid is not ported yet "
            "(ROADMAP.md §A, item 3: the HEEV stages on Pr×Pc)")
    n, k = dist.size
    dt = mat_e.dtype
    if dt.is_complex:
        raise NotImplementedError("bt_band_to_tridiagonal_hh_dist: complex dtypes are not ported")
    dev = mat_e.data.device
    has_refl = v_refl.shape[0] > 0 and n > 2 and k > 0 and band > 1
    if not has_refl:
        if not out_cols:
            return mat_e
        g_e = layout.unpad_global(layout.unpack(mat_e.data, dist), dist)
        return cpan.ColPanels(g_e.clone(), n, k, grid, dist)
    group_size = _resolve_group_size(group_size, dev)
    g = max(1, min(group_size, band, n - 2))
    base_s, cols, w = hh_schedule(n, band, g)
    V_all, tau_all = _build_factors(v_refl, taus, base_s, cols, w, g, band, dev, dt)
    n_pad = max(n, w)
    e_glob = layout.unpad_global(layout.unpack(mat_e.data, dist), dist)
    e_pad = torch.nn.functional.pad(e_glob, (0, 0, 0, n_pad - n))
    _wy_group_loop(e_pad, V_all, tau_all, base_s, w, g)
    if out_cols:
        return cpan.ColPanels(e_pad, n, k, grid, dist)
    return mat_e._inplace(cpan.pack_to_matrix(cpan.ColPanels(e_pad, n, k, grid, dist)).data)
