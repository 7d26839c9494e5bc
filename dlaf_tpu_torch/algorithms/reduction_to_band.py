"""Reduction of a Hermitian matrix to band form (counterpart of
``dlaf_tpu/algorithms/reduction_to_band.py``), lower storage.

Per band panel ``p`` (columns ``[p*band, (p+1)*band)``, rows below
``(p+1)*band``): gather the panel strip, factor it with the reference's own
per-column Householder loop (:func:`_hh_panel`, LAPACK geqrf convention,
blocked in sub-panels of at most 32 columns), build the compact-WY factor
``T`` (:func:`_t_factor`; both on rank (0, 0) and broadcast), and apply the
two-sided update
``A := Q^H A Q`` with ``Q = I - V T V^H`` to the trailing window as
``X = A V T``, ``M = V^H X``, ``W2 = X - V T^H M / 2``,
``A -= W2 V^H + V W2^H``.  The window shrinks by segment as in the JAX
package (``_spmd.halving_segments``), so the same slots are touched.

It runs on any ``Pr×Pc`` grid, once per rank (``coll.spmd``, as
``cholesky.py`` runs its kernels): each rank gathers the panel strip over
'r' and broadcasts it over 'c', and updates its own tiles of the window,
the partial products summed over the grid axes (``psum_axis``).  The
reflectors and ``T`` are the same on every rank; the JAX package computes
them redundantly, the port once, on rank (0, 0), and broadcasts them: the
rank threads share one interpreter, and eight of them launching the
per-column loop at once ran past the rank threads' 120 s bound at
N = 8192 on a 2x4 grid of an H100.  Under
``tune.trailing_update_impl='fused'`` the two rank-``band`` updates are
routed as the JAX package routes them (``reduction_to_band.py:209-226``):
the first addend, whose operands are both local, is one B3
(``trailing_update``); the second, whose panel crosses the diagonal, goes
through ``fused_transpose_update`` over ``transpose_panel_windowed_parts``
with no slot suppressed, which is B6 (the consume ring over 'r') for real
dtypes on a card grid with more than one process row, and the transport
plus one update otherwise.  Both run at the ambient ``gemm_precision``
(their split bodies under 'bf16x3' / 'bf16x6').  Under 'xla' they are two
``tile.contract`` calls; on the CPU the two tiers give the same bits.

The JAX package runs the panel loop as one jitted ``fori_loop``; here it is
an eager Python loop with Python-int panel indices.  On return the matrix
holds the band in its lower triangle and the reflector tails below it, and
``taus[n_panels, band]`` (the same on every rank) comes with it.
Checkpointing waits (ROADMAP.md).
"""
from __future__ import annotations

from typing import Tuple

import torch

from dlaf_tpu_torch import tune
from dlaf_tpu_torch.algorithms import _spmd
from dlaf_tpu_torch.algorithms._origin import origin_transparent
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm.grid import COL_AXIS, ROW_AXIS
from dlaf_tpu_torch.matrix import util as mutil
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.ops import tile as t
from dlaf_tpu_torch.ops import trailing_update as _tu


def _panel_block_size(nb: int) -> int:
    """Largest divisor of nb not above 32 (the inner sub-panel width); bands
    whose divisors <= 32 are all tiny take one full-width block."""
    bs = min(32, nb)
    while nb % bs:
        bs -= 1
    return bs if bs >= 8 or bs == nb else nb


def _t_factor(v, taus, nb: int):
    """T = inv(diag(1/tau) + striu(V^H V)); zero-tau columns give zero
    columns (v is zero there).  The solve is ``torch.linalg.solve_triangular``,
    as the JAX package leaves it to XLA."""
    s = torch.triu(v.conj().transpose(0, 1) @ v, 1)
    one = torch.ones((), dtype=taus.dtype, device=taus.device)
    zero_tau = taus == 0
    dinv = torch.where(zero_tau, one, 1.0 / torch.where(zero_tau, one, taus))
    m = s + torch.diag(dinv)
    eye = torch.eye(nb, dtype=v.dtype, device=v.device)
    tmat = torch.linalg.solve_triangular(m, eye, upper=True)
    return torch.where(zero_tau[None, :], torch.zeros((), dtype=v.dtype, device=v.device), tmat)


def _hh_panel(p, start_row: int, nb: int, np_: int, m: int):
    """Householder QR of the gathered panel ``p[np_, nb]`` (updated in
    place); column j's reflector starts at row ``start_row + j``, rows
    ``>= m`` are padding.  The reference's loop (``reduction_to_band.py:67``):
    per column the LAPACK larfg step (``beta = -sign(alpha) * norm``, zero
    columns get ``tau = 0`` and ``v = 0``), then the rank-1 application to
    the rest of the sub-panel; each finished sub-panel of at most 32
    columns is applied to the remaining columns as one compact-WY update.
    Rows above ``start_row`` are never touched, so the loop runs on the
    rows from ``start_row`` down.

    Returns (p, v, taus): ``p`` with R on and above the reflector diagonal
    and the v tails below, ``v[np_, nb]`` with unit heads, ``taus[nb]``."""
    dev, dt = p.device, p.dtype
    bs = _panel_block_size(nb)
    act = p[start_row:]  # a view: the loop writes into p
    m_loc = m - start_row
    v = torch.zeros((np_, nb), dtype=dt, device=dev)
    v_act = v[start_row:]
    taus = torch.zeros(nb, dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    for j0 in range(0, nb, bs):
        sp = act[:, j0:j0 + bs]
        for jj in range(bs):
            s = j0 + jj  # local row of this column's head
            x = sp[:, jj]
            alpha = x[s]
            tail = x[s + 1:m_loc]
            tail_sq = torch.sum(tail.abs() ** 2)
            norm = torch.sqrt(alpha.abs() ** 2 + tail_sq)
            nonzero = norm > 0
            sign = torch.where(alpha.real >= 0, 1.0, -1.0).to(dt)
            beta = -sign * norm.to(dt)
            tau = torch.where(nonzero, (beta - alpha) / beta, zero)
            denom = torch.where(nonzero, alpha - beta, one)
            vj = v_act[:, j0 + jj]
            vj[s + 1:m_loc] = tail / denom
            vj[s] = torch.where(nonzero, one, zero)
            # apply H_j^H to the remaining sub-panel columns:
            # SP -= conj(tau) v (v^H SP), on the rows where v lives
            if jj + 1 < bs:
                rows = slice(s, max(m_loc, s + 1))
                w = vj[rows].conj() @ sp[rows, jj + 1:]
                sp[rows, jj + 1:] -= torch.conj(tau) * torch.outer(vj[rows], w)
            # store the factored column: beta at s, the v tail below
            x[s] = beta
            x[s + 1:m_loc] = vj[s + 1:m_loc]
            taus[j0 + jj] = tau
        if j0 + bs < nb:
            # aggregated block apply of Q_sub^H = I - V T^H V^H to the
            # not-yet-factored panel columns
            v_sub = v_act[:, j0:j0 + bs]
            tsub = _t_factor(v_sub, taus[j0:j0 + bs], bs)
            trail = act[:, j0 + bs:]
            w = v_sub.conj().transpose(0, 1) @ trail
            trail -= v_sub @ (tsub.conj().transpose(0, 1) @ w)
    return p, v, taus


def _red2band_step(x, taus_all, p: int, g: _spmd.Geometry, band: int, myr: int, myc: int,
                   L: int, C: int, fused: bool):
    """One band-panel step on the local tile stack ``x[ltr, ltc, mb, nb]``
    (updated in place): gather -> Householder panel -> T factor -> two-sided
    trailing update on the L x C window -> write-back."""
    dev = x.device
    np_ = g.ltr * g.pr * g.mb  # padded global rows
    mt_pad = np_ // g.mb
    pb = p * band
    kt = pb // g.nb
    co = pb % g.nb
    kc = kt % g.pc
    lkc = kt // g.pc
    # 1. gather the band-wide panel strip to every rank
    xcb = _spmd.take_col(x, lkc, g)[:, :, co:co + band]  # [ltr, mb, band]
    gat = coll.all_gather_axis(xcb, ROW_AXIS)  # [pr, ltr, mb, band]
    col_tiles = gat.permute(1, 0, 2, 3).reshape(mt_pad, g.mb, band)
    pnl = coll.bcast(col_tiles, kc, COL_AXIS).reshape(np_, band).clone()
    start = (p + 1) * band  # first eliminated row
    # 2. the reflectors and the T factor: on rank (0, 0), then broadcast
    # (the module docstring says why)
    if myr == 0 and myc == 0:
        p_out, v, taus = _hh_panel(pnl, start, band, np_, g.m)
        packed = torch.cat([p_out, v, _t_factor(v, taus, band), taus[None, :]])
    else:
        packed = torch.zeros((2 * np_ + band + 1, band), dtype=x.dtype, device=dev)
    packed = coll.bcast2d(packed, 0, 0)
    p_out, v, tmat, taus = packed[:np_], packed[np_:2 * np_], packed[2 * np_:-1], packed[-1]
    taus_all[p] = taus
    # 3. two-sided trailing update on the window: V is zero outside the
    # trailing region, so the clamped window's overlap contributes nothing
    v_tiles = v.reshape(mt_pad, g.mb, band)
    t0 = start // g.mb
    rs = min(max((t0 + g.pr - 1 - myr) // g.pr, 0), max(g.ltr - L, 0))
    cs = min(max((t0 + g.pc - 1 - myc) // g.pc, 0), max(g.ltc - C, 0))
    gi_w = (rs + torch.arange(L, device=dev)) * g.pr + myr
    gj_w = (cs + torch.arange(C, device=dev)) * g.pc + myc
    vr = v_tiles.index_select(0, gi_w)  # [L, mb, band]
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    vc = torch.where((gj_w < mt_pad)[:, None, None],
                     v_tiles.index_select(0, torch.clamp(gj_w, 0, mt_pad - 1)), zero)
    xs = x[rs:rs + L, cs:cs + C]  # a view: the updates land in x
    xfull = coll.psum_axis(t.contract("ijab,jbc->iac", xs, vc), COL_AXIS)  # (A V) window rows
    xt = t.contract("iab,bc->iac", xfull, tmat)  # X = A V T
    mmat = coll.psum_axis(t.contract("iab,iac->bc", vr.conj(), xt), ROW_AXIS)  # M = V^H X
    w2 = xt - 0.5 * t.contract("iab,bc->iac", vr, tmat.conj().transpose(0, 1) @ mmat)
    # mask W2 to the trailing region (element rows >= start)
    ge = gi_w[:, None] * g.mb + torch.arange(g.mb, device=dev)[None, :]
    w2 = torch.where((ge >= start)[:, :, None], w2, zero)
    if fused:
        # first addend: both operands local; the second crosses the
        # diagonal and is consumed from the transposed panel's slots.  The
        # kernel takes a contiguous x, so the window is staged once through
        # a copy (giving the kernel the window's strides instead made it a
        # third slower: 1.40 against 0.92 ms at red2band's shape in
        # chip_smoke.py on an H100 80GB HBM3 at 700 W)
        xw = xs if xs.is_contiguous() else xs.contiguous()
        if _tu.update_kernel_ok(xw.dtype):
            _tu.trailing_update(xw, w2, vc.conj().contiguous())
        else:
            xw -= t.contract("iab,jcb->ijac", w2, vc.conj())
        taken, have = coll.transpose_panel_windowed_parts(w2, gj_w, rs, g.mt)
        _tu.fused_transpose_update(xw, vr, taken, have, torch.zeros_like(have))
        if xw is not xs:
            xs.copy_(xw)
    else:
        w2c = coll.transpose_panel_windowed(w2, gj_w, rs, g.mt)
        xs -= t.contract("iab,jcb->ijac", w2, vc.conj())
        xs -= t.contract("iab,jcb->ijac", vr, w2c.conj())
    # 4. write the factored panel strip back (element rows >= start on the
    # owning tile column; start is generally not tile-aligned)
    if myc == kc:
        p_tiles = p_out.reshape(mt_pad, g.mb, band)
        gi = _spmd.local_row_tiles(g, myr, dev)
        ge_rows = gi[:, None] * g.mb + torch.arange(g.mb, device=dev)[None, :]
        cur = x[:, lkc, :, co:co + band]
        x[:, lkc, :, co:co + band] = torch.where(
            (ge_rows >= start)[:, :, None], p_tiles.index_select(0, gi), cur)


def get_band_size(nb: int, device) -> int:
    """The eigensolver's band: the smallest divisor of nb not below
    ``eigensolver_min_band`` (``reduction_to_band.py:353``); -1 = auto, 33
    on the CPU and 100 on the card (band 128 at nb=512)."""
    b_min = int(tune.get_tune_parameters().eigensolver_min_band)
    if b_min < 0:
        b_min = 100 if tune.on_accelerator(device) else 33
    b_min = max(2, b_min)
    for div in range(nb // b_min, 1, -1):
        if nb % div == 0:
            return nb // div
    return nb


@origin_transparent
def reduction_to_band(mat_a: DistributedMatrix, band: int | None = None,
                      checkpoint_every: int = 0, checkpoint_path: str | None = None,
                      resume_from: str | None = None) -> Tuple[DistributedMatrix, torch.Tensor]:
    """Reduce Hermitian ``mat_a`` (lower storage) to band form with band
    ``band`` (default: the tile size; must divide it).  Returns (matrix
    holding band + reflector tails in the lower triangle, ``taus[n_panels,
    band]``).  ``mat_a`` is not modified: the reduction runs on its
    hermitized copy."""
    if checkpoint_every or checkpoint_path is not None or resume_from is not None:
        raise NotImplementedError(
            "reduction_to_band: checkpointing is not ported yet (ROADMAP.md §A, item 5: the "
            "rest of the eigensolver; it needs item 7: robustness, observability, plan)"
        )
    if mat_a.size.rows != mat_a.size.cols or mat_a.block_size.rows != mat_a.block_size.cols:
        raise ValueError("reduction_to_band: square matrix with square tiles required")
    g = _spmd.Geometry.of(mat_a.dist)
    if band is None:
        band = g.nb
    if band < 1 or g.nb % band:
        raise ValueError(f"reduction_to_band: band {band} must divide the tile size {g.nb}")
    tune.validate_eigensolver_matmul_precision(
        tune.get_tune_parameters().eigensolver_matmul_precision)
    n_panels = max(0, (g.m - 1) // band)
    full = mutil.hermitize(mat_a, "L")
    if n_panels == 0:
        out = mat_a.like(full.data)
        out.band_size = band
        return out, torch.zeros((0, band), dtype=full.dtype, device=full.data.device)
    fused = tune.trailing_update_tier() == "fused"

    def body(x):
        """The panel loop on this rank's tile stack, in place; its taus."""
        myr, myc = coll.my_rank()
        taus_r = torch.zeros((n_panels, band), dtype=x.dtype, device=x.device)
        for p0, p1 in _spmd.halving_segments(n_panels):
            t0 = (p0 + 1) * band // g.mb
            L = max(min(g.ltr, (g.mt - 1 - t0 + g.pr - 1) // g.pr + 1), 1)
            C = max(min(g.ltc, (g.mt - 1 - t0 + g.pc - 1) // g.pc + 1), 1)
            for p in range(p0, p1):
                _red2band_step(x, taus_r, p, g, band, myr, myc, L, C, fused)
        return taus_r

    taus = coll.spmd(full.grid, body, full.data)
    out = mat_a.like(full.data)
    out.band_size = band  # consumed as the default by the band stage
    return out, taus
