"""Multi-level Cuppen divide & conquer for the symmetric tridiagonal
eigenproblem (counterpart of ``dlaf_tpu/algorithms/tridiag_dc_dist.py``).

The JAX package re-expresses every merge step in closed form so that one
merge level is a constant number of SPMD calls over the grid; the port
keeps those closed forms and the SPMD structure, and runs the whole solve
as one :func:`~dlaf_tpu_torch.comm.collectives.spmd` call, each rank
computing what its JAX device computes:

* leaves (:func:`_leaves`): rank ``f = r * Pc + c`` solves leaves
  ``f * nloc .. f * nloc + nloc - 1`` by a batched ``torch.linalg.eigh``
  of the tile-aligned diagonal blocks (XLA ``eigh`` in the JAX package),
  in float64; the eigenvalues are summed over the grid, the eigenvectors
  all-gathered one leaf slot a round and placed into each rank's tiles;
* per level, :func:`_params_kernel`: the rank-one vector z from each
  rank's boundary rows, summed over the grid; a stable per-block sort,
  deflation (closed-form rotation chain: the run-local prefix norms come
  from a true segmented scan, never from a difference of global
  cumulative sums, which cancels on clustered spectra), all replicated;
  the secular solve by bisection on the rank's ``RPD = ceil(n_pad / P)``
  roots (the hand-written kernel of ``ops/secular.py`` for f32 on the
  card, the plain loop for CPU tensors and f64), the anchor refinement,
  the Loewner z recomputation in log space and the column norms of the
  eigenvector basis U on the same share, each all-gathered over the grid;
* :func:`_level_kernel`: ``Q <- Q (P G) U`` as block-diagonal-restricted
  SUMMA passes whose right operands are generated tile by tile from those
  vectors; each contraction tile's panel is summed over 'c' on every rank
  (``torch.einsum`` for the products, as the JAX package leaves them to
  XLA).

All subproblem sizes are powers of two times the leaf; padding poles are
decoupled, above every true eigenvalue, and deflate to identity columns.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dlaf_tpu_torch import tune
from dlaf_tpu_torch.algorithms import _spmd
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm.grid import COL_AXIS, Grid
from dlaf_tpu_torch.matrix.distribution import Distribution
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.ops import secular as _secular


def _plan(n: int, nb: int, leaf_target: int):
    """Leaf size s0 (a multiple of nb), level count L, padded size n_pad
    with n_pad = s0 * 2^L >= n."""
    leaf_target = max(nb, leaf_target)
    nleaf_t = max(1, -(-n // leaf_target))
    L = max(0, (nleaf_t - 1).bit_length())
    s0 = -(-n // ((1 << L) * nb)) * nb
    return s0, L, s0 << L


def _leaves(d_mod, e_pad, x, g: _spmd.Geometry, s0: int, nloc: int):
    """Rank body of the leaf stage (``tridiag_dc_dist.py:94``): this rank's
    ``nloc`` leaves are solved, every leaf's eigenvectors are placed into
    this rank's zeroed tile stack ``x[ltr, ltc, nb, nb]``, and the leaf
    eigenvalues ``lam[n_pad]`` (the same on every rank) are returned."""
    myr, myc = coll.my_rank()
    nranks = g.pr * g.pc
    n_pad = d_mod.shape[0]
    nleaf = n_pad // s0
    dev, dt = d_mod.device, d_mod.dtype
    b = (myr * g.pc + myc) * nloc + torch.arange(nloc, device=dev)
    bs = torch.clamp(b, max=nleaf - 1)
    valid = b < nleaf
    dl = d_mod.reshape(nleaf, s0)[bs]
    el = e_pad.reshape(nleaf, s0)[bs, : s0 - 1]
    # solved in float64 and rounded to the working dtype: on the H100,
    # cuSOLVER's float32 eigh leaves residuals of about 1.5e-4 on path H's
    # 512-leaves, LAPACK's float32 eigh about 2.7e-6
    # (scripts/leaf_eigh_accuracy.py)
    tris = torch.diag_embed(dl) + torch.diag_embed(el, 1) + torch.diag_embed(el, -1)
    lam_l, q = torch.linalg.eigh(tris.to(torch.float64))
    lam_l, q = lam_l.to(dt), q.to(dt)
    buf = torch.zeros((nleaf, s0), dtype=dt, device=dev)
    buf[b[valid]] = lam_l[valid]
    lam = coll.psum_axis(buf.reshape(-1), coll.BOTH)
    t0t = s0 // g.nb
    for lb in range(nloc):
        qg = coll.all_gather_axis(q[lb], coll.BOTH)  # [P, s0, s0]
        for f in range(nranks):
            b2 = f * nloc + lb
            if b2 >= nleaf:
                continue
            lo = b2 * t0t  # the leaf block's first tile row and column
            rows = [li for li in range(g.ltr) if lo <= li * g.pr + myr < lo + t0t]
            cols = [lj for lj in range(g.ltc) if lo <= lj * g.pc + myc < lo + t0t]
            if not rows or not cols:
                continue
            qt = qg[f].reshape(t0t, g.nb, t0t, g.nb).permute(0, 2, 1, 3)
            qt = qt[rows[0] * g.pr + myr - lo::g.pr][:len(rows)]
            x[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1] = \
                qt[:, cols[0] * g.pc + myc - lo::g.pc][:, :len(cols)]
    return lam


def _shift_left(v, fill):
    """v[:, 1:] followed by a column of ``fill``."""
    return torch.cat([v[:, 1:], torch.full_like(v[:, :1], fill)], 1)


def _shift_right(v, fill):
    """A column of ``fill`` followed by v[:, :-1]."""
    return torch.cat([torch.full_like(v[:, :1], fill), v[:, :-1]], 1)


def _segmented_sum(vals, starts):
    """Inclusive prefix sums along dim 1 that restart at every ``starts``
    position: the JAX package's ``lax.associative_scan`` with
    ``(xa, fa) . (xb, fb) = (fb ? xb : xa + xb, fa | fb)``, as a log-step
    (Hillis-Steele) scan over the row."""
    v, f = vals, starts
    off = 1
    S = v.shape[1]
    while off < S:
        v_new = v.clone()
        v_new[:, off:] = torch.where(f[:, off:], v[:, off:], v[:, :-off] + v[:, off:])
        f_new = f.clone()
        f_new[:, off:] = f[:, off:] | f[:, :-off]
        v, f = v_new, f_new
        off *= 2
    return v


def _params_kernel(x, lam_prev, beta, *, g: _spmd.Geometry, S: int, B: int, n_pad: int,
                   RPD: int, iters: int):
    """Merge parameters of one level on this rank's tile stack ``x``
    (``tridiag_dc_dist.py:160``): this rank solves the secular equations
    of roots ``f * RPD .. f * RPD + RPD - 1``.  Returns the 16 arrays the
    JAX kernel returns, in its order, the same on every rank."""
    dev, dt = x.device, x.dtype
    myr, myc = coll.my_rank()
    i64 = torch.int64
    s_half = S // 2
    tiny = torch.finfo(dt).tiny
    eps = torch.finfo(dt).eps
    tol = 8.0 * eps
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)

    # --- z extraction: z[j] = Q[r1(blk), j] + sgn * Q[r1(blk) + 1, j], each
    # rank's columns from the boundary rows it holds, summed over the grid
    ge_col = (torch.arange(g.ltc, device=dev)[:, None] * g.pc + myc) * g.nb \
        + torch.arange(g.nb, device=dev)[None, :]  # [ltc, nb] global columns
    blk_col = torch.clamp(ge_col // S, max=B - 1)
    r1 = blk_col * S + (s_half - 1)
    sgn = torch.sign(torch.where(beta == 0, torch.ones_like(beta), beta))
    lj = torch.arange(g.ltc, device=dev)[:, None]
    cj = torch.arange(g.nb, device=dev)[None, :]

    def boundary_row(r):
        ti = r // g.nb
        mine = (ti % g.pr == myr) & (ti // g.pr < g.ltr)
        v = x[torch.clamp(ti // g.pr, max=g.ltr - 1), lj, r % g.nb, cj]
        return torch.where(mine, v, zero)

    zpart = boundary_row(r1) + sgn[blk_col] * boundary_row(r1 + 1)
    live = ge_col < n_pad
    z = torch.zeros(n_pad, dtype=dt, device=dev).index_add_(0, ge_col[live], zpart[live])
    z = coll.psum_axis(z, coll.BOTH)

    # --- per-block sort + deflation (closed form, [B, S])
    d_blk = lam_prev.reshape(B, S)
    z_blk = z.reshape(B, S)
    ord1 = torch.argsort(d_blk, dim=1, stable=True)
    io = torch.argsort(ord1, dim=1, stable=True)  # inverse permutation
    ds = torch.gather(d_blk, 1, ord1)
    zs = torch.gather(z_blk, 1, ord1)
    rho = beta.abs()  # [B]
    zn2 = torch.sum(zs * zs, dim=1)
    keep0 = zs.abs() * torch.sqrt(rho)[:, None] > tol * torch.sqrt(zn2 + tiny)[:, None]
    # norm-relative spread (LAPACK dlaed2's scaling-invariant tolerance)
    span = torch.amax(ds.abs(), dim=1) + rho * zn2
    tol_gap = (tol * span)[:, None]
    close = torch.cat([(ds[:, 1:] - ds[:, :-1] < tol_gap) & keep0[:, :-1] & keep0[:, 1:],
                       torch.zeros((B, 1), dtype=torch.bool, device=dev)], 1)
    idx = torch.arange(S, device=dev)[None, :].expand(B, S)
    break_before = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev), ~close[:, :-1]], 1)
    sid = torch.cummax(torch.where(break_before, idx, 0), dim=1).values
    z2m = torch.where(keep0, zs * zs, zero)
    # run-local prefix norms: a segmented scan that restarts at run starts
    pn2 = _segmented_sum(z2m, break_before)
    pn = torch.sqrt(torch.clamp(pn2, min=0.0))
    rsafe = torch.clamp(_shift_left(pn, 1.0), min=tiny)
    carr = torch.where(close, _shift_left(zs, 0.0) / rsafe, one)
    run_start = sid == idx
    pn_signed = torch.where(run_start, torch.where(keep0, zs, zero), pn)
    sarr = torch.where(close, pn_signed / rsafe, zero)
    run_end = _shift_right(close, False)
    zpost = torch.where(close, zero, torch.where(run_end, pn, torch.where(keep0, zs, zero)))
    keep = keep0 & ~close
    # exclusive prefix arrays for the G products prod_{l=r..j-1} s_l
    logs = torch.where(close, torch.log(torch.clamp(sarr.abs(), min=tiny)), zero)
    Cx = _shift_right(torch.cumsum(logs, 1), 0.0)
    Zx = _shift_right(torch.cumsum((~close).to(i64), 1), 0)
    NCx = _shift_right(torch.cumsum((close & (sarr < 0)).to(i64), 1), 0)
    has_rot = torch.any(close)

    # --- secular solve of this rank's RPD roots
    ds_flat = ds.reshape(-1)
    keep_flat = keep.reshape(-1)
    z2_flat = torch.where(keep, zpost * zpost, zero).reshape(-1)
    flat = myr * g.pc + myc
    pos = torch.clamp(flat * RPD + torch.arange(RPD, device=dev), max=n_pad - 1)
    bq = pos // S
    win = bq[:, None] * S + torch.arange(S, device=dev)[None, :]  # [RPD, S]
    dw = ds_flat[win]
    z2w = z2_flat[win]
    rho_q = rho[bq]
    # next active pole / per-block upper bound
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    maskedd = torch.where(keep, ds, inf)
    rev = torch.flip(torch.cummin(torch.flip(maskedd, [1]), dim=1).values, [1])
    nxt = _shift_left(rev, float("inf"))
    any_keep = torch.any(keep, dim=1)
    # strict upper root bracket, norm-relative slack
    eps4 = 4.0 * eps
    upper_b = torch.where(
        any_keep,
        torch.amax(torch.where(keep, ds, -inf), dim=1) + rho * zn2 * (1.0 + eps4) + eps4 * span + tiny,
        zero,
    )
    d_next = torch.where(torch.isfinite(nxt), nxt, upper_b[:, None])
    gap = d_next - ds
    d_q = ds_flat[pos]
    d_next_q = d_next.reshape(-1)[pos]
    gap_q = gap.reshape(-1)[pos]

    # f32 always goes through the kernel's wrapper (the kernel on the card,
    # the plain loop only for CPU tensors); f64 takes the plain loop, as
    # the JAX package's gate (tridiag_dc_dist.py:283-285)
    use_kernel = dt == torch.float32

    def bisect(anchor_vec, lo0, hi0):
        if use_kernel:
            return _secular.secular_bisect(dw, z2w, rho_q.contiguous(), anchor_vec.contiguous(),
                                           lo0.contiguous(), hi0.contiguous(), iters)
        return _secular.secular_bisect_plain(dw, z2w, rho_q, anchor_vec, lo0, hi0, iters)

    mu = bisect(d_q, torch.zeros_like(d_q), gap_q)
    nu = bisect(d_next_q, -gap_q, torch.zeros_like(d_q))
    use_r = nu.abs() < mu.abs()
    anchor_q = torch.where(use_r, d_next_q, d_q)
    kq = keep_flat[pos]
    off_q = torch.where(kq, torch.where(use_r, nu, mu), zero)

    # fixed-point refinement of the anchor pole's own term (laed4's relative
    # accuracy near poles): off = rho z_a^2 / (1 + R)
    idx_flat = torch.arange(S, device=dev)[None, :].expand(B, S)
    big_i = S
    midx = torch.where(keep, idx_flat, big_i)
    rev_i = torch.flip(torch.cummin(torch.flip(midx, [1]), dim=1).values, [1])
    nxt_i = _shift_left(rev_i, big_i)
    na_loc = torch.clamp(nxt_i.reshape(-1)[pos], 0, S - 1)  # next active local index
    a_idx = torch.where(use_r, bq * S + na_loc, pos)
    z2a = z2_flat[a_idx]
    lo_g = torch.where(use_r, -gap_q, torch.zeros_like(gap_q))
    hi_g = torch.where(use_r, torch.zeros_like(gap_q), gap_q)
    ag_r = dw - anchor_q[:, None]
    own_sel = win == a_idx[:, None]
    # only roots at or below the bisection resolution floor need (and
    # safely admit) the fixed point
    floor = gap_q * (2.0 ** (-(iters - 6)))
    for _ in range(3):
        diff = ag_r - off_q[:, None]
        safe = torch.where(diff == 0, tiny, diff)
        rest = rho_q * torch.sum(torch.where(own_sel, zero, z2w / safe), dim=1)
        denom = 1.0 + rest
        cand = rho_q * z2a / torch.where(denom == 0, tiny, denom)
        near_pole = (off_q.abs() <= floor) | (cand.abs() <= floor)
        good = torch.isfinite(cand) & (cand > lo_g) & (cand < hi_g) & near_pole
        off_q = torch.where(good, cand, off_q)
    off_q = torch.where(kq, off_q, zero)
    lam_q = torch.where(kq, anchor_q + off_q, d_q)

    def gather_flat(v):
        """Every rank's share, in flat rank order: the whole vector."""
        return coll.all_gather_axis(v, coll.BOTH).reshape(-1)[:n_pad]

    anchor, off, lam = gather_flat(anchor_q), gather_flat(off_q), gather_flat(lam_q)

    # --- zhat via the Loewner formula in log space
    aw = anchor[win]
    ow = off[win]
    kw = keep_flat[win]
    numw = (aw - d_q[:, None]) + ow
    denw = dw - d_q[:, None]
    act = kw & kq[:, None] & (win != pos[:, None])
    logratio = torch.where(
        act,
        torch.log(torch.clamp(numw.abs(), min=tiny)) - torch.log(torch.clamp(denw.abs(), min=tiny)),
        zero,
    )
    own_q = (anchor - ds_flat)[pos] + off[pos]
    lzh2 = (torch.log(torch.clamp(own_q, min=tiny)) - torch.log(torch.clamp(rho_q, min=tiny))
            + torch.sum(logratio, dim=1))
    zpost_flat = zpost.reshape(-1)
    sgn_z = torch.where(zpost_flat[pos] < 0, -one, one)
    zhat = gather_flat(torch.where(kq, sgn_z * torch.exp(0.5 * lzh2), zero))

    # --- column norms of U
    zh2w = (zhat * zhat)[win]
    numw2 = (anchor[pos][:, None] - dw) + off[pos][:, None]
    safe2 = torch.where(numw2 == 0, tiny, numw2)
    nsum = torch.sum(torch.where(kw, zh2w / (safe2 * safe2), zero), dim=1)
    norms = gather_flat(torch.where(kq & (nsum > 0), torch.sqrt(nsum), one))

    # --- final per-block ordering
    lam_blk = lam.reshape(B, S)
    ord2 = torch.argsort(lam_blk, dim=1, stable=True)
    lam_sorted = torch.gather(lam_blk, 1, ord2).reshape(-1)
    return (lam_sorted, ds_flat, zhat, anchor, off, norms, keep_flat, ord2.reshape(-1),
            io.reshape(-1), carr.reshape(-1), sarr.reshape(-1), close.reshape(-1),
            Cx.reshape(-1), Zx.reshape(-1), NCx.reshape(-1), has_rot)


def _u_tile(k: int, b: int, gj_w, cmask, prm, *, g: _spmd.Geometry, S: int, n_pad: int,
            row_remap: bool):
    """Generated operand tiles W[Lw, nb, nb]: the secular eigenvector basis
    U with final-order columns; ``row_remap`` folds the sort permutation
    into the row index (levels without rotations)."""
    ds, zhat, anchor, off, norms, keep, ord2, io = prm
    dt = ds.dtype
    tiny = torch.finfo(dt).tiny
    nb = g.nb
    dev = ds.device
    gi_el = k * nb + torch.arange(nb, device=dev)  # global contraction elements
    j_loc = io[gi_el] if row_remap else gi_el - b * S
    j_glob = b * S + j_loc
    zh_j = zhat[j_glob]
    d_j = ds[j_glob]
    q_el = gj_w[:, None] * nb + torch.arange(nb, device=dev)[None, :]  # [Lw, nb]
    q_cl = torch.clamp(q_el, 0, n_pad - 1)
    t_loc = ord2[q_cl]
    t_glob = torch.clamp(b * S + t_loc, 0, n_pad - 1)
    an_t = anchor[t_glob]
    of_t = off[t_glob]
    no_t = norms[t_glob]
    kp_t = keep[t_glob]
    num = (an_t[:, None, :] - d_j[None, :, None]) + of_t[:, None, :]
    safe = torch.where(num == 0, tiny, num)
    ukeep = -zh_j[None, :, None] / safe / no_t[:, None, :]
    ident = (j_loc[None, :, None] == t_loc[:, None, :]).to(dt)
    w = torch.where(kp_t[:, None, :], ukeep, ident)
    return torch.where(cmask[:, None, None], w, torch.zeros((), dtype=dt, device=dev))


def _pg_tile(k: int, b: int, gj_w, cmask, prm, *, g: _spmd.Geometry, S: int, n_pad: int):
    """Generated operand tiles (P G)[Lw, nb, nb]: the accumulated deflation
    rotations with the sort permutation folded into the rows,
    ``(P G)[i, j] = G[io[i], j]``, ``G[r, j] = c^_j c_{r-1} prod_{l=r..j-1}
    s_l`` for r <= j and ``-s_j`` for r = j + 1."""
    io, carr, sarr, close, Cx, Zx, NCx = prm
    dt = carr.dtype
    dev = carr.device
    nb = g.nb
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    gi_el = k * nb + torch.arange(nb, device=dev)
    r_loc = io[gi_el]  # sorted row index (local)
    r_glob = b * S + r_loc
    q_el = gj_w[:, None] * nb + torch.arange(nb, device=dev)[None, :]  # [Lw, nb]
    q_cl = torch.clamp(q_el, 0, n_pad - 1)
    jc_cl = torch.clamp(q_cl - b * S, 0, S - 1)  # sorted col index (local)
    j_glob = torch.clamp(b * S + jc_cl, 0, n_pad - 1)
    last = jc_cl == S - 1
    ch_j = torch.where(last, one, carr[j_glob])
    sh_j = torch.where(last, zero, sarr[j_glob])
    cm1 = torch.where(r_loc == 0, one, carr[torch.clamp(r_glob - 1, 0, n_pad - 1)])
    # prod_{l=r..j-1} s_l from the exclusive prefix sums (per block)
    Cj = Cx[j_glob]
    Cr = Cx[r_glob]
    nz = Zx[j_glob][:, None, :] - Zx[r_glob][None, :, None]
    neg = NCx[j_glob][:, None, :] - NCx[r_glob][None, :, None]
    mag = torch.exp(Cj[:, None, :] - Cr[None, :, None])
    sign = torch.where(neg % 2 == 0, one, -one)
    prod = torch.where(nz == 0, mag * sign, zero)
    r_b = r_loc[None, :, None]
    j_b = jc_cl[:, None, :]
    val = torch.where(
        r_b == j_b + 1,
        -sh_j[:, None, :],
        torch.where(r_b <= j_b, ch_j[:, None, :] * cm1[None, :, None] * prod, zero),
    )
    return torch.where(cmask[:, None, None], val, zero)


def _gemm_pass(x, wbuilder, *, g: _spmd.Geometry, B: int, t2: int, half_restrict: bool,
               Lr: int, Lw: int, myr: int, myc: int):
    """One block-diagonal-restricted SUMMA pass with generated right
    operands: ``acc[rows of block b, cols of block b] += Q[.., k] W_k`` over
    the contraction tiles k of each block.  Tile column k's panel (the rows
    of this rank's window) is summed over 'c' from its one owner on every
    rank, for every k, as the JAX kernel's ``psum``: the ranks of a row
    enter the same collectives.  Rows and columns outside the JAX kernel's
    masks are then skipped rather than multiplied by zero."""
    th = t2 // 2
    mt = g.mt
    dev = x.device
    acc = torch.zeros_like(x)
    for idx in range(B * t2):
        b, kk = divmod(idx, t2)
        k = b * t2 + kk
        if half_restrict:
            row_start, span = b * t2 + (kk // th) * th, th
        else:
            row_start, span = b * t2, t2
        rs = min(max((row_start + g.pr - 1 - myr) // g.pr, 0), max(g.ltr - Lr, 0))
        rows = [li for li in range(rs, rs + Lr)
                if row_start <= li * g.pr + myr < min(row_start + span, mt)]
        # the same rows on every rank of this rank's row (they depend on myr)
        r0, r1 = (rows[0], rows[-1] + 1) if rows else (rs, rs)
        lkc = min(max(k // g.pc, 0), max(g.ltc - 1, 0))
        aw = x[r0:r1, lkc]
        panel = coll.psum_axis(aw if myc == k % g.pc else torch.zeros_like(aw), COL_AXIS)
        cs = min(max((b * t2 + g.pc - 1 - myc) // g.pc, 0), max(g.ltc - Lw, 0))
        gj_w = (cs + torch.arange(Lw, device=dev)) * g.pc + myc
        cmask = (gj_w >= b * t2) & (gj_w < (b + 1) * t2) & (gj_w < mt)
        cols = [cj for cj in range(cs, cs + Lw)
                if b * t2 <= cj * g.pc + myc < min((b + 1) * t2, mt)]
        if not rows or not cols:
            continue
        c0, c1 = cols[0], cols[-1] + 1
        w = wbuilder(k, b, gj_w[c0 - cs:c1 - cs], cmask[c0 - cs:c1 - cs])
        acc[r0:r1, c0:c1] += torch.einsum("iab,jbc->ijac", panel, w)
    return acc


def _level_kernel(x, arrs, *, g: _spmd.Geometry, S: int, B: int, n_pad: int, rot: bool):
    """One merge level's eigenvector update ``Q <- Q (P G) U``
    (``tridiag_dc_dist.py:536``)."""
    myr, myc = coll.my_rank()
    t2 = S // g.nb
    th = t2 // 2
    Lh = min(g.ltr, -(-th // g.pr))
    Lf = min(g.ltr, -(-t2 // g.pr))
    Lw = min(g.ltc, -(-t2 // g.pc))
    ds, zhat, anchor, off, norms, keep, ord2, io, carr, sarr, close, Cx, Zx, NCx = arrs
    uprm = (ds, zhat, anchor, off, norms, keep, ord2, io)
    kw = dict(g=g, S=S, n_pad=n_pad)
    if not rot:
        def ub(k, b, gj_w, cmask):
            return _u_tile(k, b, gj_w, cmask, uprm, row_remap=True, **kw)
        return _gemm_pass(x, ub, g=g, B=B, t2=t2, half_restrict=True, Lr=Lh, Lw=Lw,
                          myr=myr, myc=myc)
    gprm = (io, carr, sarr, close, Cx, Zx, NCx)

    def gb(k, b, gj_w, cmask):
        return _pg_tile(k, b, gj_w, cmask, gprm, **kw)

    def ub2(k, b, gj_w, cmask):
        return _u_tile(k, b, gj_w, cmask, uprm, row_remap=False, **kw)

    tmp = _gemm_pass(x, gb, g=g, B=B, t2=t2, half_restrict=True, Lr=Lh, Lw=Lw, myr=myr, myc=myc)
    return _gemm_pass(tmp, ub2, g=g, B=B, t2=t2, half_restrict=False, Lr=Lf, Lw=Lw,
                      myr=myr, myc=myc)


def tridiag_dc_distributed(
    grid: Grid,
    d: np.ndarray,
    e: np.ndarray,
    block_size: int,
    dtype=np.float64,
    spectrum: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, DistributedMatrix]:
    """Multi-level D&C of the real symmetric tridiagonal (d, e).  Returns
    (eigenvalues ascending, host numpy; eigenvector DistributedMatrix n x k
    over ``grid``) in the real dtype matching ``dtype``; ``spectrum=(il,
    iu)`` keeps eigenpairs il..iu (k = iu - il + 1) of the whole solve."""
    from dlaf_tpu_torch.matrix import util as mutil

    dtype = np.dtype(dtype)
    if dtype.kind == "c":
        raise NotImplementedError("tridiag_dc_distributed: complex dtypes are not ported")
    tune.validate_eigensolver_matmul_precision(
        tune.get_tune_parameters().eigensolver_matmul_precision)
    rdt = np.float32 if dtype == np.float32 else np.float64
    d = np.asarray(d, rdt)
    e = np.asarray(e, rdt)
    n = d.shape[0]
    nb = int(block_size)
    if n == 0:
        return d, DistributedMatrix.zeros(grid, (0, 0), (nb, nb), rdt)
    s0, L, n_pad = _plan(n, nb, int(tune.get_tune_parameters().dc_leaf_size))
    iters = 70 if rdt == np.float64 else 42

    # host prep: pad, tear all leaf boundaries at once (Cuppen, all levels);
    # padding poles scale with the data
    scale = float(np.max(np.abs(d)) + 2.0 * (np.max(np.abs(e)) if e.size else 0.0))
    big = 1.25 * scale + float(np.finfo(rdt).tiny)
    pad_vals = big * (2.0 + np.arange(n_pad - n, dtype=rdt) / max(1, n_pad))
    d_mod = np.concatenate([d, pad_vals])
    e_pad = np.zeros(n_pad, rdt)
    ne = min(e.shape[0], n - 1)
    e_pad[:ne] = e[:ne]
    for mth in range(s0, n_pad, s0):
        beta = abs(e_pad[mth - 1])
        d_mod[mth - 1] -= beta
        d_mod[mth] -= beta

    dist = Distribution((n_pad, n_pad), (nb, nb), grid.grid_size, (0, 0))
    g = _spmd.Geometry.of(dist)
    dev = grid.device
    nranks = grid.size
    nloc = -(-(n_pad // s0) // nranks)
    RPD = -(-n_pad // nranks)
    d_dev = torch.from_numpy(d_mod).to(dev)
    e_dev = torch.from_numpy(e_pad).to(dev)
    betas = []
    for lvl in range(L):
        S = (s0 << lvl) * 2
        mids = np.arange(n_pad // S) * S + S // 2
        betas.append(torch.from_numpy(e_pad[mids - 1]).to(dev))

    def body(out):
        """The whole solve on this rank's tile stack ``out`` (zeros in,
        eigenvectors out); returns the eigenvalues, the same on every rank."""
        x = torch.zeros_like(out)
        lam = _leaves(d_dev, e_dev, x, g, s0, nloc)
        for lvl in range(L):
            S = (s0 << lvl) * 2
            B = n_pad // S
            prm = _params_kernel(x, lam, betas[lvl], g=g, S=S, B=B, n_pad=n_pad, RPD=RPD,
                                 iters=iters)
            lam = prm[0]
            x = _level_kernel(x, prm[1:15], g=g, S=S, B=B, n_pad=n_pad, rot=bool(prm[15]))
        out.copy_(x)
        return lam

    mat = DistributedMatrix.zeros(grid, (n_pad, n_pad), (nb, nb), rdt)
    lam = coll.spmd(grid, body, mat.data)
    w = lam.cpu().numpy()[:n]
    il, iu = (0, n - 1) if spectrum is None else spectrum
    out = (mutil.sub_matrix(mat, (0, il), (n, iu - il + 1))
           if (n_pad != n or spectrum is not None) else mat)
    return (w if spectrum is None else w[il:iu + 1]), out
