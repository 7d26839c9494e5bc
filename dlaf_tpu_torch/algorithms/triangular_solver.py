"""Distributed triangular solve (counterpart of
``dlaf_tpu/algorithms/triangular_solver.py``), both sides.

Same skeleton as ``cholesky.py``: an eager loop over the tile diagonal of A
that solves one tile row (Left) or tile column (Right) of B against the
diagonal tile and applies a batched update to the remaining rows (columns),
in place on B's local tile stack.  The Left side has two kernels, as in the
JAX package: bucketed (default; the remaining-rows window shrinks by
segment) and lookahead (``tune.trsm_lookahead``), whose bulk update is the
hand-written trailing-update kernel under ``tune.trailing_update_impl=
'fused'``.  The Right side has the bucketed kernel only, its column mirror,
as there.  ``backend='auto'`` on a 1x1 grid is one dense
``torch.linalg.solve_triangular``, where the JAX package uses one XLA
``triangular_solve``; a failure of the dense solve raises (the JAX package
remembers the geometry and runs the tiled kernel instead).

On a ``Pr x Pc`` grid the kernel body runs once per rank thread
(``comm/_ranks.py``) on the ranks' views of A and B.

``refine_to='input'`` appends residual corrections (``_trsm_refined``,
``algorithms/refine.py``), the companion of the bf16 split-GEMM tiers.
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch import tune
from dlaf_tpu_torch.algorithms import _spmd
from dlaf_tpu_torch.algorithms._origin import origin_transparent
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm.grid import COL_AXIS, ROW_AXIS
from dlaf_tpu_torch.matrix import layout
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.ops import tile as t
from dlaf_tpu_torch.ops import trailing_update as _tu


def _masked(mask, x):
    return torch.where(mask[:, None, None], x, torch.zeros_like(x))


def _trsm_left_bucketed(a, b, g_a, g_b, uplo, op, diag):
    """Solve op(A) X = B in place of the local stack ``b``; the
    remaining-rows window of B (and the A panel) has one size per
    segment.  Masked panels make clamped window overlap a no-op."""
    myr, myc = coll.my_rank()
    dev = b.device
    forward = (uplo == t.LOWER) == (op == t.NO_TRANS)
    mt = g_a.mt
    for s0, s1 in _spmd.halving_segments(mt):
        rem = mt - 1 - s0  # max remaining tiles within the segment
        L = max(min(g_b.ltr, (rem + g_a.pr - 1) // g_a.pr + 1), 1)
        for s in range(s0, s1):
            k = s if forward else mt - 1 - s
            kr, kc = k % g_a.pr, k % g_a.pc
            lkr = k // g_a.pr
            akk = _spmd.bcast_diag_tile(a, k, g_a, myr, myc)
            brow = _spmd.take_row(b, lkr, g_b)
            solved = t.trsm(t.LEFT, uplo, op, diag, 1.0, akk, brow)
            xr = coll.bcast(solved, kr, ROW_AXIS)
            if myr == kr:
                _spmd.put_row(b, solved, lkr)
            # remaining-rows window, clamped like the JAX window
            rs = min(max((k + g_a.pr - myr) // g_a.pr, 0), max(g_b.ltr - L, 0)) if forward else 0
            gi_w = (rs + torch.arange(L, device=dev)) * g_a.pr + myr
            remaining = (gi_w > k) if forward else (gi_w < k)
            if op == t.NO_TRANS:
                ac = a[rs:rs + L, k // g_a.pc]
                cp = coll.bcast(_masked(remaining, ac), kc, COL_AXIS)
            else:
                ar = _spmd.take_row(a, lkr, g_a)
                gj = _spmd.local_col_tiles(g_a, myc, dev)
                rem_j = (gj > k) if forward else (gj < k)
                rp = coll.bcast(_masked(rem_j, ar), kr, ROW_AXIS)
                # row panel -> windowed col panel: tiles indexed by A's col j
                cp = t.op_tile(coll.transpose_panel_rows_windowed(rp, gi_w, 0, g_a.mt), op)
                cp = _masked(remaining, cp)
            bs = b[rs:rs + L]  # a view: the update lands in b
            bs -= t.contract("iab,jbc->ijac", cp, xr)


def _trsm_right_bucketed(a, b, g_a, g_b, uplo, op, diag):
    """Solve X op(A) = B in place of the local stack ``b``, the column
    mirror of :func:`_trsm_left_bucketed`: the remaining-cols window of B
    (and the op(A)[k, :] panel) has one size per segment."""
    myr, myc = coll.my_rank()
    dev = b.device
    forward = (uplo == t.LOWER) != (op == t.NO_TRANS)
    nt = g_a.nt
    gi = _spmd.local_row_tiles(g_a, myr, dev)
    for s0, s1 in _spmd.halving_segments(nt):
        rem = nt - 1 - s0  # max remaining tiles within the segment
        C = max(min(g_b.ltc, (rem + g_a.pc - 1) // g_a.pc + 1), 1)
        for s in range(s0, s1):
            k = s if forward else nt - 1 - s
            kr, kc = k % g_a.pr, k % g_a.pc
            lkc = k // g_a.pc
            akk = _spmd.bcast_diag_tile(a, k, g_a, myr, myc)
            bcol = _spmd.take_col(b, lkc, g_b)
            solved = t.trsm(t.RIGHT, uplo, op, diag, 1.0, akk, bcol)
            xc = coll.bcast(solved, kc, COL_AXIS)
            if myc == kc:
                _spmd.put_col(b, solved, lkc)
            # remaining-cols window, clamped like the JAX window
            cs = min(max((k + g_a.pc - myc) // g_a.pc, 0), max(g_b.ltc - C, 0)) if forward else 0
            gj_w = (cs + torch.arange(C, device=dev)) * g_a.pc + myc
            remaining = (gj_w > k) if forward else (gj_w < k)
            if op == t.NO_TRANS:
                ar = a[k // g_a.pr, cs:cs + C]
                rp = coll.bcast(_masked(remaining, ar), kr, ROW_AXIS)
            else:
                ac = _spmd.take_col(a, lkc, g_a)  # tiles A[i, k] for local rows i
                rem_i = (gi > k) if forward else (gi < k)
                cp = coll.bcast(_masked(rem_i, ac), kc, COL_AXIS)
                # col panel -> windowed row panel: tiles indexed by A's row j
                rp = t.op_tile(coll.transpose_panel_windowed(cp, gj_w, 0, g_a.nt), op)
                rp = _masked(remaining, rp)
            bs = b[:, cs:cs + C]  # a view: the update lands in b
            bs -= t.contract("iab,jbc->ijac", xc, rp)


def _trsm_left_lookahead(a, b, g_a, g_b, uplo, op, diag):
    """Lookahead kernel: each step writes back row k, applies the narrow
    update to row k+1, solves row k+1, then applies the bulk update with
    row k+1 excluded."""
    myr, myc = coll.my_rank()
    dev = b.device
    forward = (uplo == t.LOWER) == (op == t.NO_TRANS)
    mt = g_a.mt
    gi = _spmd.local_row_tiles(g_b, myr, dev)
    fused_tier = tune.trailing_update_tier() == "fused"

    def a_tile(k, i):
        """op(A)[i, k] on every rank (one tile)."""
        src_r, src_c = (i, k) if op == t.NO_TRANS else (k, i)
        rr, cc = src_r % g_a.pr, src_c % g_a.pc
        tile = _spmd.take_tile(_spmd.take_col(a, src_c // g_a.pc, g_a), src_r // g_a.pr)
        mine = myr == rr and myc == cc
        return t.op_tile(coll.bcast2d(tile if mine else torch.zeros_like(tile), rr, cc), op)

    def solve_row(k):
        akk = _spmd.bcast_diag_tile(a, k, g_a, myr, myc)
        brow = _spmd.take_row(b, k // g_a.pr, g_b)
        solved = t.trsm(t.LEFT, uplo, op, diag, 1.0, akk, brow)
        return coll.bcast(solved, k % g_a.pr, ROW_AXIS)

    def write_row(k, xr):
        if myr == k % g_a.pr:
            _spmd.put_row(b, xr, k // g_a.pr)

    def panel(k):
        """cp[i] = op(A)[i, k] for local rows i beyond k."""
        remaining = (gi > k) if forward else (gi < k)
        if op == t.NO_TRANS:
            ac = _spmd.take_col(a, k // g_a.pc, g_a)
            return coll.bcast(_masked(remaining, ac), k % g_a.pc, COL_AXIS)
        ar = _spmd.take_row(a, k // g_a.pr, g_a)
        gj = _spmd.local_col_tiles(g_a, myc, dev)
        rem_j = (gj > k) if forward else (gj < k)
        rp = coll.bcast(_masked(rem_j, ar), k % g_a.pr, ROW_AXIS)
        cp = t.op_tile(coll.transpose_panel_rows(rp, g_a.mt, g_b.ltr), op)
        return _masked(remaining, cp)

    xr = solve_row(0 if forward else mt - 1)
    for s in range(mt - 1):
        k = s if forward else mt - 1 - s
        k1 = k + 1 if forward else k - 1
        write_row(k, xr)
        # narrow update: row k1 only, so its solve can start immediately
        # (the tile's broadcast is a collective: every rank takes part)
        a1 = a_tile(k, k1)
        if myr == k1 % g_a.pr:
            brow1 = _spmd.take_row(b, k1 // g_a.pr, g_b)
            brow1 -= t.contract("ab,jbc->jac", a1, xr)
        xr1 = solve_row(k1)
        # bulk update, row k1 excluded (already updated)
        cp = panel(k)
        cp = torch.where((gi == k1)[:, None, None], torch.zeros_like(cp), cp).contiguous()
        if fused_tier and _tu.update_kernel_ok(b.dtype):
            _tu.trailing_update(b, cp, xr, _tu.TRSM_SUBSCRIPTS)
        else:
            b -= t.contract(_tu.TRSM_SUBSCRIPTS, cp, xr)
        xr = xr1
    write_row(mt - 1 if forward else 0, xr)


def _trsm_single_device(side, uplo, op, diag, alpha, mat_a, mat_b):
    """1x1-grid dense path: one ``torch.linalg.solve_triangular`` on the
    dense operands."""
    da, db = mat_a.dist, mat_b.dist
    ga = layout.unpad_global(layout.unpack(mat_a.data, da), da)
    gb = layout.unpad_global(layout.unpack(mat_b.data, db), db)
    out = t.trsm(side, uplo, op, diag, alpha, ga, gb)
    return mat_b._inplace(layout.pack(layout.pad_global(out, db), db))


@origin_transparent
def triangular_solver(side: str, uplo: str, op: str, diag: str, alpha,
                      mat_a: DistributedMatrix, mat_b: DistributedMatrix,
                      backend: str = "auto", refine_to: str | None = None,
                      refine_sweeps: int = 2):
    """B := solution X of op(A) X = alpha B (Left) or X op(A) = alpha B
    (Right), in place in ``mat_b``; A is triangular (only its ``uplo``
    triangle is read).  ``backend='auto'`` uses the dense path on 1x1
    grids; 'distributed' forces the tiled kernel.

    ``refine_to='input'`` appends up to ``refine_sweeps`` residual
    corrections: r = alpha B - op(A) X at full precision (a
    ``triangular_multiplication`` under ``gemm_precision_scope('default')``),
    d = the solve of r at the ambient tier, X += d.  It keeps a copy of B
    from before the solve and returns a new matrix."""
    if side not in (t.LEFT, t.RIGHT):
        raise ValueError(f"trsm: bad side {side!r}")
    if refine_to is not None:
        from dlaf_tpu_torch.algorithms.refine import validate_refine_to

        validate_refine_to(refine_to)
        b_snap = mat_b.astype(mat_b.dtype)  # a copy: the solve overwrites B
        x = triangular_solver(side, uplo, op, diag, alpha, mat_a, mat_b, backend=backend)
        return _trsm_refined(side, uplo, op, diag, alpha, mat_a, x, b_snap, backend,
                             refine_sweeps)
    if mat_a.size.rows != mat_a.size.cols:
        raise ValueError("trsm: A must be square")
    if mat_a.block_size.rows != mat_a.block_size.cols:
        raise ValueError("trsm: A tiles must be square")
    need = mat_b.size.rows if side == t.LEFT else mat_b.size.cols
    need_b = mat_b.block_size.rows if side == t.LEFT else mat_b.block_size.cols
    if mat_a.size.rows != need or mat_a.block_size.rows != need_b:
        raise ValueError(f"trsm: A size {mat_a.size} incompatible with B {mat_b.size} for side {side}")
    if mat_a.grid is not mat_b.grid and mat_a.grid.grid_size != mat_b.grid.grid_size:
        raise ValueError("trsm: A and B must share the grid")
    g_a = _spmd.Geometry.of(mat_a.dist)
    g_b = _spmd.Geometry.of(mat_b.dist)
    if g_b.mt == 0 or g_b.nt == 0 or g_a.mt == 0:
        return mat_b
    if backend == "auto" and mat_b.grid.grid_size.count() == 1:
        return _trsm_single_device(side, uplo, op, diag, alpha, mat_a, mat_b)
    if backend not in ("auto", "distributed"):
        raise ValueError(f"trsm: unknown backend {backend!r}")
    # lookahead is a Left kernel only, as in the JAX package
    if side == t.RIGHT:
        kern = _trsm_right_bucketed
    elif tune.get_tune_parameters().trsm_lookahead and g_a.mt > 1:
        kern = _trsm_left_lookahead
    else:
        kern = _trsm_left_bucketed

    def body(a, b):
        myr, myc = coll.my_rank()
        if g_a.m % g_a.mb:  # ragged: padded diagonal tiles need an identity, on a copy
            a = _spmd.pad_diag_identity(a.clone(), g_a, myr, myc)
        if alpha != 1:
            b.mul_(alpha)
        kern(a, b, g_a, g_b, uplo, op, diag)

    coll.spmd(mat_b.grid, body, mat_a.data, mat_b.data)
    return mat_b._inplace(mat_b.data)


def _trsm_refined(side, uplo, op, diag, alpha, mat_a, x, b_snap, backend, refine_sweeps):
    """The ``refine_to='input'`` tail of :func:`triangular_solver`
    (``_trsm_refined``, JAX :463)."""
    from dlaf_tpu_torch.algorithms.multiplication import triangular_multiplication
    from dlaf_tpu_torch.algorithms.norm import max_norm
    from dlaf_tpu_torch.algorithms.refine import refine_tolerance, residual_refine

    anorm = max_norm(mat_a, uplo)

    def residual(xc):
        # a new matrix, and an elementwise subtraction: no contraction
        ax = triangular_multiplication(side, uplo, op, diag, 1.0, mat_a, xc)
        return ax.like(alpha * b_snap.data.to(ax.dtype) - ax.data)

    x, _ = residual_refine(
        x,
        residual,
        lambda r: triangular_solver(side, uplo, op, diag, 1.0, mat_a, r, backend=backend),
        tol=refine_tolerance(anorm, mat_a.size.rows, x.dtype),
        anorm=anorm,
        max_sweeps=refine_sweeps,
    )
    return x
