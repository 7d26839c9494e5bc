"""Distributed triangular inverse, TRTRI (counterpart of
``dlaf_tpu/algorithms/inverse.py``).

Lower: a backward loop over the tile columns k,

    inv[k, k]    = L[k, k]^-1
    inv[k+1:, k] = -inv[k+1:, k+1:] @ L[k+1:, k] @ inv[k, k]

where the trailing block of the inverse is final already.  Each step
broadcasts the diagonal tile and original column k, transposes the column
into a row panel, contracts it with the local trailing tiles of the
inverse, sums over the grid's columns (``psum_axis``) and scales by the
inverted diagonal tile.  Upper is the row-wise mirror.  The trailing
window has one size per segment (``_spmd.halving_segments``), as in the
JAX package's bucketed kernels, which are what ``triangular_inverse``
runs on a grid larger than 1x1.

Under ``tune.trailing_update_impl='fused'`` the transpose is the consume
ring's transport (``ops/trailing_update.consume_exchange``) and the
contraction the one-shot panel contraction (B9, ``panel_contract``: its
sum crosses panel slots, so it is not applied per hop); under 'xla' it is
``transpose_panel_windowed`` and a ``torch.einsum``.  A 1x1 grid takes one
dense triangular solve against the identity (``torch.linalg.solve_triangular``),
where the JAX package leaves it to XLA.

:func:`inverse_from_cholesky_factor` (POTRI) is TRTRI, then one
``general_multiplication`` of the inverse factor with itself.

Not in this slice (see ROADMAP.md): the masked kernels
``_trtri_lower_kernel`` / ``_trtri_upper_kernel``, which
``triangular_inverse`` does not reach in the JAX package either.
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


def _windows(g: _spmd.Geometry):
    """(s0, s1, L, C) per segment of the backward loop: windows grow with
    the step, so a segment sizes its window for its last step."""
    for s0, s1 in _spmd.halving_segments(g.mt):
        rem = s1 - 1
        L = max(min(g.ltr, (rem + g.pr - 1) // g.pr + 1), 1)
        C = max(min(g.ltc, (rem + g.pc - 1) // g.pc + 1), 1)
        yield s0, s1, L, C


def _window_starts(k: int, g: _spmd.Geometry, L: int, C: int, myr: int, myc: int):
    """First local slots with global index >= k+1, clamped as the JAX
    windows clamp."""
    rs = min(max((k + g.pr - myr) // g.pr, 0), max(g.ltr - L, 0))
    cs = min(max((k + g.pc - myc) // g.pc, 0), max(g.ltc - C, 0))
    return rs, cs


def _contract(xk, panel, subscripts: str, fused: bool):
    if fused and _tu.update_kernel_ok(xk.dtype):
        return _tu.panel_contract(xk.contiguous(), panel.contiguous(), subscripts)
    return t.contract(subscripts, xk, panel)


def _trtri_lower_bucketed(x, g: _spmd.Geometry, diag: str):
    """``_trtri_lower_bucketed_kernel`` (:79) on this rank's stack, in place."""
    myr, myc = coll.my_rank()
    dev = x.device
    eye = torch.eye(g.mb, dtype=x.dtype, device=dev)
    fused = tune.trailing_update_tier() == "fused"
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    for s0, s1, L, C in _windows(g):
        gi0, gj0 = torch.arange(L, device=dev), torch.arange(C, device=dev)
        for s in range(s0, s1):
            k = g.mt - 1 - s
            kr, kc = k % g.pr, k % g.pc
            lkr, lkc = k // g.pr, k // g.pc
            akk = _spmd.bcast_diag_tile(x, k, g, myr, myc)
            tkk = t.trsm(t.LEFT, t.LOWER, t.NO_TRANS, diag, 1.0, akk, eye)
            rs, cs = _window_starts(k, g, L, C, myr, myc)
            gi_w = (rs + gi0) * g.pr + myr
            gj_w = (cs + gj0) * g.pc + myc
            below = (gi_w > k)[:, None, None]
            # original column k below the diagonal, to every rank column
            xc = x[rs:rs + L, lkc]
            cp = coll.bcast(torch.where(below, xc, zero), kc, COL_AXIS, consumed=fused)
            if fused:
                taken, have = coll.transpose_panel_windowed_parts(cp, gj_w, rs, g.mt)
                rp = _tu.consume_exchange(taken, have, ROW_AXIS)
            else:
                rp = coll.transpose_panel_windowed(cp, gj_w, rs, g.mt)  # L[j, k]
            # S[i] = sum_j inv[i, j] L[j, k] over the trailing slab
            xs = x[rs:rs + L, cs:cs + C]
            keep = ((gj_w > k)[None, :] & (gi_w[:, None] >= gj_w[None, :]))[:, :, None, None]
            s_part = _contract(torch.where(keep, xs, zero), rp, _tu.TRTRI_LOWER_SUBSCRIPTS, fused)
            s_full = coll.psum_axis(s_part, COL_AXIS)
            newcol = -t.contract("iab,bc->iac", s_full, tkk)
            if myc == kc:
                x[rs:rs + L, lkc] = torch.where(below, newcol, xc)
                if myr == kr:  # the diagonal tile, outside the window
                    x[lkr, lkc] = tkk


def _trtri_upper_bucketed(x, g: _spmd.Geometry, diag: str):
    """``_trtri_upper_bucketed_kernel`` (:151), the row-wise mirror."""
    myr, myc = coll.my_rank()
    dev = x.device
    eye = torch.eye(g.mb, dtype=x.dtype, device=dev)
    fused = tune.trailing_update_tier() == "fused"
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    for s0, s1, L, C in _windows(g):
        gi0, gj0 = torch.arange(L, device=dev), torch.arange(C, device=dev)
        for s in range(s0, s1):
            k = g.mt - 1 - s
            kr, kc = k % g.pr, k % g.pc
            lkr, lkc = k // g.pr, k // g.pc
            akk = _spmd.bcast_diag_tile(x, k, g, myr, myc)
            tkk = t.trsm(t.LEFT, t.UPPER, t.NO_TRANS, diag, 1.0, akk, eye)
            rs, cs = _window_starts(k, g, L, C, myr, myc)
            gi_w = (rs + gi0) * g.pr + myr
            gj_w = (cs + gj0) * g.pc + myc
            right = (gj_w > k)[:, None, None]
            # windowed row panel of U[k, cs:cs+C], to every rank row
            xr = x[lkr, cs:cs + C]
            rp = coll.bcast(torch.where(right, xr, zero), kr, ROW_AXIS, consumed=fused)
            if fused:
                taken, have = coll.transpose_panel_rows_windowed_parts(rp, gi_w, cs, g.nt)
                cp = _tu.consume_exchange(taken, have, COL_AXIS)
            else:
                cp = coll.transpose_panel_rows_windowed(rp, gi_w, cs, g.nt)
            xs = x[rs:rs + L, cs:cs + C]
            keep = ((gi_w > k)[:, None] & (gi_w[:, None] <= gj_w[None, :]))[:, :, None, None]
            s_part = _contract(cp, torch.where(keep, xs, zero), _tu.TRTRI_UPPER_SUBSCRIPTS, fused)
            s_full = coll.psum_axis(s_part, ROW_AXIS)
            newrow = -t.contract("ab,jbc->jac", tkk, s_full)
            if myr == kr:
                x[lkr, cs:cs + C] = torch.where(right, newrow, xr)
                if myc == kc:
                    x[lkr, lkc] = tkk


def _trtri_single_device(uplo: str, diag: str, mat_a: DistributedMatrix) -> DistributedMatrix:
    """1x1-grid path (``_trtri_single_device``, :248): a dense triangular
    solve against the identity; the triangle not referenced is kept as the
    caller stored it."""
    dist = mat_a.dist
    g_ = layout.unpad_global(layout.unpack(mat_a.data, dist), dist)
    eye = torch.eye(g_.shape[0], dtype=g_.dtype, device=g_.device)
    inv = t.trsm(t.LEFT, uplo, t.NO_TRANS, diag, 1.0, g_, eye)
    out = torch.tril(inv) + torch.triu(g_, 1) if uplo == t.LOWER \
        else torch.triu(inv) + torch.tril(g_, -1)
    return mat_a._inplace(layout.pack(layout.pad_global(out, dist), dist))


@origin_transparent
def triangular_inverse(uplo: str, diag: str, mat_a: DistributedMatrix) -> DistributedMatrix:
    """In-place inverse of the ``uplo`` triangle of A (``diag`` 'N', or 'U'
    for a unit diagonal); the other triangle is not referenced."""
    if mat_a.size.rows != mat_a.size.cols or mat_a.block_size.rows != mat_a.block_size.cols:
        raise ValueError("trtri: A must be square with square tiles")
    if uplo not in (t.LOWER, t.UPPER) or diag not in (t.NON_UNIT, t.UNIT):
        raise ValueError(f"trtri: uplo {uplo!r}, diag {diag!r}")
    g = _spmd.Geometry.of(mat_a.dist)
    if g.mt == 0:
        return mat_a
    if mat_a.grid.grid_size.count() == 1:
        return _trtri_single_device(uplo, diag, mat_a)
    kern = _trtri_lower_bucketed if uplo == t.LOWER else _trtri_upper_bucketed

    def body(x):
        myr, myc = coll.my_rank()
        _spmd.pad_diag_identity(x, g, myr, myc)
        kern(x, g, diag)
        _spmd.pad_diag_identity(x, g, myr, myc, remove=True)

    coll.spmd(mat_a.grid, body, mat_a.data)
    return mat_a._inplace(mat_a.data)


@origin_transparent
def inverse_from_cholesky_factor(uplo: str, mat_a: DistributedMatrix) -> DistributedMatrix:
    """POTRI (``inverse_from_cholesky_factor``, :305): given the Cholesky
    factor in the ``uplo`` triangle of A, return A^-1 in full Hermitian
    storage, a new matrix.  ``mat_a`` is inverted in place on the way
    (TRTRI), as in the JAX package, whose TRTRI donates it."""
    from dlaf_tpu_torch.algorithms.multiplication import general_multiplication
    from dlaf_tpu_torch.matrix.util import extract_triangle

    tinv = triangular_inverse(uplo, t.NON_UNIT, mat_a)
    tri = extract_triangle(tinv, uplo)
    out = DistributedMatrix(tinv.dist, tinv.grid, torch.zeros_like(tinv.data))
    if uplo == t.LOWER:  # A^-1 = L^-H L^-1
        return general_multiplication(t.CONJ_TRANS, t.NO_TRANS, 1.0, tri, tri, 0.0, out)
    # A^-1 = U^-1 U^-H
    return general_multiplication(t.NO_TRANS, t.CONJ_TRANS, 1.0, tri, tri, 0.0, out)
