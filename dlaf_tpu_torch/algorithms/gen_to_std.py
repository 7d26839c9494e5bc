"""Generalized-to-standard reduction, HEGST type 1 (counterpart of
``dlaf_tpu/algorithms/gen_to_std.py``).

Given the Cholesky factor of B (B = L L^H, or B = U^H U), transforms A of
A x = lambda B x into the standard form A_std = L^-1 A L^-H
(U^-H A U^-1).  Two backends (``tune.gen_to_std_backend``), as in the JAX
package:

- ``composed`` (default): hermitize A, then two full triangular solves
  (Left, then Right; ``triangular_solver``).
- ``fused``: the hegst tile recursion with each panel's trailing solve
  deferred.  Phase A is one panel loop per rank thread: the diagonal tile
  transformed on every rank, the panel's Right solve against it, the two
  halves of the hemm correction and the her2k on the trailing window,
  which shrinks by segment.  L being lower triangular, every deferred
  ``inv(L_trail) P`` is ``inv(L) P``, so phase B is one Left solve of the
  strictly-lower tile part, whose diagonal tiles are then added back.
  Under ``trailing_update_impl='fused'`` the her2k is two consume rings a
  step (``ops/trailing_update.fused_transpose_update``: B6 on the card,
  its twin on the CPU), the window staged once into a contiguous copy for
  both.  A 1x1 grid always takes 'composed'.

The U case of 'fused' runs the L recursion on L := U^H (one transpose).
Full Hermitian storage out, as in the JAX package.
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch import tune
from dlaf_tpu_torch.algorithms import _spmd
from dlaf_tpu_torch.algorithms._origin import origin_transparent
from dlaf_tpu_torch.algorithms.triangular_solver import triangular_solver
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm.grid import COL_AXIS, ROW_AXIS
from dlaf_tpu_torch.matrix import util as mutil
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.ops import tile as t
from dlaf_tpu_torch.ops import trailing_update as _tu


def _hegst_phase_a(a, b, g: _spmd.Geometry):
    """Phase A of the fused hegst (lower) on this rank's local stacks, ``a``
    (full Hermitian storage, updated in place) and ``b`` (the factor L),
    for each tile panel k (``_hegst_phase_a_kernel``, JAX :56)::

      akk := inv(lkk) akk inv(lkk)^H        (diagonal, on every rank)
      P   := A[i>k, k] inv(lkk)^H           (panel Right solve)
      P   -= 1/2 L[i>k, k] akk              (first hemm correction)
      A[i>k, j>k] -= L_p P^H + P L_p^H      (her2k, bucketed window)
      P   -= 1/2 L[i>k, k] akk              (second hemm correction)
    """
    myr, myc = coll.my_rank()
    dev = a.device
    fused_tier = tune.trailing_update_tier() == "fused"
    for k0, k1 in _spmd.halving_segments(g.mt):
        L = max(min(g.ltr, (g.mt - 1 - k0 + g.pr - 1) // g.pr + 1), 1)
        C = max(min(g.ltc, (g.mt - 1 - k0 + g.pc - 1) // g.pc + 1), 1)
        for k in range(k0, k1):
            kr, kc = k % g.pr, k % g.pc
            lkr, lkc = k // g.pr, k // g.pc
            lkk = _spmd.bcast_diag_tile(b, k, g, myr, myc)
            akk = _spmd.bcast_diag_tile(a, k, g, myr, myc)
            akk = t.trsm(t.LEFT, t.LOWER, t.NO_TRANS, t.NON_UNIT, 1.0, lkk, akk)
            akk = t.trsm(t.RIGHT, t.LOWER, t.CONJ_TRANS, t.NON_UNIT, 1.0, lkk, akk)
            # window of the remaining rows and cols (first slot with index >=
            # k+1), clamped like the JAX windows
            rs = min(max((k + g.pr - myr) // g.pr, 0), max(g.ltr - L, 0))
            cs = min(max((k + g.pc - myc) // g.pc, 0), max(g.ltc - C, 0))
            gi_w = (rs + torch.arange(L, device=dev)) * g.pr + myr
            jv = (cs + torch.arange(C, device=dev)) * g.pc + myc
            below = (gi_w > k)[:, None, None]
            xa = a[rs:rs + L, lkc]
            xl = b[rs:rs + L, lkc]
            pan = t.trsm(t.RIGHT, t.LOWER, t.CONJ_TRANS, t.NON_UNIT, 1.0, lkk, xa)
            corr = 0.5 * t.contract("iab,bc->iac", xl, akk)
            pan1 = pan - corr  # the value the her2k uses
            zero = torch.zeros((), dtype=a.dtype, device=dev)
            cp_a = coll.bcast(torch.where(below, pan1, zero), kc, COL_AXIS, consumed=fused_tier)
            cp_l = coll.bcast(torch.where(below, xl, zero), kc, COL_AXIS, consumed=fused_tier)
            if fused_tier:
                taken_a, have_a = coll.transpose_panel_windowed_parts(cp_a, jv, rs, g.mt)
                taken_l, have_l = coll.transpose_panel_windowed_parts(cp_l, jv, rs, g.mt)
            else:
                rp_a = coll.transpose_panel_windowed(cp_a, jv, rs, g.mt)
                rp_l = coll.transpose_panel_windowed(cp_l, jv, rs, g.mt)
            # the twice-corrected panel and the transformed diagonal tile
            if myc == kc:
                a[rs:rs + L, lkc] = torch.where(below, pan1 - corr, xa)
                if myr == kr:
                    a[lkr, lkc] = akk
            xs = a[rs:rs + L, cs:cs + C]  # a view: the updates land in a
            if fused_tier:
                # two consume rings, one per addend, each fed the other
                # panel's exchange.  Slots at or left of panel k are
                # suppressed: under 'xla' they carry exact zeros (the below
                # mask zeroed them at the bcast), so the bits agree.  The
                # ring conjugates the exchanged panel, as the JAX kernel
                # does with its default conj_panel=True.  It takes a
                # contiguous x: the window is staged once for both rings.
                xw = xs if xs.is_contiguous() else xs.contiguous()
                suppress = jv <= k
                _tu.fused_transpose_update(xw, cp_l, taken_a, have_a, suppress, ROW_AXIS)
                _tu.fused_transpose_update(xw, cp_a, taken_l, have_l, suppress, ROW_AXIS)
                if xw is not xs:
                    xs.copy_(xw)
            else:
                xs -= t.contract("iab,jcb->ijac", cp_l, rp_a.conj())
                xs -= t.contract("iab,jcb->ijac", cp_a, rp_l.conj())


def _tile_mask(mat: DistributedMatrix, rel: str) -> DistributedMatrix:
    """A copy keeping only the tiles with row tile > col tile (``rel='lt'``)
    or row tile == col tile (``'diag'``), the rest zero (JAX :153)."""
    d = mat.dist
    gi, gj = mutil._global_element_grids(d, mat.data.device)
    ti, tj = gi // d.block_size.rows, gj // d.block_size.cols
    keep = (ti > tj) if rel == "lt" else (ti == tj)
    return mat.like(torch.where(keep, mat.data, torch.zeros((), dtype=mat.dtype,
                                                            device=mat.data.device)))


def _gen_to_std_fused(mat_a_full: DistributedMatrix, mat_b_l: DistributedMatrix):
    """Fused hegst, lower-factor form: ``mat_a_full`` holds full Hermitian
    storage (updated in place by phase A), ``mat_b_l`` the factor L."""
    g = _spmd.Geometry.of(mat_a_full.dist)
    g_b = _spmd.Geometry.of(mat_b_l.dist)
    if g.mt == 0:
        return mat_a_full
    if (g.mb, g.pr, g.pc, g.mt) != (g_b.mb, g_b.pr, g_b.pc, g_b.mt):
        raise ValueError("gen_to_std: A and B distributions must match")

    def body(a, b):
        if g.m % g.mb:  # ragged: padded L tiles need an identity, on a copy
            myr, myc = coll.my_rank()
            b = _spmd.pad_diag_identity(b.clone(), g, myr, myc)
        _hegst_phase_a(a, b, g)

    coll.spmd(mat_a_full.grid, body, mat_a_full.data, mat_b_l.data)
    ph_a = mat_a_full._inplace(mat_a_full.data)
    # phase B: the deferred per-panel inv(L_trail) solves as one Left solve
    # of the strictly-lower tile part
    x = triangular_solver(t.LEFT, t.LOWER, t.NO_TRANS, t.NON_UNIT, 1.0, mat_b_l,
                          _tile_mask(ph_a, "lt"))
    lower = x.like(x.data + _tile_mask(ph_a, "diag").data)
    return mutil.hermitize(lower, "L")


@origin_transparent
def generalized_to_standard(uplo: str, mat_a: DistributedMatrix,
                            mat_b: DistributedMatrix) -> DistributedMatrix:
    """A_std = inv(fac) A inv(fac)^H with fac = L ('L': B = L L^H) or
    fac = U^H ('U': B = U^H U, A_std = U^-H A U^-1).

    ``mat_a``: Hermitian, its ``uplo`` triangle read (not modified).
    ``mat_b``: the Cholesky factor in its ``uplo`` triangle (not modified).
    Returns a new matrix, A_std in full Hermitian storage."""
    if uplo not in (t.LOWER, t.UPPER):
        raise ValueError(f"gen_to_std: bad uplo {uplo!r}")
    backend = tune.validate_gen_to_std_backend(tune.get_tune_parameters().gen_to_std_backend)
    a_full = mutil.hermitize(mat_a, uplo)
    if backend == "fused" and mat_a.grid.grid_size.count() > 1:
        # U: B = U^H U, so with L := U^H (one conjugate transpose) the
        # transform is the same L^-1 A L^-H
        b_l = mat_b if uplo == t.LOWER else mutil.transpose(
            mutil.extract_triangle(mat_b, "U"), conj=True)
        return _gen_to_std_fused(a_full, b_l)
    first, second = ((t.NO_TRANS, t.CONJ_TRANS) if uplo == t.LOWER
                     else (t.CONJ_TRANS, t.NO_TRANS))
    a1 = triangular_solver(t.LEFT, uplo, first, t.NON_UNIT, 1.0, mat_b, a_full)
    return triangular_solver(t.RIGHT, uplo, second, t.NON_UNIT, 1.0, mat_b, a1)
