"""Distributed matrix multiplication: GEMM, TRMM and HEMM on the 2D
block-cyclic grid (counterpart of ``dlaf_tpu/algorithms/multiplication.py``).

All three share one SUMMA loop over the contraction tile index k.  Each
step broadcasts column k of op(A) along 'c' and row k of op(B) along 'r'
(a transposed operand is fetched from its stored direction and
redistributed with the ``transpose_panel`` collectives), then adds the
panel outer product to C with one batched ``tile.contract`` at the ambient
split-GEMM tier.  Triangular and Hermitian structure is applied by masking
the broadcast A panels.  The Right side runs the mirror loop (column k of
B along 'c', row k of op(A) along 'r').  A 1x1 grid takes one dense
contraction of the global operands (``_run_dense_local``).

On a ``Pr x Pc`` grid the loop runs once per rank thread
(``comm/_ranks.py``) on the ranks' views of A, B and C; C is updated in
place (the JAX package donates it and returns a new array).  A and B are
only read, so they may be the same matrix; C must not alias either.

Not in this slice: ``general_sub_multiplication`` (it needs
``matrix/ref.py`` and ``matrix/window.py``; ROADMAP.md §A, item 1).
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch.algorithms import _spmd
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm.grid import COL_AXIS, ROW_AXIS
from dlaf_tpu_torch.matrix import layout
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.ops import tile as t

# A-panel structure masks
_FULL = "full"
_LOWER_TRI = "ltri"  # A triangular-lower: tiles above the diagonal zero, diagonal tril
_UPPER_TRI = "utri"
_HERM_LOWER = "herm_l"  # Hermitian, lower stored: upper tiles are the mirror^H
_HERM_UPPER = "herm_u"


def _scalar(v, dtype: torch.dtype):
    """``jnp.asarray(v, dtype)`` as a Python number: a real dtype keeps the
    real part of a complex ``v``."""
    v = complex(v)
    return v if dtype.is_complex else v.real


def _masked(keep, x):
    return torch.where(keep[:, None, None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def _transpose_structure(structure):
    return {_FULL: _FULL, _LOWER_TRI: _UPPER_TRI, _UPPER_TRI: _LOWER_TRI}[structure]


def _hermitize_tile(tiles, lower: bool):
    """The full Hermitian tile from its stored triangle."""
    if lower:
        return torch.tril(tiles) + torch.tril(tiles, -1).transpose(-1, -2).conj()
    return torch.triu(tiles) + torch.triu(tiles, 1).transpose(-1, -2).conj()


def _structure_mask_col(ac, gi, k: int, structure, diag):
    """Mask a column-k panel [lt, mb, nb] of A by triangular structure."""
    if structure == _FULL:
        return ac
    lower = structure == _LOWER_TRI
    ac = _masked((gi >= k) if lower else (gi <= k), ac)
    dtile = torch.tril(ac) if lower else torch.triu(ac)
    if diag == t.UNIT:
        eye = torch.eye(ac.shape[-2], ac.shape[-1], dtype=ac.dtype, device=ac.device)
        dtile = dtile - dtile * eye + eye
    return torch.where((gi == k)[:, None, None], dtile, ac)


def _a_col_panel(a, k: int, g_a, myr, myc, op, structure, diag, ltr_out, mt_out):
    """Tiles op(A)[i, k] for this rank's local rows i, broadcast to every
    rank column: [ltr_out, mb, nb]."""
    dev = a.device
    gi = torch.arange(ltr_out, device=dev) * g_a.pr + myr
    if structure in (_HERM_LOWER, _HERM_UPPER):
        # column k from the stored triangle's column and the conjugate
        # transpose of the stored row (the diagonal-crossing mirror)
        lower = structure == _HERM_LOWER
        kc, kr = k % g_a.pc, k % g_a.pr
        ac = _masked((gi >= k) if lower else (gi <= k), _spmd.take_col(a, k // g_a.pc, g_a))
        ac = torch.where((gi == k)[:, None, None], _hermitize_tile(ac, lower), ac)
        cp1 = coll.bcast(ac, kc, COL_AXIS)
        gj = _spmd.local_col_tiles(g_a, myc, dev)
        ar = _masked((gj < k) if lower else (gj > k), _spmd.take_row(a, k // g_a.pr, g_a))
        rp = coll.bcast(ar, kr, ROW_AXIS)
        cp2 = t.op_tile(coll.transpose_panel_rows(rp, mt_out, ltr_out), t.CONJ_TRANS)
        return cp1 + cp2
    if op == t.NO_TRANS:
        ac = _structure_mask_col(_spmd.take_col(a, k // g_a.pc, g_a), gi, k, structure, diag)
        return coll.bcast(ac, k % g_a.pc, COL_AXIS)
    # row k of A (tiles A[k, j]), op-transposed into a column panel
    gj = _spmd.local_col_tiles(g_a, myc, dev)
    ar = _spmd.take_row(a, k // g_a.pr, g_a).transpose(-1, -2)
    ar = _structure_mask_col(ar, gj, k, _transpose_structure(structure), diag).transpose(-1, -2)
    rp = coll.bcast(ar, k % g_a.pr, ROW_AXIS)
    return t.op_tile(coll.transpose_panel_rows(rp, mt_out, ltr_out), op)


def _b_row_panel(b, k: int, g_b, op, ltc_out, nt_out):
    """Tiles op(B)[k, j] for this rank's local cols j, broadcast to every
    rank row: [ltc_out, mb, nb]."""
    if op == t.NO_TRANS:
        return coll.bcast(_spmd.take_row(b, k // g_b.pr, g_b), k % g_b.pr, ROW_AXIS)
    cp = coll.bcast(_spmd.take_col(b, k // g_b.pc, g_b), k % g_b.pc, COL_AXIS)
    return t.op_tile(coll.transpose_panel(cp, nt_out, ltc_out), op)


def _a_row_panel(a, k: int, g_a, myr, myc, op, structure, diag, ltc_out, nt_out):
    """Tiles op(A)[k, j] for this rank's local cols j, broadcast to every
    rank row: the mirror of :func:`_a_col_panel`."""
    dev = a.device
    gj = torch.arange(ltc_out, device=dev) * g_a.pc + myc
    if structure in (_HERM_LOWER, _HERM_UPPER):
        lower = structure == _HERM_LOWER
        kr, kc = k % g_a.pr, k % g_a.pc
        ar = _masked((gj <= k) if lower else (gj >= k), _spmd.take_row(a, k // g_a.pr, g_a))
        ar = torch.where((gj == k)[:, None, None], _hermitize_tile(ar, lower), ar)
        rp1 = coll.bcast(ar, kr, ROW_AXIS)
        gi = _spmd.local_row_tiles(g_a, myr, dev)
        ac = _masked((gi > k) if lower else (gi < k), _spmd.take_col(a, k // g_a.pc, g_a))
        cp = coll.bcast(ac, kc, COL_AXIS)
        rp2 = t.op_tile(coll.transpose_panel(cp, nt_out, ltc_out), t.CONJ_TRANS)
        return rp1 + rp2
    if op == t.NO_TRANS:
        ar = _spmd.take_row(a, k // g_a.pr, g_a).transpose(-1, -2)
        ar = _structure_mask_col(ar, gj, k, _transpose_structure(structure), diag)
        return coll.bcast(ar.transpose(-1, -2), k % g_a.pr, ROW_AXIS)
    # transposed: op(A)[k, j] = op(A[j, k]): column k of A, redistributed
    gi = _spmd.local_row_tiles(g_a, myr, dev)
    ac = _structure_mask_col(_spmd.take_col(a, k // g_a.pc, g_a), gi, k, structure, diag)
    cp = coll.bcast(ac, k % g_a.pc, COL_AXIS)
    return t.op_tile(coll.transpose_panel(cp, nt_out, ltc_out), op)


def _summa_left(a, b, c, g_a, g_b, g_c, opa, opb, alpha, beta, structure, diag, kt):
    """``_summa_kernel`` (:143) on this rank's stacks: C := alpha op(A)
    op(B) + beta C, in place of ``c``."""
    myr, myc = coll.my_rank()
    c.mul_(_scalar(beta, c.dtype))
    al = _scalar(alpha, c.dtype)
    for k in range(kt):
        cp = _a_col_panel(a, k, g_a, myr, myc, opa, structure, diag, g_c.ltr, g_c.mt)
        rp = _b_row_panel(b, k, g_b, opb, g_c.ltc, g_c.nt)
        c += al * t.contract("iab,jbc->ijac", cp, rp)


def _summa_right(a, b, c, g_a, g_b, g_c, opa, alpha, beta, structure, diag, kt):
    """``_summa_right_kernel`` (:289): C := alpha B op(A) + beta C, the
    column panel from B's columns, the row panel from op(A)'s rows."""
    myr, myc = coll.my_rank()
    c.mul_(_scalar(beta, c.dtype))
    al = _scalar(alpha, c.dtype)
    for k in range(kt):
        cp = coll.bcast(_spmd.take_col(b, k // g_b.pc, g_b), k % g_b.pc, COL_AXIS)
        rp = _a_row_panel(a, k, g_a, myr, myc, opa, structure, diag, g_c.ltc, g_c.nt)
        c += al * t.contract("iab,jbc->ijac", cp, rp)


def _dense_structured_a(ga, structure, diag):
    """The structured operand in full, on a 1x1 grid."""
    if structure == _FULL:
        return ga
    if structure in (_LOWER_TRI, _UPPER_TRI):
        tri = torch.tril(ga) if structure == _LOWER_TRI else torch.triu(ga)
        if diag == t.UNIT:
            eye = torch.eye(tri.shape[-1], dtype=tri.dtype, device=tri.device)
            tri = tri - tri * eye + eye
        return tri
    return _hermitize_tile(ga, structure == _HERM_LOWER)


def _run_dense_local(mat_a, mat_b, mat_c, opa, opb, alpha, beta, structure, diag, a_right):
    """1x1-grid path (``_run_dense_local``, :178): one dense contraction of
    the global operands."""
    da, db, dc = mat_a.dist, mat_b.dist, mat_c.dist
    ga = layout.unpad_global(layout.unpack(mat_a.data, da), da)
    gb = layout.unpad_global(layout.unpack(mat_b.data, db), db)
    gc = layout.unpad_global(layout.unpack(mat_c.data, dc), dc)
    ga = t.op_tile(_dense_structured_a(ga, structure, diag), opa)
    gb = t.op_tile(gb, opb)
    prod = (t.contract("...ab,...bc->...ac", gb, ga) if a_right
            else t.contract("...ab,...bc->...ac", ga, gb))
    out = _scalar(alpha, gc.dtype) * prod + _scalar(beta, gc.dtype) * gc
    return mat_c._inplace(layout.pack(layout.pad_global(out.to(gc.dtype), dc), dc))


def _run_summa(mat_a, mat_b, mat_c, opa, opb, alpha, beta, structure, diag, kt):
    g_a = _spmd.Geometry.of(mat_a.dist)
    g_b = _spmd.Geometry.of(mat_b.dist)
    g_c = _spmd.Geometry.of(mat_c.dist)
    if g_c.mt == 0 or g_c.nt == 0:
        return mat_c
    if mat_c.grid.grid_size.count() == 1:
        return _run_dense_local(mat_a, mat_b, mat_c, opa, opb, alpha, beta, structure, diag,
                                False)

    def body(a, b, c):
        _summa_left(a, b, c, g_a, g_b, g_c, opa, opb, alpha, beta, structure, diag, kt)

    coll.spmd(mat_c.grid, body, mat_a.data, mat_b.data, mat_c.data)
    return mat_c._inplace(mat_c.data)


def _run_summa_right(mat_a, mat_b, mat_c, opa, alpha, structure, diag, beta=0.0):
    g_a = _spmd.Geometry.of(mat_a.dist)
    g_b = _spmd.Geometry.of(mat_b.dist)
    g_c = _spmd.Geometry.of(mat_c.dist)
    if g_c.mt == 0 or g_c.nt == 0:
        return mat_c
    if mat_c.grid.grid_size.count() == 1:
        return _run_dense_local(mat_a, mat_b, mat_c, opa, t.NO_TRANS, alpha, beta, structure,
                                diag, True)

    def body(a, b, c):
        _summa_right(a, b, c, g_a, g_b, g_c, opa, alpha, beta, structure, diag, g_b.nt)

    coll.spmd(mat_c.grid, body, mat_a.data, mat_b.data, mat_c.data)
    return mat_c._inplace(mat_c.data)


def _check_mult_shapes(opa, opb, mat_a, mat_b, mat_c):
    am, an = mat_a.size
    if opa != t.NO_TRANS:
        am, an = an, am
    bm, bn = mat_b.size
    if opb != t.NO_TRANS:
        bm, bn = bn, bm
    if (am, bn) != tuple(mat_c.size) or an != bm:
        raise ValueError(f"gemm: op(A) {am}x{an} op(B) {bm}x{bn} C {tuple(mat_c.size)}")


def general_multiplication(opa: str, opb: str, alpha, mat_a, mat_b, beta,
                           mat_c) -> DistributedMatrix:
    """C := alpha op(A) op(B) + beta C, in place of ``mat_c``'s data;
    returns C."""
    g_a = _spmd.Geometry.of(mat_a.dist)
    kt = g_a.nt if opa == t.NO_TRANS else g_a.mt
    _check_mult_shapes(opa, opb, mat_a, mat_b, mat_c)
    return _run_summa(mat_a, mat_b, mat_c, opa, opb, alpha, beta, _FULL, t.NON_UNIT, kt)


def triangular_multiplication(side: str, uplo: str, op: str, diag: str, alpha, mat_a,
                              mat_b) -> DistributedMatrix:
    """alpha op(A) B (Left) or alpha B op(A) (Right), A triangular (only its
    ``uplo`` triangle is read); a new matrix, B is not modified."""
    structure = _LOWER_TRI if uplo == t.LOWER else _UPPER_TRI
    out = DistributedMatrix(mat_b.dist, mat_b.grid, torch.zeros_like(mat_b.data))
    if side == t.LEFT:
        kt = _spmd.Geometry.of(mat_a.dist).nt
        return _run_summa(mat_a, mat_b, out, op, t.NO_TRANS, alpha, 0.0, structure, diag, kt)
    return _run_summa_right(mat_a, mat_b, out, op, alpha, structure, diag)


def hermitian_multiplication(side: str, uplo: str, alpha, mat_a, mat_b, beta,
                             mat_c) -> DistributedMatrix:
    """C := alpha A B (Left) or alpha B A (Right) + beta C with A Hermitian,
    only its ``uplo`` triangle read; in place of ``mat_c``'s data, returns
    C."""
    structure = _HERM_LOWER if uplo == t.LOWER else _HERM_UPPER
    if side == t.LEFT:
        kt = _spmd.Geometry.of(mat_a.dist).nt
        return _run_summa(mat_a, mat_b, mat_c, t.NO_TRANS, t.NO_TRANS, alpha, beta, structure,
                          t.NON_UNIT, kt)
    return _run_summa_right(mat_a, mat_b, mat_c, t.NO_TRANS, alpha, structure, t.NON_UNIT,
                            beta=beta)
