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

``general_sub_multiplication`` runs the same loop over windows
(``matrix/ref.py``'s ``MatrixRef``) of the three parents: tile-aligned
windows in place, on the parents' stacks, any other window through
``matrix/window.py``'s copies.  Its A and B windows may lie in C's parent.
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch.algorithms import _spmd
from dlaf_tpu_torch.algorithms._origin import origin_transparent
from dlaf_tpu_torch.comm import _ranks
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


@origin_transparent
def general_multiplication(opa: str, opb: str, alpha, mat_a, mat_b, beta,
                           mat_c) -> DistributedMatrix:
    """C := alpha op(A) op(B) + beta C, in place of ``mat_c``'s data;
    returns C."""
    g_a = _spmd.Geometry.of(mat_a.dist)
    kt = g_a.nt if opa == t.NO_TRANS else g_a.mt
    _check_mult_shapes(opa, opb, mat_a, mat_b, mat_c)
    return _run_summa(mat_a, mat_b, mat_c, opa, opb, alpha, beta, _FULL, t.NON_UNIT, kt)


@origin_transparent
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


@origin_transparent
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


def _window_panel(panel, t0: int, rel, valid, p: int, my: int, ext: int, owned: bool, axis):
    """Tiles ``t0 + rel`` of a broadcast panel ``[lt, mb, nb]`` whose
    global tile ``g`` lies at slot ``g // p`` of position ``g % p`` on
    ``axis``, for this rank's window slots ``rel``; zero where not
    ``valid``.  ``owned``: the window's tiles share this rank's position
    (the windows' origins agree mod ``p``) and are taken by index; else
    the ``lg``-slot window covering tiles ``[t0, t0 + ext)`` is gathered
    over ``axis`` first, as ``_sub_gemm_kernel`` does."""
    lt = panel.shape[0]
    gt = t0 + rel
    if owned:
        got = panel[torch.clamp(gt // p, 0, lt - 1)]
    else:
        lg = min(lt, -(-ext // p) + 1)
        starts = [min(max((t0 + p - 1 - r) // p, 0), lt - lg) for r in range(p)]
        gat = coll.all_gather_axis(panel[starts[my]:starts[my] + lg], axis)
        flat = gat.reshape(p * lg, *panel.shape[1:])
        src = gt % p
        first = torch.tensor(starts, device=panel.device)[src]
        got = flat[torch.clamp(src * lg + gt // p - first, 0, p * lg - 1)]
    return _masked(valid, got)


def _sub_gemm(a, b, c, g_a, g_b, g_c, origins, Ri, Rj, Rk, L, Cw, alpha, beta, aliased):
    """``_sub_gemm_kernel`` (:382) on this rank's stacks: C's window :=
    alpha A's window B's window + beta C's window, every window a tile
    range of its parent's stack, in place of ``c``'s window tiles; the
    tiles outside it are not touched.  The products accumulate apart from
    C, whose window is written once, after the loop."""
    ai0, ak0, bk0, bj0, ci0, cj0 = origins
    myr, myc = coll.my_rank()
    pr, pc = g_c.pr, g_c.pc
    dev = c.device
    # C's window: from the first local slot with global tile >= its origin,
    # clipped so that the L x Cw slots fit (tiles outside it are masked)
    rs = min(max((ci0 + pr - 1 - myr) // pr, 0), max(g_c.ltr - L, 0))
    cs = min(max((cj0 + pc - 1 - myc) // pc, 0), max(g_c.ltc - Cw, 0))
    rel_i = (rs + torch.arange(L, device=dev)) * pr + myr - ci0
    rel_j = (cs + torch.arange(Cw, device=dev)) * pc + myc - cj0
    valid_i = (rel_i >= 0) & (rel_i < Ri)
    valid_j = (rel_j >= 0) & (rel_j < Rj)
    owned_r = (ai0 - ci0) % pr == 0
    owned_c = (bj0 - cj0) % pc == 0
    acc = torch.zeros((L, Cw, g_c.mb, g_c.nb), dtype=c.dtype, device=dev)
    for k in range(Rk):
        gka, gkb = ak0 + k, bk0 + k
        ac = coll.bcast(_spmd.take_col(a, gka // pc, g_a), gka % pc, COL_AXIS)
        ap = _window_panel(ac, ai0, rel_i, valid_i, pr, myr, Ri, owned_r, ROW_AXIS)
        br = coll.bcast(_spmd.take_row(b, gkb // pr, g_b), gkb % pr, ROW_AXIS)
        bp = _window_panel(br, bj0, rel_j, valid_j, pc, myc, Rj, owned_c, COL_AXIS)
        acc += t.contract("iab,jbc->ijac", ap, bp)
    if aliased:
        # A or B lies in C's parent: no rank writes its window before every
        # rank has made its last read of the parent on the host.  Another
        # rank's tiles reach this one only through the collectives above,
        # which copy them (or, on the ring, finish after every pull).
        _ranks.rendezvous(None, "general_sub_multiplication write-back")
    cw = c[rs:rs + L, cs:cs + Cw]
    valid = (valid_i[:, None] & valid_j[None, :])[:, :, None, None]
    c[rs:rs + L, cs:cs + Cw] = torch.where(
        valid, _scalar(beta, c.dtype) * cw + _scalar(alpha, c.dtype) * acc, cw)


def _sub_gemm_local(alpha, a_ref, b_ref, beta, c_ref) -> DistributedMatrix:
    """1x1 grid (``_sub_gemm_local``, :558): the three windows copied out
    by index, one dense product, C's window written back."""
    from dlaf_tpu_torch.matrix.window import window_global, window_put

    aw = window_global(a_ref.parent, tuple(a_ref.origin), tuple(a_ref.size))
    bw = window_global(b_ref.parent, tuple(b_ref.origin), tuple(b_ref.size))
    mat_c = c_ref.parent
    cw = window_global(mat_c, tuple(c_ref.origin), tuple(c_ref.size))
    new = (_scalar(alpha, cw.dtype) * t.contract("...ab,...bc->...ac", aw, bw)
           + _scalar(beta, cw.dtype) * cw)
    return window_put(mat_c, tuple(c_ref.origin), new)


def general_sub_multiplication(alpha, a_ref, b_ref, beta, c_ref) -> DistributedMatrix:
    """C's window := alpha A's window B's window + beta C's window
    (``general_sub_multiplication``, :476), each operand a
    :class:`~dlaf_tpu_torch.matrix.ref.MatrixRef` or a whole
    :class:`DistributedMatrix`; the tiles of C outside its window keep
    their values.  In place of C's parent, which is returned.  Tile-aligned
    windows of origin-(0, 0) parents run the windowed SUMMA on the parents'
    stacks; any other window is copied out (``window_extract``),
    multiplied (``general_multiplication``) and written back
    (``window_update``)."""
    from dlaf_tpu_torch.matrix.ref import as_ref
    from dlaf_tpu_torch.matrix.window import window_extract, window_update

    a_ref, b_ref, c_ref = as_ref(a_ref), as_ref(b_ref), as_ref(c_ref)
    mb, nb = c_ref.block_size
    for r in (a_ref, b_ref):
        if tuple(r.block_size) != (mb, nb):
            raise ValueError("general_sub_multiplication: block sizes must match")
    if any(tuple(r.grid.grid_size) != tuple(c_ref.grid.grid_size)
           or r.grid.device != c_ref.grid.device for r in (a_ref, b_ref)):
        raise ValueError("general_sub_multiplication: all operands on one grid")
    M, K = a_ref.size
    K2, N = b_ref.size
    if (M, N) != tuple(c_ref.size) or K != K2:
        raise ValueError(f"sub-gemm: A {M}x{K} B {K2}x{N} C {tuple(c_ref.size)}")
    mat_a, mat_b, mat_c = a_ref.parent, b_ref.parent, c_ref.parent
    Ri, Rj = c_ref.nr_tiles
    Rk = a_ref.nr_tiles.cols
    if Ri == 0 or Rj == 0:
        return mat_c
    if mat_c.grid.size == 1:
        return _sub_gemm_local(alpha, a_ref, b_ref, beta, c_ref)
    at_origin = all(tuple(m.dist.source_rank) == (0, 0) for m in (mat_a, mat_b, mat_c))
    if not (at_origin and a_ref.aligned and b_ref.aligned and c_ref.aligned):
        wa = window_extract(mat_a, tuple(a_ref.origin), tuple(a_ref.size))
        wb = window_extract(mat_b, tuple(b_ref.origin), tuple(b_ref.size))
        wc = window_extract(mat_c, tuple(c_ref.origin), tuple(c_ref.size))
        out = general_multiplication(t.NO_TRANS, t.NO_TRANS, alpha, wa, wb, beta, wc)
        return window_update(mat_c, tuple(c_ref.origin), out)
    g_a = _spmd.Geometry.of(mat_a.dist)
    g_b = _spmd.Geometry.of(mat_b.dist)
    g_c = _spmd.Geometry.of(mat_c.dist)
    L = min(g_c.ltr, -(-Ri // g_c.pr))
    Cw = min(g_c.ltc, -(-Rj // g_c.pc))
    origins = (a_ref.tile_origin.row, a_ref.tile_origin.col,
               b_ref.tile_origin.row, b_ref.tile_origin.col,
               c_ref.tile_origin.row, c_ref.tile_origin.col)
    aliased = mat_a.data is mat_c.data or mat_b.data is mat_c.data

    def body(a, b, c):
        _sub_gemm(a, b, c, g_a, g_b, g_c, origins, Ri, Rj, Rk, L, Cw, alpha, beta, aliased)

    coll.spmd(mat_c.grid, body, mat_a.data, mat_b.data, mat_c.data)
    return mat_c._inplace(mat_c.data)
