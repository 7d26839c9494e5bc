"""Distributed tiled Cholesky factorization (counterpart of
``dlaf_tpu/algorithms/cholesky.py``).

Each panel step k factors the diagonal tile (hand-written potrf kernel,
``ops/potrf.py``), solves the column panel below it (``tile.trsm``, the
hand-written panel-TRSM kernel under ``tune.panel_trsm_pallas``),
broadcasts the panel and transposes it into a row panel
(``comm/collectives.py``), and applies the trailing update.  The JAX
package runs the loop as one jitted ``lax.fori_loop`` over a
``shard_map``-local tile stack; here it is an eager Python loop over the
local stack ``x[ltr, ltc, mb, nb]``, which the kernels update in place.

Two kernels, as in the JAX package: the bucketed kernel (default), whose
trailing update runs on a window that shrinks by segment, and the
lookahead kernel (``tune.cholesky_lookahead``), which factors panel k+1
before the bulk trailing update of step k.  Under 'xla' the lookahead bulk
update is a ``torch.einsum``; under ``tune.trailing_update_impl='fused'``
it is the fused tier of ``ops/trailing_update.py``: on the card, on a grid
larger than 1x1, the whole step is one launch per rank (B8,
``fused_step``) where the JAX package's gate takes it (tiles a multiple of
128), else the consume ring (B6) applies the bulk update as the row panel
lands, then the narrow update and the panel of step k+1 follow; on a 1x1
grid and on the CPU it is the transport plus one update (B3 on the card,
its plain version on the CPU), with the 'xla' tier's bits.

On a ``Pr x Pc`` grid the kernel body runs once per rank thread
(``comm/_ranks.py``), on that rank's view of the stacked tensor, and the
collectives meet the other ranks.  Under ``collectives_impl='pallas'`` with
a column axis > 1 the lookahead panel is the fused factor-and-send
(``ops/panel_exchange.fused_factor_bcast``, B7; its plain twin on the CPU).

The U path is the L path on the mirrored matrix, as in the JAX package:
the stored upper triangle is conjugate-transposed into lower storage,
factored, and the factor transposed back.  ``shift_recovery`` re-factors
``A + shift*I`` with an escalating shift.  Checkpointing raises
``NotImplementedError`` (ROADMAP.md §A, item 7).
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch import health, tune
from dlaf_tpu_torch.algorithms import _spmd
from dlaf_tpu_torch.algorithms._origin import origin_transparent
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm.grid import COL_AXIS, ROW_AXIS
from dlaf_tpu_torch.health import DistributionError, NotPositiveDefiniteError
from dlaf_tpu_torch.matrix import layout
from dlaf_tpu_torch.matrix import util as mutil
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.ops import panel_exchange as _px
from dlaf_tpu_torch.ops import potrf as _potrf
from dlaf_tpu_torch.ops import tile as t
from dlaf_tpu_torch.ops import trailing_update as _tu


def _diag_potrf(d):
    """Diagonal-tile Cholesky: the potrf kernel for real tiles under the JAX
    package's gate, ``tile.potrf`` (``torch.linalg.cholesky_ex``) otherwise.
    Unlike the JAX package there is no catch-all fallback: a kernel failure
    raises."""
    if _potrf.supported(d):
        return _potrf.potrf_tile(d)
    return t.potrf(d, lower=True)


def _fused_panel_bcast(d, xc, below, root: int):
    """Fused factor-and-send of the lookahead panel
    (``dlaf_tpu/algorithms/cholesky.py:87``): B7 composes the potrf and
    panel-TRSM bodies with the ring broadcast over 'c'.  It engages under
    the JAX package's gate, with "a TPU backend" read as "the 'pallas'
    tier": the tier is 'pallas', the column axis > 1 and
    ``fusion_supported``; it returns None otherwise (the unfused path, the
    same math).  On the card it launches B7, on the CPU B7's plain twin;
    a failure raises."""
    if (coll.collectives_trace_key() != "pallas" or coll.axis_size(COL_AXIS) <= 1
            or not _px.fusion_supported(d, xc)):
        return None
    return _px.fused_factor_bcast(d.contiguous(), xc.contiguous(), below, root, COL_AXIS)


def _fused_lookahead_step(x, cp, k: int, g: _spmd.Geometry, gi, gj):
    """The whole lookahead body of step k as one launch per rank (B8,
    ``ops/trailing_update.fused_step``; ``dlaf_tpu/algorithms/cholesky.py:
    128``): the consume update of panel k, the narrow update, the diagonal
    tile of step k+1 to every rank, its factor, the panel solve and the ring
    of panel k+1.  It engages under the JAX package's rule, with "a TPU"
    read as "the card": a CUDA tensor, a grid larger than 1x1 and
    ``fused_step_supported``, whatever the collectives tier; it returns
    None otherwise (the two-piece path, the same math)."""
    if x.device.type != "cuda" or g.pr * g.pc == 1 or not _tu.fused_step_supported(x, cp):
        return None
    taken, have = coll.transpose_panel_parts(cp, g.mt, g.ltc)
    k1 = k + 1
    params = (k1 % g.pc, k1 % g.pr, k1 // g.pc, k1 // g.pr, k1 // g.pc)
    return _tu.fused_step(x, taken, have, gj == k1, cp, gi > k1, params)


def _pivot_scan(d):
    """First non-positive pivot of the Hermitian tile ``d``: int32 0 when
    every pivot is positive, else the 1-based within-tile index of the first
    pivot that is <= 0 or NaN (LAPACK xPOTRF info semantics).

    The unblocked right-looking sweep of the JAX package's ``_pivot_scan``
    (its masked rank-1 updates restricted to the trailing block, where they
    are non-zero), with the same arithmetic.  Each pivot is left on the
    diagonal, which later steps do not touch, and the first failing one is
    read from there at the end: every pivot up to it is computed exactly as
    the JAX sweep computes it, and what follows a failure does not matter,
    so the JAX package's freezing of the trailing matrix and its per-step
    bookkeeping are not needed (five launches per step).  Stays on the
    device: no host synchronisation."""
    n = d.shape[-1]
    a = torch.tril(d) + torch.tril(d, -1).transpose(-1, -2).conj()
    for j in range(n - 1):
        inv = torch.sqrt(a[j, j].real).reciprocal()  # the JAX 1.0 / sqrt(dj)
        col = a[j + 1:, j] * inv.to(a.dtype)
        a[j + 1:, j + 1:] -= col[:, None] * col[None, :].conj()
    bad = ~(a.diagonal().real > 0)  # True for NaN pivots too
    first = bad.to(torch.int32).argmax().to(torch.int32) + 1
    return torch.where(bad.any(), first, torch.zeros_like(first))


def _update_info(info, bad, offset: int):
    """info <- offset + bad where info is still 0 and bad > 0."""
    return torch.where((info == 0) & (bad > 0), offset + bad, info).to(torch.int32)


def _first_failure(info):
    """The grid's info from each rank's.  Every rank scans only the
    diagonal tiles it owns, so the first failing pivot is the least
    non-zero info over the grid, which every rank gets (the JAX package's
    info is rank-replicated too: there every rank scans every tile).  The
    scan is thousands of eager launches per tile, and eight rank threads
    launching at once through one interpreter are several times slower
    than one thread making all of their launches (PERF.md, PR 4), so the
    port does not repeat it on every rank."""
    none = torch.iinfo(torch.int32).max
    v = torch.where(info > 0, info, none)
    v = coll.all_gather_axis(coll.all_gather_axis(v, COL_AXIS).amin(), ROW_AXIS).amin()
    return torch.where(v == none, 0, v).to(torch.int32)


def _chol_L_bucketed(x, g: _spmd.Geometry, want_info: bool):
    """Bucketed kernel: the trailing update runs on a window of the local
    tile stack whose size shrinks by segment (``_spmd.halving_segments``).
    Windows are over-approximate and clamped; masked panels make the
    overlap rows/cols no-ops."""
    myr, myc = coll.my_rank()
    dev = x.device
    info = torch.zeros((), dtype=torch.int32, device=dev) if want_info else None
    for k0, k1 in _spmd.halving_segments(g.mt):
        L = max(min(g.ltr, (g.mt - 1 - k0 + g.pr - 1) // g.pr + 1), 1)
        C = max(min(g.ltc, (g.mt - 1 - k0 + g.pc - 1) // g.pc + 1), 1)
        for k in range(k0, k1):
            kr, kc = k % g.pr, k % g.pc
            lkr, lkc = k // g.pr, k // g.pc
            d = _spmd.bcast_diag_tile(x, k, g, myr, myc)
            lkk = _diag_potrf(d)
            if want_info and myr == kr and myc == kc:
                info = _update_info(info, _pivot_scan(d), k * g.mb)
            # local window starts (first slot with gi >= k+1 / gj >= k+1),
            # clamped like the JAX windows
            rs = min(max((k + g.pr - myr) // g.pr, 0), max(g.ltr - L, 0))
            cs = min(max((k + g.pc - myc) // g.pc, 0), max(g.ltc - C, 0))
            gi_w = (rs + torch.arange(L, device=dev)) * g.pr + myr
            jv = (cs + torch.arange(C, device=dev)) * g.pc + myc
            xc = x[rs:rs + L, lkc]
            pan = t.trsm(t.RIGHT, t.LOWER, t.CONJ_TRANS, t.NON_UNIT, 1.0, lkk, xc)
            below = (gi_w > k)[:, None, None]
            cp = coll.bcast(torch.where(below, pan, torch.zeros_like(pan)), kc, COL_AXIS)
            rp = coll.transpose_panel_windowed(cp, jv, rs, g.mt)
            if myc == kc:
                x[rs:rs + L, lkc] = torch.where(below, pan, xc)
            if myr == kr and myc == kc:
                x[lkr, lkc] = lkk
            xs = x[rs:rs + L, cs:cs + C]  # a view: the update lands in x
            xs -= t.contract("iab,jcb->ijac", cp, rp.conj())
    return info


def _chol_L_lookahead(x, g: _spmd.Geometry, want_info: bool):
    """Lookahead kernel: each step k writes back panel k, applies the
    narrow update to column k+1, factors panel k+1, and applies the bulk
    trailing update (column k+1 excluded).  Under the fused tier the bulk
    update comes first, as in the JAX package (the reorder is exact: the
    bulk excludes column k+1), or the whole step is B8's one launch; the
    pivot scan stays on the owner of each diagonal tile."""
    myr, myc = coll.my_rank()
    dev = x.device
    gi = _spmd.local_row_tiles(g, myr, dev)
    gj = _spmd.local_col_tiles(g, myc, dev)
    fused_tier = tune.trailing_update_tier() == "fused"

    def compute_panel(k):
        d = _spmd.bcast_diag_tile(x, k, g, myr, myc)
        owner = myr == k % g.pr and myc == k % g.pc
        bad = _pivot_scan(d) if want_info and owner else None
        xc = _spmd.take_col(x, k // g.pc, g)
        fused = _fused_panel_bcast(d, xc, gi > k, k % g.pc)
        if fused is not None:
            return fused[0], fused[1], bad
        lkk = _diag_potrf(d)
        pan = t.trsm(t.RIGHT, t.LOWER, t.CONJ_TRANS, t.NON_UNIT, 1.0, lkk, xc)
        below = (gi > k)[:, None, None]
        cp = coll.bcast(torch.where(below, pan, torch.zeros_like(pan)), k % g.pc, COL_AXIS,
                        consumed=fused_tier)
        return lkk, cp, bad

    def write_back(k, lkk, cp):
        if myc != k % g.pc:
            return
        lkc = k // g.pc
        xc = _spmd.take_col(x, lkc, g)
        below = (gi > k)[:, None, None]
        new_col = torch.where((gi == k)[:, None, None], lkk[None],
                              torch.where(below, cp, xc))
        _spmd.put_col(x, new_col, lkc)

    info = torch.zeros((), dtype=torch.int32, device=dev) if want_info else None
    lkk, cp, bad = compute_panel(0)
    if bad is not None:
        info = _update_info(info, bad, 0)
    for k in range(g.mt - 1):
        write_back(k, lkk, cp)
        stepped = _fused_lookahead_step(x, cp, k, g, gi, gj) if fused_tier else None
        if stepped is not None:
            # the single-launch step: the pivot scan reads its broadcast
            # diagonal tile, on the tile's owner
            _, _, lkk, cp, d1 = stepped
            if want_info and myr == (k + 1) % g.pr and myc == (k + 1) % g.pc:
                info = _update_info(info, _pivot_scan(d1), (k + 1) * g.mb)
            continue
        suppress = (gj == k + 1)[:, None, None]
        if fused_tier:
            # the exchange-and-consume of the row panel, bulk update first
            # (column k+1 suppressed)
            taken, have = coll.transpose_panel_parts(cp, g.mt, g.ltc)
            x, rp = _tu.fused_transpose_update(x, cp, taken, have, gj == k + 1, ROW_AXIS)
        else:
            rp = coll.transpose_panel(cp, g.mt, g.ltc)
        # narrow update: column k+1 only, so its panel starts now
        l_next = (k + 1) // g.pc
        if myc == (k + 1) % g.pc:
            rp1 = _spmd.take_tile(rp, l_next)
            xc1 = _spmd.take_col(x, l_next, g)
            xc1 -= t.contract("iab,cb->iac", cp, rp1.conj())
        lkk1, cp1, bad1 = compute_panel(k + 1)
        if not fused_tier:
            rp_bulk = torch.where(suppress, torch.zeros_like(rp), rp)
            x -= t.contract("iab,jcb->ijac", cp, rp_bulk.conj())
        if bad1 is not None:
            info = _update_info(info, bad1, (k + 1) * g.mb)
        lkk, cp = lkk1, cp1
    write_back(g.mt - 1, lkk, cp)
    return info


def _factor_distributed(mat_a: DistributedMatrix, g: _spmd.Geometry, want_info: bool):
    """Run the distributed L kernel in place on ``mat_a.data``, once per
    rank (``coll.spmd``); returns the info (a device int32 scalar,
    identical on every rank) or None."""
    lookahead = tune.get_tune_parameters().cholesky_lookahead
    kern = _chol_L_lookahead if lookahead else _chol_L_bucketed

    def body(x):
        myr, myc = coll.my_rank()
        _spmd.pad_diag_identity(x, g, myr, myc)
        info = kern(x, g, want_info)
        _spmd.pad_diag_identity(x, g, myr, myc, remove=True)
        return _first_failure(info) if want_info else None

    return coll.spmd(mat_a.grid, body, mat_a.data)


def _cholesky_single_device(uplo: str, mat_a: DistributedMatrix) -> DistributedMatrix:
    """1x1-grid dense path (``backend='auto'``): one dense Cholesky of the
    whole matrix (``tile.potrf``), where the JAX package leaves the work to
    XLA's dense Cholesky; a matrix that is not positive definite gives NaN,
    as there.  The caller's other triangle is kept."""
    dist = mat_a.dist
    g_ = layout.unpad_global(layout.unpack(mat_a.data, dist), dist)
    if uplo == t.LOWER:
        out = t.potrf(g_, lower=True) + torch.triu(g_, 1)
    else:
        out = t.potrf(g_, lower=False) + torch.tril(g_, -1)
    return mat_a._inplace(layout.pack(layout.pad_global(out, dist), dist))


def _factor_with_recovery(mat_a: DistributedMatrix, g: _spmd.Geometry, max_shift_attempts: int):
    """Escalating diagonal-shift retry (``_factor_with_recovery``,
    ``dlaf_tpu/algorithms/cholesky.py:614``): factor A, then
    ``A + shift*I`` with ``shift = max(||A||_max, 1) * n * eps`` growing
    x100 an attempt, at most ``max_shift_attempts`` retries, each recorded
    as a health event.  Every attempt factors a fresh copy, so the caller's
    matrix survives until the result replaces it.  Returns ``(data, info,
    shift)`` with ``info`` the host int of the last attempt (each attempt
    synchronises: whether to retry depends on the device's info)."""

    def attempt(data):
        info = _factor_distributed(mat_a.like(data), g, True)
        return data, int(info)

    orig = mat_a.data
    data, info = attempt(orig.clone())
    if info == 0:
        return data, 0, 0.0
    # the norm of the stored tensor, both triangles and the padding, as the
    # JAX package takes it
    eps = float(torch.finfo(mat_a.dtype).eps)
    anorm = float(orig.abs().max())
    shift = max(anorm, 1.0) * max(mat_a.size.rows, 1) * eps
    eye = mutil.eye_like(mat_a).data
    for n_try in range(1, max_shift_attempts + 1):
        health.record("cholesky_shift_retry", attempt=n_try, shift=shift, info=info)
        # the shift rounded to the matrix's dtype, as np.dtype(...).type(shift)
        data, info = attempt(orig + torch.tensor(shift, dtype=mat_a.dtype, device=orig.device) * eye)
        if info == 0:
            health.record("cholesky_shift_recovered", attempt=n_try, shift=shift)
            return data, 0, shift
        if n_try < max_shift_attempts:
            shift *= 100.0
    return data, info, shift


@origin_transparent
def cholesky_factorization(
    uplo: str,
    mat_a: DistributedMatrix,
    backend: str = "auto",
    return_info: bool = False,
    raise_on_failure: bool = False,
    shift_recovery: bool = False,
    max_shift_attempts: int = 3,
    checkpoint_every: int = 0,
    checkpoint_path: str | None = None,
    resume_from: str | None = None,
):
    """Factor the Hermitian positive-definite ``mat_a`` in place: on return
    its ``uplo`` triangle holds the Cholesky factor.  Only the ``uplo``
    triangle is read; the other holds update residue (L) or is returned
    unchanged (U), as in LAPACK potrf and the JAX package.

    ``backend='auto'`` uses the dense ``torch.linalg.cholesky`` path on 1x1
    grids; 'distributed' forces the tiled kernel.  ``return_info=True``
    returns ``(factor, info)`` with ``info`` the LAPACK-style 1-based first
    failing pivot (0 on success) as a device int32 scalar;
    ``raise_on_failure=True`` raises :class:`NotPositiveDefiniteError`.
    Info requests route 1x1 grids through the distributed kernel, as in
    the JAX package: the dense path cannot name the pivot.

    ``shift_recovery=True`` re-factors ``A + shift*I`` on failure, the
    shift growing x100 for at most ``max_shift_attempts`` retries (health
    events ``cholesky_shift_retry`` / ``cholesky_shift_recovered``); the
    info (then a host int) and the exception report the last attempt, the
    exception with the last shift.

    'U' runs the L path on ``transpose(triu(A), conj=True)`` and transposes
    the factor back, keeping the caller's strict lower triangle: two
    whole-matrix copies on the device beside the matrix (1 GiB each at
    N = 16384 in float32).  It passes ``backend`` on to the L path."""
    want_info = return_info or raise_on_failure or shift_recovery
    ckpt = bool(checkpoint_every) or checkpoint_path is not None or resume_from is not None
    if ckpt and shift_recovery:
        raise DistributionError(
            "cholesky: checkpointing and shift_recovery are mutually exclusive "
            "(recovery restarts from the original matrix, not a checkpoint)"
        )
    if ckpt:
        raise NotImplementedError(
            "cholesky_factorization: checkpoint_every, checkpoint_path and resume_from "
            "are not ported yet (ROADMAP.md §A, item 7: robustness, observability, plan)"
        )
    if uplo not in (t.LOWER, t.UPPER):
        raise DistributionError(f"bad uplo {uplo}")
    if mat_a.size.rows != mat_a.size.cols:
        raise DistributionError("cholesky: matrix must be square")
    if mat_a.block_size.rows != mat_a.block_size.cols:
        raise DistributionError("cholesky: tiles must be square")
    g = _spmd.Geometry.of(mat_a.dist)
    if g.mt == 0:
        return (mat_a, 0) if return_info else mat_a
    if backend == "auto" and mat_a.grid.grid_size.count() == 1 and not want_info:
        return _cholesky_single_device(uplo, mat_a)
    if backend not in ("auto", "distributed"):
        raise ValueError(f"cholesky: unknown backend {backend!r}")
    if uplo == t.UPPER:
        # A = U^H U with U = L^H: the mirrored matrix has the same leading
        # minors, so the L path's info carries over
        low = mutil.transpose(mutil.extract_triangle(mat_a, "U"), conj=True)
        res = cholesky_factorization(t.LOWER, low, backend=backend, return_info=want_info,
                                     raise_on_failure=raise_on_failure,
                                     shift_recovery=shift_recovery,
                                     max_shift_attempts=max_shift_attempts)
        fac, info = res if want_info else (res, None)
        u = mutil.transpose(mutil.extract_triangle(fac, "L"), conj=True)
        del low, fac
        out = mat_a._inplace(mutil.extract_triangle(mat_a, "L", k=-1).data
                             + mutil.extract_triangle(u, "U").data)
        return (out, info) if return_info else out
    shift = 0.0
    if shift_recovery:
        data, info, shift = _factor_with_recovery(mat_a, g, max_shift_attempts)
        mat_a._inplace(data)
    else:
        info = _factor_distributed(mat_a, g, want_info)
    out = mat_a._inplace(mat_a.data)
    if raise_on_failure and int(info) > 0:
        raise NotPositiveDefiniteError(int(info), shift=shift)
    return (out, info) if return_info else out
