"""Mixed-precision Hermitian eigensolver: the eigensolver pipeline in low
precision, then Ogita-Aishima refinement to the target precision
(counterpart of ``dlaf_tpu/algorithms/eig_refine.py``).

One sweep of :func:`refine_eigenpairs`, on the distributed products of
``algorithms/multiplication.py`` in the target precision:

    G = X^H X            (Gram)
    S = X^H (A X)        (Rayleigh; A X is one HEMM)
    lam_i = S_ii / G_ii  (refined Rayleigh quotients)
    E_ij  = (S_ij - lam_j G_ij) / (lam_j - lam_i)   (i != j, gap large)
    E_ij  = (I - G)_ij / 2                          (diagonal, tiny gap)
    X <- X + X E

Runs of eigenvalues closer than the gap floor are clusters: their k x k
blocks of S and G are copied out (``window_extract``), the generalized
problem is solved on the host (``scipy.linalg.eigh``), and E's cluster
columns are rewritten (``window_update``) so that the one update product
applies the rotation; unlike the JAX package, which skips runs longer
than 512, every run is rotated.  The sweeps converge when ``||I -
G||_max`` reaches ``50 n eps``.  :func:`refine_partial_eigenpairs`
refines a window of k eigenpairs with O(n^2 k) work a sweep: a
Rayleigh-Ritz rotation in the window, then one step of inverse iteration
preconditioned by the whole low-precision eigenbasis, and a Cholesky QR
(``_cholqr``: a Cholesky of the k x k Gram matrix and a Right triangular
solve).
:func:`hermitian_eigensolver_mixed` runs the low pipeline
(``hermitian_eigensolver`` of the matrix cast down) and takes the full
refinement for the whole spectrum and for windows wider than
``max(WIDE_WINDOW_MIN, n / 2)``, the partial refinement for the others.

The elementwise passes (``_refine_coeffs``, ``_ortho_err``, ``_diags``,
``_col_scale_sub``, ``_pair_scale``) are plain torch over the stacked
layout's global element indices, as the JAX package's are jitted jnp.
The port's float32 products are full float32 (``tune.matmul_precision``),
and its low pipeline has real dtypes only: complex matrices raise
(ROADMAP.md §A, item 5).  Stage clocks (``common.stagetimer``):
``eig_refine`` and ``eig_refine/sweep<i>``, ``eig_refine/partial`` and
``eig_refine/partial/sweep<i>``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dlaf_tpu_torch import health, tune
from dlaf_tpu_torch.algorithms._origin import origin_transparent
from dlaf_tpu_torch.algorithms.multiplication import (
    general_multiplication,
    hermitian_multiplication,
)
from dlaf_tpu_torch.algorithms.refine import convergence_floor, max_abs
from dlaf_tpu_torch.common import stagetimer as st
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.matrix.util import _global_element_grids
from dlaf_tpu_torch.ops import tile as t

# windows wider than max(WIDE_WINDOW_MIN, n/2) take the full refinement and
# a slice (the partial route's k x k host Rayleigh-Ritz is O(k^3) a sweep);
# module-level so that tests can move the route at test sizes
WIDE_WINDOW_MIN = 512


@dataclass
class EigRefineInfo:
    iters: int  # refinement sweeps performed
    ortho_error: float  # final ||I - X^H X||_max (full route; inf on the partial one)
    converged: bool  # the driving metric <= 50 n eps(target)
    # final scaled residual max|A X - X diag(theta)| / max|w|: the partial
    # route's metric (it orthonormalizes by Cholesky QR each sweep); inf on
    # the full route
    residual: float = np.inf


def _np_dtype(dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _real_np(dtype) -> np.dtype:
    return np.finfo(_np_dtype(dtype).type(0).real.dtype).dtype


def _check_real(what: str, dtype) -> None:
    if dtype.is_complex:
        raise NotImplementedError(
            f"{what}: complex dtypes are not ported yet (ROADMAP.md §A, item 5: the rest "
            "of the eigensolver)")


def _vec_at(vec, idx):
    """``vec[clip(idx)]`` in ``vec``'s dtype: a replicated vector read at
    global element indices."""
    return vec[torch.clamp(idx, 0, vec.shape[0] - 1)]


def _refine_coeffs(s_data, g_data, lam, dist, gap_thresh: float):
    """E from S, G and the refined eigenvalues ``lam`` (padded, length >=
    n, on the device), elementwise on the stacked layout (:75)."""
    gi, gj = _global_element_grids(dist, s_data.device)
    n = dist.size.cols
    inb = (gi < n) & (gj < n)
    lam_i = _vec_at(lam, gi).to(s_data.dtype)
    lam_j = _vec_at(lam, gj).to(s_data.dtype)
    eye = (gi == gj).to(s_data.dtype)
    zero = torch.zeros((), dtype=s_data.dtype, device=s_data.device)
    r_data = torch.where(inb, eye - g_data, zero)  # R = I - G
    gap = lam_j - lam_i
    safe = gap.abs() > gap_thresh * (lam_i.abs() + lam_j.abs() + 1)
    e_sep = (s_data - lam_j * g_data) / torch.where(safe, gap, torch.ones_like(gap))
    e = torch.where(inb & safe & (gi != gj), e_sep, r_data / 2)
    return torch.where(inb, e, zero)


def _ortho_err(g_data, dist) -> float:
    """``||I - G||_max``, NaN if any in-bounds element is NaN (:96)."""
    gi, gj = _global_element_grids(dist, g_data.device)
    n = dist.size.cols
    inb = (gi < n) & (gj < n)
    eye = (gi == gj).to(g_data.dtype)
    r = torch.where(inb, (eye - g_data).abs(), torch.zeros((), dtype=g_data.dtype,
                                                           device=g_data.device))
    if torch.isnan(r).any():
        return float("nan")
    return float(r.max())


def _diags(data, dist):
    """The padded diagonal of a square stacked matrix, length ``Pr * ltr *
    mb``, zero past n (:109): an index copy of the diagonal elements from
    their owners."""
    pr, pc = dist.grid_size
    ltr = dist.local_slots.rows
    mb, nb = dist.block_size
    sr, sc = dist.source_rank
    n = dist.size.rows
    out = torch.zeros(pr * ltr * mb, dtype=data.dtype, device=data.device)
    i = torch.arange(n, device=data.device)
    ti, tj = i // mb, i // nb
    out[:n] = data[(ti + sr) % pr, (tj + sc) % pc, ti // pr, tj // pc, i % mb, i % nb]
    return out


def _rayleigh(s, g, rdt):
    """``S_ii / G_ii`` (``G_ii`` 0 read as 1), padded, real, on the device."""
    s_d, g_d = _diags(s.data, s.dist), _diags(g.data, g.dist)
    lam = s_d / torch.where(g_d == 0, torch.ones_like(g_d), g_d)
    return lam.real.to(rdt)


def _clusters(lam: np.ndarray, gap_floor: float, max_size: int):
    """Runs of eigenvalues closer than the gap floor (:122): the pair test
    of ``_refine_coeffs``'s ``safe`` mask on the sorted values, mapped back
    to column positions; a run whose columns are not contiguous, or longer
    than ``max_size``, is skipped (its pairs keep the R/2 entries)."""
    out, i = [], 0
    n = lam.shape[0]
    order = np.argsort(lam, kind="stable")
    ls = lam[order]
    while i < n:
        j = i
        while j + 1 < n and abs(ls[j + 1] - ls[j]) <= gap_floor * (
                abs(ls[j + 1]) + abs(ls[j]) + 1):
            j += 1
        if j > i and (j - i + 1) <= max_size:
            idx = np.sort(order[i:j + 1])
            if idx[-1] - idx[0] == idx.size - 1:  # contiguous column window
                out.append((int(idx[0]), int(idx[-1]) + 1))
        i = j + 1
    return out


def _rotate_clusters(s, g_mat, e, clusters, dtype):
    """Rayleigh-Ritz in each cluster (:150): the k x k problem S_c Y = G_c
    Y diag(theta) solved on the host, and E's cluster columns rewritten so
    that the caller's X + X E applies (I + E_off) blockdiag(Y): E[:, c] <-
    E_off[:, c] Y + embed(Y) - I[:, c].  Returns E."""
    import scipy.linalg as sla

    from dlaf_tpu_torch.matrix.window import window_extract, window_update

    n = e.size.rows
    npdt = _np_dtype(dtype)
    for i0, i1 in clusters:
        k = i1 - i0
        sc = window_extract(s, (i0, i0), (k, k)).to_global()
        gc = window_extract(g_mat, (i0, i0), (k, k)).to_global()
        sc = (sc + sc.conj().T) / 2
        gc = (gc + gc.conj().T) / 2
        try:
            _theta, y = sla.eigh(sc, gc)
        except np.linalg.LinAlgError:
            # the Gram block is not numerically positive definite: keep the
            # R/2 entries already in E
            continue
        cols = window_extract(e, (0, i0), (n, k)).to_global()
        cols[i0:i1, :] = 0  # the R/2 block entries the rotation supersedes
        newcols = cols @ y
        newcols[i0:i1, :] += y - np.eye(k)
        blk = DistributedMatrix.from_global(e.grid, newcols.astype(npdt), tuple(e.dist.block_size))
        e = window_update(e, (0, i0), blk)
    return e


def _target_precision(target):
    return tune.matmul_precision("float32" if target == torch.float32 else "highest")


@origin_transparent
def refine_eigenpairs(
    uplo: str,
    mat_a: DistributedMatrix,
    evecs: DistributedMatrix,
    max_iters: int = 3,
    gap_floor: float | None = None,
    raise_on_failure: bool = False,
):
    """Ogita-Aishima refinement of the approximate eigenvectors ``evecs``
    (all n of them) of the Hermitian ``mat_a`` (its ``uplo`` triangle) in
    ``mat_a``'s precision.  Returns ``(eigenvalues, eigenvectors, info)``;
    ``evecs`` is consumed.  Non-convergence within ``max_iters`` sweeps is
    recorded (``health.record``); ``raise_on_failure=True`` raises
    :class:`~dlaf_tpu_torch.health.ConvergenceError` carrying the
    :class:`EigRefineInfo`."""
    target = mat_a.dtype
    _check_real("refine_eigenpairs", target)
    n = mat_a.size.rows
    if evecs.size.cols != n or evecs.size.rows != n:
        raise health.DistributionError("refine_eigenpairs needs the full square eigenvector matrix")
    rdt = _real_np(target)
    eps = np.finfo(rdt).eps
    if gap_floor is None:
        gap_floor = np.sqrt(n) * eps * 100
    x = evecs if evecs.dtype == target else evecs.astype(target)
    info = EigRefineInfo(0, np.inf, False)
    lam_host = None
    dev = x.data.device
    bs = tuple(x.dist.block_size)

    def zeros():
        return DistributedMatrix.zeros(x.grid, (n, n), bs, target)
    with st.stage("eig_refine", dev), _target_precision(target):
        for it in range(max_iters + 1):
            with st.stage(f"eig_refine/sweep{it}", dev):
                ax = hermitian_multiplication(t.LEFT, uplo, 1.0, mat_a, x, 0.0, zeros())
                s = general_multiplication(t.CONJ_TRANS, t.NO_TRANS, 1.0, x, ax, 0.0, zeros())
                del ax
                g = general_multiplication(t.CONJ_TRANS, t.NO_TRANS, 1.0, x, x, 0.0, zeros())
                lam = _rayleigh(s, g, _torch_real(rdt))
                info.iters = it
                info.ortho_error = _ortho_err(g.data, g.dist)
                lam_host = lam.cpu().numpy()[:n]
                # the Gram matrix itself carries ~n eps of rounding: the floor
                # is 50 n eps, not sqrt(n) eps
                if info.ortho_error <= convergence_floor(n, target):
                    info.converged = True
                    break
                if it == max_iters or not np.isfinite(info.ortho_error):
                    break
                # pairs whose gap is below the current accuracy cannot use the
                # separated formula: their quotients carry errors of that order
                thresh = max(float(gap_floor), min(10.0 * info.ortho_error, 1e-2))
                e = s.like(_refine_coeffs(s.data, g.data, lam, s.dist, thresh))
                # every contiguous run is rotated, whatever its size: the JAX
                # package skips runs longer than 512 (min(n, 512)), and a
                # skipped run keeps only the R/2 entries, which at N = 8192
                # on a D&C float32 start let the sweeps diverge (PERF.md)
                cl = _clusters(lam_host, thresh, max_size=n)
                if cl:
                    e = _rotate_clusters(s, g, e, cl, target)
                del s, g
                xe = general_multiplication(t.NO_TRANS, t.NO_TRANS, 1.0, x, e, 0.0, zeros())
                x = x.like(x.data + xe.data)
                del xe, e
    order = np.argsort(lam_host, kind="stable")
    if not np.array_equal(order, np.arange(n)):
        from dlaf_tpu_torch.algorithms.permutations import permute

        x = permute(x, order, "cols")
        lam_host = lam_host[order]
    if not info.converged:
        health.record("eig_refine_not_converged", iters=info.iters, ortho_error=info.ortho_error)
        if raise_on_failure:
            raise health.ConvergenceError(
                f"eigenpair refinement did not converge in {info.iters} sweeps "
                f"(ortho error {info.ortho_error:.3e})", info=info)
    return lam_host, x, info


def _torch_real(rdt: np.dtype) -> torch.dtype:
    return torch.float32 if rdt == np.float32 else torch.float64


def _col_scale_sub(ax_data, x_data, theta, dist):
    """R = A X - X diag(theta) on the stacked layout, ``theta`` indexed by
    global column (:299)."""
    gi, gj = _global_element_grids(dist, x_data.device)
    m, k = dist.size
    inb = (gi < m) & (gj < k)
    th = _vec_at(theta, gj).to(x_data.dtype)
    return torch.where(inb, ax_data - x_data * th,
                       torch.zeros((), dtype=x_data.dtype, device=x_data.device))


def _pair_scale(c_data, w, theta, tau: float, dist):
    """C'[i, j] = C[i, j] / (w_i - theta_j), 0 where the denominator is at
    most ``tau`` (:310)."""
    gi, gj = _global_element_grids(dist, c_data.device)
    nn, k = dist.size
    inb = (gi < nn) & (gj < k)
    denom = (_vec_at(w, gi) - _vec_at(theta, gj)).to(c_data.dtype)
    safe = denom.abs() > tau
    return torch.where(inb & safe, c_data / torch.where(safe, denom, torch.ones_like(denom)),
                       torch.zeros((), dtype=c_data.dtype, device=c_data.device))


def _cholqr(x: DistributedMatrix) -> DistributedMatrix:
    """Orthonormal columns by Cholesky QR (:325): G = X^H X, X <- X L^-H, a
    k x k distributed Cholesky and a Right triangular solve."""
    from dlaf_tpu_torch.algorithms.cholesky import cholesky_factorization
    from dlaf_tpu_torch.algorithms.triangular_solver import triangular_solver

    k = x.size.cols
    g = general_multiplication(t.CONJ_TRANS, t.NO_TRANS, 1.0, x, x, 0.0,
                               DistributedMatrix.zeros(x.grid, (k, k), tuple(x.dist.block_size),
                                                       x.dtype))
    ell = cholesky_factorization("L", g)
    return triangular_solver(t.RIGHT, t.LOWER, t.CONJ_TRANS, t.NON_UNIT, 1.0, ell, x)


@origin_transparent
def refine_partial_eigenpairs(
    uplo: str,
    mat_a: DistributedMatrix,
    v_lo: DistributedMatrix,
    w_lo: np.ndarray,
    spectrum: tuple[int, int],
    max_iters: int = 3,
    raise_on_failure: bool = False,
):
    """Refine the ``spectrum=(il, iu)`` window of a low-precision
    eigendecomposition (``v_lo`` the whole n x n basis, ``w_lo`` all n
    eigenvalues ascending) to ``mat_a``'s precision, with O(n^2 k) work a
    sweep (:343).  Each sweep: A X, the k x k Rayleigh-Ritz on the host
    and its rotation of X and A X, the residual R = A X - X diag(theta);
    then C = V_lo^H R, C_ij / (w_i - theta_j) masked where the gap is
    within 10 eps_lo max|w|, X <- cholqr(X - V_lo C).  The two projection
    products run in the low precision while the residual contracts by
    more than 50x a sweep, and in the target precision after.  Returns
    ``(w[k], X[n x k], info)``."""
    import scipy.linalg as sla

    from dlaf_tpu_torch.matrix.util import sub_matrix

    target, low = mat_a.dtype, v_lo.dtype
    _check_real("refine_partial_eigenpairs", target)
    il, iu = spectrum
    n = mat_a.size.rows
    k = iu - il + 1
    rdt = _real_np(target)
    eps_lo = np.finfo(_real_np(low)).eps
    if not (0 <= il <= iu < n):
        raise health.DistributionError(f"spectrum {spectrum} outside [0, {n})")
    if v_lo.size.rows != n or v_lo.size.cols != n or w_lo.shape[0] != n:
        raise health.DistributionError("refine_partial_eigenpairs needs the full low basis")
    scale = float(np.max(np.abs(w_lo))) + float(np.finfo(np.float32).tiny)
    dev = v_lo.data.device
    w_dev = torch.as_tensor(np.asarray(w_lo, _real_np(low)), device=dev)
    x = sub_matrix(v_lo, (0, il), (n, k)).astype(target)
    bs = tuple(x.dist.block_size)
    info = EigRefineInfo(0, np.inf, False)
    theta = np.asarray(w_lo[il:iu + 1]).astype(rdt)
    # the low projections' rounding sets a residual floor of a few hundred
    # n eps: once the cheap sweeps stall above the threshold, the two
    # projection products escalate to the target precision
    v_hi = None
    use_hi = target == low  # a same-precision call has nothing cheaper
    prev_res = np.inf
    npdt = _np_dtype(target)
    with st.stage("eig_refine/partial", dev), _target_precision(target):
        for it in range(max_iters + 1):
            with st.stage(f"eig_refine/partial/sweep{it}", dev):
                ax = hermitian_multiplication(t.LEFT, uplo, 1.0, mat_a, x, 0.0,
                                              DistributedMatrix.zeros(x.grid, (n, k), bs, target))
                s_kk = general_multiplication(t.CONJ_TRANS, t.NO_TRANS, 1.0, x, ax, 0.0,
                                              DistributedMatrix.zeros(x.grid, (k, k), bs, target))
                g_kk = general_multiplication(t.CONJ_TRANS, t.NO_TRANS, 1.0, x, x, 0.0,
                                              DistributedMatrix.zeros(x.grid, (k, k), bs, target))
                # the whole in-window Rayleigh-Ritz every sweep: it resolves
                # the in-span part in the target precision, and the
                # preconditioner below touches only the out-of-span error
                sc = s_kk.to_global()
                gc = g_kk.to_global()
                sc = (sc + sc.conj().T) / 2
                gc = (gc + gc.conj().T) / 2
                try:
                    theta_f, y = sla.eigh(sc, gc)
                except np.linalg.LinAlgError:
                    # degenerate Gram: keep the last iterate, with theta this
                    # x's Rayleigh quotients, ascending
                    theta = _rayleigh(s_kk, g_kk, _torch_real(rdt)).cpu().numpy()[:k].astype(rdt)
                    order = np.argsort(theta, kind="stable")
                    if not np.array_equal(order, np.arange(k)):
                        from dlaf_tpu_torch.algorithms.permutations import permute

                        x = permute(x, order, "cols")
                        theta = theta[order]
                    break
                theta = theta_f.astype(rdt)
                y_mat = DistributedMatrix.from_global(x.grid, y.astype(npdt), bs)
                x = general_multiplication(t.NO_TRANS, t.NO_TRANS, 1.0, x, y_mat, 0.0,
                                           DistributedMatrix.zeros(x.grid, (n, k), bs, target))
                # rotate A X by the same Y instead of a new n^2 k product
                ax = general_multiplication(t.NO_TRANS, t.NO_TRANS, 1.0, ax, y_mat, 0.0,
                                            DistributedMatrix.zeros(x.grid, (n, k), bs, target))
                theta_dev = torch.as_tensor(theta, device=dev)
                r = ax.like(_col_scale_sub(ax.data, x.data, theta_dev, ax.dist))
                del ax
                res = max_abs(r.data, r.dist) / scale
                info.iters = it
                info.residual = res  # ortho_error stays inf: cholqr re-orthonormalizes
                if res <= convergence_floor(n, target):
                    info.converged = True
                    break
                if it == max_iters or not np.isfinite(res):
                    break
                if not use_hi and res > 0.02 * prev_res:
                    use_hi = True  # stalled: the low projections' noise dominates
                prev_res = res
                if use_hi:
                    if v_hi is None:
                        v_hi = v_lo if low == target else v_lo.astype(target)
                    basis, rproj, pdt = v_hi, r, target
                else:
                    basis, rproj, pdt = v_lo, r.astype(low), low
                c = general_multiplication(t.CONJ_TRANS, t.NO_TRANS, 1.0, basis, rproj, 0.0,
                                           DistributedMatrix.zeros(x.grid, (n, k), bs, pdt))
                del r, rproj
                # directions within ~10 eps_lo of a Ritz value are beyond the
                # low basis: masked (the Rayleigh-Ritz step handles them)
                tau = 10.0 * eps_lo * scale
                rw = _torch_real(_real_np(pdt))
                c = c.like(_pair_scale(c.data, w_dev.to(rw), theta_dev.to(rw), tau, c.dist))
                z = general_multiplication(t.NO_TRANS, t.NO_TRANS, 1.0, basis, c, 0.0,
                                           DistributedMatrix.zeros(x.grid, (n, k), bs, pdt))
                x = x.like(x.data - z.data.to(target))
                del c, z
                x = _cholqr(x)
    if not info.converged:
        health.record("eig_refine_partial_not_converged", iters=info.iters,
                      residual=info.residual)
        if raise_on_failure:
            raise health.ConvergenceError(
                f"partial eigenpair refinement did not converge in {info.iters} sweeps "
                f"(residual {info.residual:.3e})", info=info)
    return theta, x, info


@origin_transparent
def hermitian_eigensolver_mixed(
    uplo: str,
    mat_a: DistributedMatrix,
    max_iters: int = 3,
    factor_dtype=None,
    spectrum: tuple[int, int] | None = None,
    raise_on_failure: bool = False,
):
    """HEEV with the pipeline in the low precision (``factor_dtype``, by
    default one step below ``mat_a``'s) and refinement in ``mat_a``'s: the
    whole spectrum by :func:`refine_eigenpairs`, a ``spectrum=(il, iu)``
    window by :func:`refine_partial_eigenpairs` (windows wider than
    ``max(WIDE_WINDOW_MIN, n / 2)`` by the full refinement and a slice).
    ``mat_a`` is not modified.  Returns ``(EigResult, info)``."""
    from dlaf_tpu_torch.algorithms.eigensolver import EigResult, hermitian_eigensolver
    from dlaf_tpu_torch.algorithms.solver import _lower_dtype

    target = mat_a.dtype
    _check_real("hermitian_eigensolver_mixed", target)
    low = _lower_dtype(target, factor_dtype)
    n = mat_a.size.rows
    if spectrum is not None and not (0 <= spectrum[0] <= spectrum[1] < n):
        raise health.DistributionError(f"spectrum {spectrum} outside [0, {n})")
    res_lo = hermitian_eigensolver(uplo, mat_a.astype(low))
    wide = spectrum is not None and (spectrum[1] - spectrum[0] + 1 > max(WIDE_WINDOW_MIN, n // 2))
    if spectrum is None or wide:
        lam, x, info = refine_eigenpairs(uplo, mat_a, res_lo.eigenvectors.astype(target),
                                         max_iters=max_iters, raise_on_failure=raise_on_failure)
        if spectrum is not None:
            from dlaf_tpu_torch.matrix.util import sub_matrix

            il, iu = spectrum
            x = sub_matrix(x, (0, il), (n, iu - il + 1))
            lam = lam[il:iu + 1]
        return EigResult(lam, x), info
    lam, x, info = refine_partial_eigenpairs(uplo, mat_a, res_lo.eigenvectors,
                                             res_lo.eigenvalues, spectrum, max_iters=max_iters,
                                             raise_on_failure=raise_on_failure)
    return EigResult(lam, x), info
