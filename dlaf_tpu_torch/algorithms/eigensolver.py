"""Hermitian (generalized) eigensolver (counterpart of
``dlaf_tpu/algorithms/eigensolver.py``), real dtypes.

``backend='pipeline'`` runs the reference's staging on the grid's device:

  reduction_to_band        dense -> band b1 (device)
  sbr_reduce               band b1 -> b2, when the SBR stage is on (device)
  host bulge chase         band -> tridiagonal + compact reflectors (host)
  tridiagonal_eigensolver  multi-level D&C (device; B10 for f32)
  bt_band_hh               E <- Q2 E (device)
  sbr_back_transform       E <- Q_sbr E (device)
  bt_reduction_to_band     E <- Q1 E (device)

Every stage runs on any ``Pr x Pc`` grid of rank threads, each rank
computing what its JAX device computes: the band gather reads the
diagonal and first sub-diagonal tiles from their owners; the SBR stage
and the chase work on the O(N b) band, as in the JAX package; the D&C
runs its leaves, its secular roots (B10) and its level products over the
grid; the three back-transforms run on per-rank column panels
(``matrix/colpanels.py``), packed back once.  ``backend='auto'`` on a 1x1
grid is one ``torch.linalg.eigh`` of the hermitized dense matrix, as the
JAX package calls XLA's ``eigh`` there, and the pipeline on any other
grid.  'U' runs through the hermitized mirror.  Stage clocks: run between
``common.stagetimer.start()`` and ``stop()`` (red2band, sbr, chase,
tridiag, bt_band, bt_sbr, bt_red2band); each boundary then synchronises
the card, after every rank's stream.

``hermitian_generalized_eigensolver`` solves A x = lambda B x: the
Cholesky factor of B (stage ``cholesky_b``), the reduction to the standard
form (``gen_to_std``, ``algorithms/gen_to_std.py``), the eigensolver above,
and the back-substitution of the eigenvectors (``back_subst``, one Left
triangular solve).

``spectrum=(il, iu)`` keeps eigenpairs il..iu: the D&C solves the whole
tridiagonal problem, its eigenvector matrix is cut to the k = iu - il + 1
columns, and the three back-transforms run on those.
``hermitian_eigenvalues`` runs red2band, the band stage without any
transform (the SBR shrink and the rotation chase), and LAPACK's
tridiagonal solver on the host.

Not ported (ROADMAP.md §A, item 5): complex dtypes, the device chase and
the dense host band stage the JAX package falls back to without a chase
library.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from dlaf_tpu_torch import health, native, tune
from dlaf_tpu_torch.algorithms._origin import origin_transparent
from dlaf_tpu_torch.algorithms.band_to_tridiag import (
    band_to_tridiagonal_hh_storage,
    extract_band_storage,
    resolve_chase_backend,
)
from dlaf_tpu_torch.algorithms.bt_band_hh import bt_band_to_tridiagonal_hh_dist
from dlaf_tpu_torch.algorithms.bt_reduction_to_band import bt_reduction_to_band
from dlaf_tpu_torch.algorithms.cholesky import cholesky_factorization
from dlaf_tpu_torch.algorithms.gen_to_std import generalized_to_standard
from dlaf_tpu_torch.algorithms.reduction_to_band import get_band_size, reduction_to_band
from dlaf_tpu_torch.algorithms.triangular_solver import triangular_solver
from dlaf_tpu_torch.algorithms.tridiag_solver import tridiagonal_eigensolver
from dlaf_tpu_torch.common import stagetimer as st
from dlaf_tpu_torch.matrix import layout
from dlaf_tpu_torch.matrix import util as mutil
from dlaf_tpu_torch.matrix.distribution import Distribution
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.ops import tile as t


@dataclass
class EigResult:
    eigenvalues: np.ndarray  # ascending, host
    eigenvectors: DistributedMatrix  # n x k distributed


def _check_full_f32_products() -> None:
    """The pipeline's float32 products must be full float32: TF32 would
    change every stage (and it is off since ``ops/tile.py`` is imported)."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "hermitian_eigensolver: float32 products must be full float32 "
            "(torch.backends.cuda.matmul.allow_tf32 False, "
            "torch.get_float32_matmul_precision() == 'highest')")
    tune.validate_eigensolver_matmul_precision(
        tune.get_tune_parameters().eigensolver_matmul_precision)


def _sbr_target(band: int, device) -> int:
    """SBR target band: the largest divisor of ``band`` not above
    ``eigensolver_sbr_band`` when that shrinks the band, else 0 (off); -1 =
    32 on the card, off on the CPU (``eigensolver.py:152``)."""
    t_ = int(tune.get_tune_parameters().eigensolver_sbr_band)
    if t_ < 0:
        t_ = 32 if tune.on_accelerator(device) else 0
    if t_ <= 0 or band <= t_:
        return 0
    b2 = min(t_, band - 1)
    while band % b2:
        b2 -= 1
    return b2 if b2 >= 2 else 0


def _band_stage_hh(band_mat: DistributedMatrix, band: int, want_q: bool = True):
    """Band -> tridiagonal: the optional SBR shrink on the device, then the
    host chase at the small band.  Returns (hh tuple, SbrTransforms or
    None); with ``want_q`` False, ``(d, e)`` of the rotation chase and no
    transform at all."""
    from dlaf_tpu_torch.algorithms.band_reduction import sbr_reduce

    dev = band_mat.data.device
    dt = torch.empty(0, dtype=band_mat.dtype).numpy().dtype
    resolve_chase_backend(dev)  # raises before any work for the device chase
    b2 = _sbr_target(band, dev)
    if not want_q:
        ab = extract_band_storage(band_mat, band)
        if b2:
            with st.stage("sbr", dev):
                ab, _ = sbr_reduce(ab, band, b2, want_q=False)
        with st.stage("chase", dev):
            if isinstance(ab, torch.Tensor):
                ab = ab.cpu().numpy()
            return native.band2trid(ab, b2 or band)
    if b2:
        with st.stage("sbr", dev):
            ab2, tr = sbr_reduce(extract_band_storage(band_mat, band), band, b2)
        with st.stage("chase", dev):
            hh = band_to_tridiagonal_hh_storage(ab2, b2, dt, device=dev)
        return hh, (tr if tr.n_sweeps else None)
    with st.stage("chase", dev):
        hh = band_to_tridiagonal_hh_storage(extract_band_storage(band_mat, band), band, dt,
                                            device=dev)
    return hh, None


def _eigh_single_device(mat_a: DistributedMatrix, spectrum=None) -> EigResult:
    """1x1 fast path: ``torch.linalg.eigh`` of the hermitized dense matrix;
    a partial spectrum keeps its columns of the eigenvector block."""
    dist = mat_a.dist
    g = layout.unpad_global(layout.unpack(mat_a.data, dist), dist)
    full = torch.tril(g) + torch.tril(g, -1).transpose(0, 1).conj()
    w, v = torch.linalg.eigh(full)
    if spectrum is not None:
        il, iu = spectrum
        w, v = w[il:iu + 1], v[:, il:iu + 1]
        dist = Distribution(tuple(v.shape), tuple(dist.block_size), tuple(dist.grid_size))
    return EigResult(w.cpu().numpy(),
                     DistributedMatrix(dist, mat_a.grid, layout.pack(layout.pad_global(v, dist), dist)))


def _check_spectrum(spectrum, n: int):
    """``spectrum`` as a pair of ints within ``[0, n)``, else ValueError."""
    if spectrum is None:
        return None
    il, iu = int(spectrum[0]), int(spectrum[1])
    if not 0 <= il <= iu < n:
        raise ValueError(f"spectrum ({il}, {iu}) out of range for n={n}")
    return il, iu


def _check_ported(what: str, mat_a: DistributedMatrix) -> None:
    """Raise for what is not ported yet: complex dtypes."""
    if mat_a.dtype.is_complex:
        raise NotImplementedError(f"{what}: complex dtypes are not ported yet "
                                  "(ROADMAP.md §A, item 5: the rest of the eigensolver)")


@origin_transparent
def hermitian_eigensolver(
    uplo: str,
    mat_a: DistributedMatrix,
    spectrum: Optional[Tuple[int, int]] = None,
    backend: str = "auto",
) -> EigResult:
    """Eigendecomposition of the Hermitian matrix stored in the ``uplo``
    triangle of ``mat_a`` (not modified).  ``spectrum=(il, iu)`` selects
    the eigenvalue index range (inclusive, 0-based).  ``backend='auto'``
    takes ``torch.linalg.eigh`` on 1x1 grids and the distributed
    band-reduction pipeline on the others; 'pipeline' forces the pipeline
    everywhere."""
    _check_ported("hermitian_eigensolver", mat_a)
    if backend not in ("auto", "pipeline"):
        raise ValueError(f"hermitian_eigensolver: unknown backend {backend!r}")
    if mat_a.size.rows != mat_a.size.cols:
        raise ValueError("hermitian_eigensolver: matrix must be square")
    spectrum = _check_spectrum(spectrum, mat_a.size.rows)
    if uplo == t.UPPER:
        # lower-storage pipeline on the mirrored matrix
        mat_a = mutil.extract_triangle(mutil.hermitize(mat_a, "U"), "L")
    elif uplo != t.LOWER:
        raise ValueError(f"hermitian_eigensolver: bad uplo {uplo!r}")
    grid = mat_a.grid
    dev = mat_a.data.device
    n = mat_a.size.rows
    if backend == "auto" and grid.size == 1 and n > 0:
        return _eigh_single_device(mat_a, spectrum)
    _check_full_f32_products()
    nb = mat_a.block_size.rows
    if n == 0:
        return EigResult(np.zeros(0, torch.empty(0, dtype=mat_a.dtype).numpy().dtype), mat_a)
    band = get_band_size(nb, dev)
    with st.stage("red2band", dev):
        band_mat, taus = reduction_to_band(mat_a, band=band)
    health.check_finite("red2band", band_mat, taus)
    hh, tr_sbr = _band_stage_hh(band_mat, band)
    health.check_finite("band_stage", hh[0], hh[1])
    with st.stage("tridiag", dev):
        evals, v = tridiagonal_eigensolver(grid, hh[0], hh[1], nb, dtype=hh[0].dtype,
                                           spectrum=spectrum)
    health.check_finite("tridiag", evals, v)
    with st.stage("bt_band", dev):
        e = bt_band_to_tridiagonal_hh_dist(hh, v, out_cols=True)
    health.check_finite("bt_band", e)
    if tr_sbr is not None:
        from dlaf_tpu_torch.algorithms.band_reduction import sbr_back_transform

        with st.stage("bt_sbr", dev):
            e = sbr_back_transform(tr_sbr, e, out_cols=True)
        health.check_finite("bt_sbr", e)
    with st.stage("bt_red2band", dev):
        e = bt_reduction_to_band(e, band_mat, taus)
    health.check_finite("bt_red2band", e)
    return EigResult(evals, e)


@origin_transparent
def hermitian_eigenvalues(
    uplo: str,
    mat_a: DistributedMatrix,
    spectrum: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Eigenvalues only (LAPACK's jobz='N'), ascending, on the host:
    red2band, the band stage without any transform, and
    ``scipy.linalg.eigh_tridiagonal``; no back-transform and no
    eigenvector matrix.  A 1x1 grid takes ``torch.linalg.eigh`` as
    :func:`hermitian_eigensolver` does."""
    import scipy.linalg as sla

    _check_ported("hermitian_eigenvalues", mat_a)
    if mat_a.size.rows != mat_a.size.cols:
        raise ValueError("hermitian_eigenvalues: matrix must be square")
    n = mat_a.size.rows
    spectrum = _check_spectrum(spectrum, n)
    if uplo == t.UPPER:
        mat_a = mutil.extract_triangle(mutil.hermitize(mat_a, "U"), "L")
    elif uplo != t.LOWER:
        raise ValueError(f"hermitian_eigenvalues: bad uplo {uplo!r}")
    if mat_a.grid.size == 1 and n > 0:
        return _eigh_single_device(mat_a, spectrum).eigenvalues
    _check_full_f32_products()
    dev = mat_a.data.device
    if n == 0:
        return np.zeros(0, torch.empty(0, dtype=mat_a.dtype).numpy().dtype)
    band = get_band_size(mat_a.block_size.rows, dev)
    with st.stage("red2band", dev):
        band_mat, _ = reduction_to_band(mat_a, band=band)
    d, e = _band_stage_hh(band_mat, band, want_q=False)
    if spectrum is None:
        return sla.eigh_tridiagonal(d, e, eigvals_only=True)
    return sla.eigh_tridiagonal(d, e, eigvals_only=True, select="i", select_range=spectrum)


@origin_transparent
def hermitian_generalized_eigensolver(
    uplo: str,
    mat_a: DistributedMatrix,
    mat_b: DistributedMatrix,
    spectrum: Optional[Tuple[int, int]] = None,
    factorized: bool = False,
) -> EigResult:
    """Solve A x = lambda B x, A Hermitian and B Hermitian positive
    definite, both read from their ``uplo`` triangle; the eigenvectors are
    B-orthonormal.  B is factored in place (``cholesky_factorization``);
    ``factorized=True`` means ``mat_b`` already holds the factor.  A is not
    modified.  ``spectrum=(il, iu)`` selects eigenpairs il..iu, as in
    :func:`hermitian_eigensolver`.  Stage clocks (``common.stagetimer``):
    cholesky_b, gen_to_std, the eigensolver's, back_subst."""
    _check_ported("hermitian_generalized_eigensolver", mat_a)
    spectrum = _check_spectrum(spectrum, mat_a.size.rows)
    dev = mat_a.data.device
    with st.stage("cholesky_b", dev):
        fac = mat_b if factorized else cholesky_factorization(uplo, mat_b)
    with st.stage("gen_to_std", dev):
        a_std = generalized_to_standard(uplo, mat_a, fac)
        a_tri = mutil.extract_triangle(a_std, uplo)
        del a_std
    res = hermitian_eigensolver(uplo, a_tri, spectrum=spectrum)
    del a_tri
    # x = L^-H y ('L') or U^-1 y ('U')
    with st.stage("back_subst", dev):
        op = t.CONJ_TRANS if uplo == t.LOWER else t.NO_TRANS
        e = triangular_solver(t.LEFT, uplo, op, t.NON_UNIT, 1.0, fac, res.eigenvectors)
    return EigResult(res.eigenvalues, e)
