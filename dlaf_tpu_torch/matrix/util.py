"""Matrix-level utilities on stacked block-cyclic storage (counterpart of
``dlaf_tpu/matrix/util.py``): triangle extraction, the distributed
(conjugate) transpose, hermitization, the identity and sub-matrix copies,
as elementwise masks on the stacked ``[Pr, Pc, ltr, ltc, mb, nb]`` tensor
or through the global form (every rank's tiles lie on the grid's one
device).
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch.matrix import layout
from dlaf_tpu_torch.matrix.distribution import Distribution
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.matrix.window import window_extract


def _global_element_grids(dist: Distribution, device):
    """Broadcastable global (row, col) element indices for the stacked shape."""
    pr, pc = dist.grid_size
    ltr, ltc = dist.local_slots
    mb, nb = dist.block_size
    sr, sc = dist.source_rank

    def ar(n, axis):
        shape = [1] * 6
        shape[axis] = n
        return torch.arange(n, device=device).reshape(shape)

    gi = (ar(ltr, 2) * pr + (ar(pr, 0) - sr) % pr) * mb + ar(mb, 4)
    gj = (ar(ltc, 3) * pc + (ar(pc, 1) - sc) % pc) * nb + ar(nb, 5)
    return gi, gj


def _triangle_data(x, dist: Distribution, uplo: str, k: int):
    gi, gj = _global_element_grids(dist, x.device)
    # np convention: tril keeps i >= j - k, triu keeps i <= j - k
    keep = (gi >= gj - k) if uplo == "L" else (gi <= gj - k)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def extract_triangle(mat: DistributedMatrix, uplo: str, k: int = 0) -> DistributedMatrix:
    """A copy with only the ``uplo`` triangle kept (diagonal offset ``k`` as
    in ``np.tril``/``np.triu``)."""
    return mat.like(_triangle_data(mat.data, mat.dist, uplo, k))


def transpose(mat: DistributedMatrix, conj: bool = False) -> DistributedMatrix:
    """Distributed (conjugate) transpose, a new matrix: unpack, swap the
    axes of the global form (conjugated when ``conj``), pack under the
    transposed distribution, whose size, block size and source rank are
    swapped (``dlaf_tpu/matrix/util.py:62``).  Padding is dropped before
    the swap: the padded extents of the two distributions differ in general.
    Two copies of the matrix's size on its device."""
    d = mat.dist
    dist_t = Distribution((d.size.cols, d.size.rows), (d.block_size.cols, d.block_size.rows),
                          d.grid_size, (d.source_rank.col, d.source_rank.row))
    if not mat.data.numel():
        data = torch.zeros(DistributedMatrix.stacked_shape(dist_t), dtype=mat.dtype,
                           device=mat.data.device)
        return DistributedMatrix(dist_t, mat.grid, data)
    g = layout.unpad_global(layout.unpack(mat.data, d), d).transpose(0, 1)
    if conj:
        g = g.conj()
    data = layout.pack(layout.pad_global(g, dist_t), dist_t).resolve_conj()
    return DistributedMatrix(dist_t, mat.grid, data)


def hermitize(mat: DistributedMatrix, uplo: str) -> DistributedMatrix:
    """Full Hermitian storage from the ``uplo`` triangle (the other
    triangle's stored values are ignored); a new tensor."""
    if mat.size.rows != mat.size.cols:
        raise ValueError("hermitize: matrix must be square")
    dist = mat.dist
    tri = _triangle_data(mat.data, dist, uplo, 0)
    strict = _triangle_data(mat.data, dist, uplo, -1 if uplo == "L" else 1)
    g = layout.unpad_global(layout.unpack(strict, dist), dist)
    mirror = layout.pack(layout.pad_global(g.transpose(0, 1).conj(), dist), dist)
    return mat.like(tri + mirror)


def eye_like(mat: DistributedMatrix) -> DistributedMatrix:
    """The identity of ``mat``'s distribution and dtype: 1 on the diagonal,
    0 elsewhere and in the padding (``laset(mat, 0, 1)``,
    ``dlaf_tpu/matrix/util.py:178``)."""
    gi, gj = _global_element_grids(mat.dist, mat.data.device)
    m, n = mat.dist.size
    diag = (gi == gj) & (gi < m) & (gj < n)
    return mat.like(diag.expand(mat.data.shape).to(mat.dtype).contiguous())


def sub_matrix(mat: DistributedMatrix, origin, size) -> DistributedMatrix:
    """Sub-matrix copy at any element origin, on any grid and from any
    source rank: ``window.window_extract``, an index copy of the window's
    elements on the grid's one device (the JAX package slices the global
    form on 1x1 grids and realigns the window by ``ppermute`` on the
    others, ``matrix/window.py``); the result has source rank (0, 0), as
    there."""
    origin = tuple(int(v) for v in origin)
    size = tuple(int(v) for v in size)
    if (origin[0] < 0 or origin[1] < 0 or origin[0] + size[0] > mat.size.rows
            or origin[1] + size[1] > mat.size.cols):
        raise ValueError(f"sub-matrix {origin}+{size} out of bounds {tuple(mat.size)}")
    return window_extract(mat, origin, size)
