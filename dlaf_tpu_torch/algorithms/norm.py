"""Distributed matrix norms (counterpart of ``dlaf_tpu/algorithms/norm.py``).

One reduction over the stacked tile tensor with an element mask for the
padding and the ``uplo`` triangle; the stacked tensor holds every rank's
tiles, so its max is the grid's.  NaN survives the reduction: it is
detected with an or-reduce of ``isnan``, as the JAX package does.
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.matrix.util import _global_element_grids


def masked_max_abs(data: torch.Tensor, dist, uplo: str = "G") -> torch.Tensor:
    """Largest ``|x_ij|`` over the in-bounds elements of a stacked tensor
    (restricted to the ``uplo`` triangle for 'L' / 'U'), NaN if any of them
    is NaN; a 0-d tensor on the data's device."""
    gi, gj = _global_element_grids(dist, data.device)
    m, n = dist.size
    keep = (gi < m) & (gj < n)
    if uplo == "L":
        keep = keep & (gi >= gj)
    elif uplo == "U":
        keep = keep & (gi <= gj)
    vals = torch.where(keep, data.abs(), torch.zeros((), dtype=data.abs().dtype,
                                                      device=data.device))
    if not data.numel():
        return torch.zeros((), dtype=vals.dtype, device=data.device)
    return torch.where(torch.isnan(vals).any(), torch.full((), float("nan"), dtype=vals.dtype,
                                                           device=data.device), vals.max())


def max_norm(mat: DistributedMatrix, uplo: str = "G") -> float:
    """Max-norm (largest ``|a_ij|``) of the matrix; ``uplo`` in {'G', 'L',
    'U'} restricts it to a triangle."""
    if mat.size.count() == 0:
        return 0.0
    return float(masked_max_abs(mat.data, mat.dist, uplo))
