"""Column panels of the eigenvector matrix: the intermediate the
row-transform back-transform stages hand to each other (counterpart of
``dlaf_tpu/matrix/colpanels.py``).

The band-stage, SBR and red2band back-transforms act on E's rows with
independent columns.  The JAX package reshards E to column panels over the
flat device order once, runs the stages back to back, and packs once at
the end.  On the 1x1 grid a column panel is the whole padded global
matrix ``data[n_pad, kpad]``; the chain still packs exactly once.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from dlaf_tpu_torch.comm.grid import Grid
from dlaf_tpu_torch.matrix import layout
from dlaf_tpu_torch.matrix.distribution import Distribution
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix


@dataclass
class ColPanels:
    """``data[n_pad, kpad]`` (the rows and columns this rank holds: all of
    them on 1x1); ``(n, k)`` the live extent; ``dist`` the stacked
    distribution to pack back into."""

    data: torch.Tensor
    n: int
    k: int
    grid: Grid
    dist: Distribution


def pack_to_matrix(cp: ColPanels) -> DistributedMatrix:
    """Column panels -> stacked block-cyclic matrix."""
    g = cp.data[: cp.n, : cp.k]
    return DistributedMatrix(cp.dist, cp.grid, layout.pack(layout.pad_global(g, cp.dist), cp.dist))
