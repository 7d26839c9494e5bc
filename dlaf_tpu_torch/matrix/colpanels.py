"""Column panels of the eigenvector matrix: the intermediate the
row-transform back-transform stages hand to each other (counterpart of
``dlaf_tpu/matrix/colpanels.py``).

The band-stage, SBR and red2band back-transforms act on E's rows with
independent columns.  The JAX package reshards E once to column panels
over the flat device order, ``P(None, ('r', 'c'))``: device
``f = r * Pc + c`` holds every row of columns ``[f * kloc, (f + 1) *
kloc)``, ``kloc = ceil(k / P)``.  The stages run back to back on those
panels and the chain packs once at the end.  The port keeps the layout as
a stack ``data[Pr, Pc, n_pad, kloc]``, so that ``spmd`` hands rank
``(r, c)`` its panel ``data[r, c]`` as it hands tile stacks.  Both
relayouts (:func:`from_matrix`, :func:`pack_to_matrix`) are index copies
on the grid's one device, where the JAX package runs an all-to-all.
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
    """``data[Pr, Pc, n_pad, kloc]``: rank ``(r, c)``'s column panel
    ``data[r, c]``; ``(n, k)`` the live extent; ``dist`` the stacked
    distribution to pack back into."""

    data: torch.Tensor
    n: int
    k: int
    grid: Grid
    dist: Distribution


def from_global(gp: torch.Tensor, n: int, k: int, grid: Grid, dist: Distribution) -> ColPanels:
    """Column panels of the padded global ``gp[n_pad, >= k]`` (columns
    past ``k`` are dropped, then zero-padded to ``kloc * P``)."""
    pr, pc = grid.grid_size
    kloc = -(-k // (pr * pc))
    n_pad = gp.shape[0]
    g = gp[:, :k]
    if kloc * pr * pc != k:
        g = torch.nn.functional.pad(g, (0, kloc * pr * pc - k))
    data = g.reshape(n_pad, pr, pc, kloc).permute(1, 2, 0, 3).contiguous()
    return ColPanels(data, n, k, grid, dist)


def from_matrix(mat: DistributedMatrix, n_pad: int) -> ColPanels:
    """Column panels of the stacked matrix ``mat``, rows zero-padded to
    ``n_pad``."""
    n, k = mat.dist.size
    g = layout.unpad_global(layout.unpack(mat.data, mat.dist), mat.dist)
    return from_global(torch.nn.functional.pad(g, (0, 0, 0, n_pad - n)), n, k, mat.grid,
                       mat.dist)


def pad_rows(cp: ColPanels, n_pad: int) -> ColPanels:
    """The same panels with at least ``n_pad`` rows (zeros below)."""
    if cp.data.shape[2] >= n_pad:
        return cp
    data = torch.nn.functional.pad(cp.data, (0, 0, 0, n_pad - cp.data.shape[2]))
    return ColPanels(data, cp.n, cp.k, cp.grid, cp.dist)


def to_global(cp: ColPanels) -> torch.Tensor:
    """The live ``[n, k]`` global matrix of the panels (a new tensor)."""
    pr, pc, n_pad, kloc = cp.data.shape
    g = cp.data.permute(2, 0, 1, 3).reshape(n_pad, pr * pc * kloc)
    return g[: cp.n, : cp.k]


def pack_to_matrix(cp: ColPanels) -> DistributedMatrix:
    """Column panels -> stacked block-cyclic matrix: the one relayout back."""
    return DistributedMatrix(cp.dist, cp.grid,
                             layout.pack(layout.pad_global(to_global(cp), cp.dist), cp.dist))
