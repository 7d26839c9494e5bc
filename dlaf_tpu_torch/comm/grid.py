"""2D process grid over one ``torch.device`` (counterpart of
``dlaf_tpu/comm/grid.py``).

The JAX package's grid is a ``jax.sharding.Mesh`` with axes ``('r', 'c')``.
This slice of the port runs the 1x1 grid only: one rank, one device.  Any
other shape raises ``NotImplementedError``; multi-rank grids over
``torch.distributed`` are the next slice (ROADMAP.md, queue A item 3).
"""
from __future__ import annotations

from typing import Optional

import torch

from dlaf_tpu_torch.common.index import Size2D

ROW_AXIS = "r"
COL_AXIS = "c"


class Grid:
    """A ``Pr x Pc`` grid of ranks; here always 1x1 on ``device``."""

    def __init__(self, grid_size: Size2D, device: torch.device):
        self._grid_size = Size2D(*grid_size)
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # pin the index so it compares equal to tensors' devices
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device

    @classmethod
    def create(cls, shape: Optional[Size2D] = None, device=None) -> "Grid":
        """Build a grid.  ``device`` defaults to ``torch.device("cuda")``;
        without a CUDA device this raises rather than run on the CPU (pass
        ``device="cpu"`` explicitly for that)."""
        shape = Size2D(1, 1) if shape is None else Size2D(*shape)
        if shape != Size2D(1, 1):
            raise NotImplementedError(
                f"grid {shape.rows}x{shape.cols}: the port runs 1x1 grids only; "
                "multi-rank grids over torch.distributed wait in ROADMAP.md "
                "(queue A item 3, the next slice)"
            )
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Grid.create(): no CUDA device is available; pass "
                    "device='cpu' to run the plain versions on the CPU"
                )
            device = torch.device("cuda")
        return cls(shape, device)

    @property
    def grid_size(self) -> Size2D:
        return self._grid_size

    @property
    def size(self) -> int:
        return self._grid_size.count()

    def __repr__(self):
        return f"Grid({self._grid_size.rows}x{self._grid_size.cols}, {self.device})"
