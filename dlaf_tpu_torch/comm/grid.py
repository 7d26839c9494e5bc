"""2D process grid over one ``torch.device`` (counterpart of
``dlaf_tpu/comm/grid.py``).

The JAX package's grid is a ``jax.sharding.Mesh`` with axes ``('r', 'c')``
and runs every rank of it in one process (``jit(shard_map(fn))``).  The
port keeps that model: a ``Pr x Pc`` grid is ``Pr * Pc`` rank threads of
one process, all on the grid's one device, each on its own CUDA stream
(``comm/_ranks.py``).  Spreading the ranks over several cards, and one
process per rank for multi-host runs, are later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import torch

from dlaf_tpu_torch.common.index import Size2D

ROW_AXIS = "r"
COL_AXIS = "c"


class Grid:
    """A ``Pr x Pc`` grid of ranks on ``device``.

    ``runtime`` holds what the ranks share for the grid's lifetime (their
    streams, the ring kernels' landing slots and flags); it is made at
    first use by ``comm/_ranks.py``."""

    def __init__(self, grid_size: Size2D, device: torch.device):
        self._grid_size = Size2D(*grid_size)
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # pin the index so it compares equal to tensors' devices
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.runtime = None

    @classmethod
    def create(cls, shape: Optional[Size2D] = None, device=None) -> "Grid":
        """Build a ``shape`` grid (default 1x1) whose ranks all live on
        ``device``.  ``device`` defaults to ``torch.device("cuda")``;
        without a CUDA device this raises rather than run on the CPU (pass
        ``device="cpu"`` explicitly for that)."""
        shape = Size2D(1, 1) if shape is None else Size2D(*shape)
        if shape.rows < 1 or shape.cols < 1:
            raise ValueError(f"grid shape must be positive, got {shape.rows}x{shape.cols}")
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
