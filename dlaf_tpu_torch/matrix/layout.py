"""Pack/unpack between global (row/col element) layout and the stacked
block-cyclic local-tile layout (counterpart of ``dlaf_tpu/matrix/layout.py``).

The whole distributed matrix is ONE tensor

    X[Pr, Pc, ltr, ltc, mb, nb]

where ``X[r, c, li, lj]`` is the tile with global tile index
``(li*Pr + r - sr, lj*Pc + c - sc)`` (block-cyclic with source rank
``(sr, sc)``), exactly the JAX package's layout, so port-vs-reference
comparisons compare like with like.  Every function takes a numpy array or
a ``torch.Tensor`` and returns the same kind.
"""
from __future__ import annotations

import numpy as np
import torch

from dlaf_tpu_torch.matrix.distribution import Distribution


def pad_global(a, dist: Distribution):
    """Pad an (m, n) global array to the uniform padded extent."""
    m, n = dist.size
    mp, np_ = dist.padded_size
    if tuple(a.shape) != (m, n):
        raise ValueError(f"array shape {tuple(a.shape)} != distribution size {(m, n)}")
    if (mp, np_) == (m, n):
        return a
    if isinstance(a, torch.Tensor):
        return torch.nn.functional.pad(a, (0, np_ - n, 0, mp - m))
    return np.pad(a, ((0, mp - m), (0, np_ - n)))


def unpad_global(a, dist: Distribution):
    m, n = dist.size
    return a[:m, :n]


def pack(a_padded, dist: Distribution):
    """Global padded (Mp, Np) -> stacked [Pr, Pc, ltr, ltc, mb, nb]."""
    pr, pc = dist.grid_size
    ltr, ltc = dist.local_slots
    mb, nb = dist.block_size
    sr, sc = dist.source_rank
    x = a_padded.reshape(ltr, pr, mb, ltc, pc, nb)
    if isinstance(x, torch.Tensor):
        x = x.permute(1, 4, 0, 3, 2, 5)
        if sr or sc:
            x = torch.roll(x, (sr, sc), (0, 1))
        return x.contiguous()
    x = x.transpose(1, 4, 0, 3, 2, 5)
    if sr:
        x = np.roll(x, sr, axis=0)
    if sc:
        x = np.roll(x, sc, axis=1)
    return x


def unpack(x, dist: Distribution):
    """Stacked [Pr, Pc, ltr, ltc, mb, nb] -> global padded (Mp, Np)."""
    sr, sc = dist.source_rank
    mp, np_ = dist.padded_size
    if isinstance(x, torch.Tensor):
        if sr or sc:
            x = torch.roll(x, (-sr, -sc), (0, 1))
        return x.permute(2, 0, 4, 3, 1, 5).reshape(mp, np_)
    if sr:
        x = np.roll(x, -sr, axis=0)
    if sc:
        x = np.roll(x, -sc, axis=1)
    return x.transpose(2, 0, 4, 3, 1, 5).reshape(mp, np_)
