"""Distributed row and column permutations (counterpart of
``dlaf_tpu/algorithms/permutations.py``).

The JAX package rotates each grid column's row stacks around the 'r' ring
(``_ring_fn``, :108) and gathers, at each hop, the rows whose owner is
resident.  Every rank of the port's grid lies on one device, so the port
gathers by index on the stacked tensor: each output element is read from
its source row's (or column's) owner at its local index, one copy of the
matrix.  A gather moves values unchanged, so the result is the JAX
package's bit for bit.  Ranks on several cards will need the ring form
(ROADMAP.md §A, item 10).
"""
from __future__ import annotations

import numpy as np
import torch

from dlaf_tpu_torch.algorithms._origin import origin_transparent
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix


def _source_index(perm, p: int, lt: int, blk: int, src_rank: int, ext: int, device):
    """For every padded output position ``(rank, slot, element)`` of one
    axis (``[p, lt, blk]``): the stacked index of its source position, and
    whether it is inside the matrix."""
    rank = torch.arange(p, device=device)[:, None, None]
    slot = torch.arange(lt, device=device)[None, :, None]
    el = torch.arange(blk, device=device)[None, None, :]
    g = (slot * p + (rank - src_rank) % p) * blk + el
    valid = g < ext
    s = perm[torch.clamp(g, max=max(ext - 1, 0))]
    tile = s // blk
    return ((tile + src_rank) % p, tile // p, s % blk), valid


@origin_transparent
def permute(mat: DistributedMatrix, perm, coord: str = "rows") -> DistributedMatrix:
    """Gather permutation, a new matrix: rows, ``out[i, :] = in[perm[i], :]``;
    cols, ``out[:, j] = in[:, perm[j]]``."""
    if coord not in ("rows", "cols"):
        raise ValueError(f"coord must be 'rows' or 'cols', got {coord}")
    n = mat.size.rows if coord == "rows" else mat.size.cols
    perm = np.asarray(perm)
    if perm.shape != (n,):
        raise ValueError(f"perm must have shape ({n},), got {perm.shape}")
    x = mat.data
    if n == 0:
        return mat.like(x.clone())
    ax = 0 if coord == "rows" else 1
    pr_pc = mat.dist.grid_size
    perm_t = torch.as_tensor(perm.astype(np.int64), device=x.device)
    (rk, sl, el), valid = _source_index(perm_t, pr_pc[ax], mat.dist.local_slots[ax],
                                        mat.dist.block_size[ax], mat.dist.source_rank[ax], n,
                                        x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if ax == 0:
        out = x[rk, :, sl, :, el, :]  # [pr, ltr, mb, pc, ltc, nb]
        out = torch.where(valid[..., None, None, None], out, zero).permute(0, 3, 1, 4, 2, 5)
    else:
        out = x[:, rk, :, sl, :, el]  # [pc, ltc, nb, pr, ltr, mb]
        out = torch.where(valid[..., None, None, None], out, zero).permute(3, 0, 4, 1, 5, 2)
    return mat.like(out.contiguous())
