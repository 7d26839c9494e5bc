"""Band -> real symmetric tridiagonal reduction, the host stage
(counterpart of ``dlaf_tpu/algorithms/band_to_tridiag.py``).

The band is O(N b) data, so, as the reference and the JAX package do, the
bulge chase runs on the host: the compact band storage is gathered from the
device, reduced by the threaded C++ Householder chase
(``dlaf_tpu_torch/native.py``, a copy of the JAX package's
``native/band2trid.cpp``), and the compact reflector set is kept for the
band back-transform (``bt_band_hh``).

Ported: ``extract_band_storage``, ``band_to_tridiagonal_hh_storage`` and
``resolve_chase_backend``, for real dtypes.  The device wavefront chase
(``band_chase_device.py``) and the dense host band stage that the JAX
package falls back to are not: 'device' raises (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from dlaf_tpu_torch import native, tune
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix


def extract_band_storage(mat: DistributedMatrix, band: int) -> torch.Tensor:
    """The lower band of ``mat`` as compact storage ``ab[band+2, n]`` with
    ``ab[d, j] = A[j+d, j]`` (zero where ``j+d >= n``; the last row is zero
    scratch for the chase), gathered on the matrix's device in one indexing
    op: each element is read from its owner's tile stack at its local
    index.  Only the diagonal and first sub-diagonal tiles are read, the
    tiles the JAX package gathers (``_gather_band_tiles``), on any grid."""
    m = mat.size.rows
    mb, nb = mat.block_size
    pr, pc = mat.dist.grid_size
    sr, sc = mat.dist.source_rank
    dev = mat.data.device
    x = mat.data
    off = torch.arange(band + 1, device=dev)[:, None]
    j = torch.arange(m, device=dev)[None, :]
    r = j + off
    valid = r < m
    rc = torch.clamp(r, max=m - 1)
    jb = j.expand_as(rc)
    ti, tj = rc // mb, jb // nb
    vals = x[(ti + sr) % pr, (tj + sc) % pc, ti // pr, tj // pc, rc % mb, jb % nb]
    ab = torch.zeros((band + 2, m), dtype=x.dtype, device=dev)
    ab[: band + 1] = torch.where(valid, vals, torch.zeros((), dtype=x.dtype, device=dev))
    return ab


def resolve_chase_backend(device) -> str:
    """Where the bulge chase runs (``tune.band_chase_backend``): 'auto' is
    the device chase on the card and the native host chase on the CPU, the
    JAX package's rule with "accelerator" read as "the grid's device is
    CUDA".  Only 'native' is ported: 'device' raises."""
    be = tune.validate_band_chase_backend(tune.get_tune_parameters().band_chase_backend)
    if be == "auto":
        be = "device" if tune.on_accelerator(device) else "native"
    if be == "device":
        raise NotImplementedError(
            "band_chase_backend='device' (the batched wavefront chase on the card, "
            "dlaf_tpu/algorithms/band_chase_device.py) is not ported yet (ROADMAP.md §A, "
            "item 5: the rest of the eigensolver); set band_chase_backend='native' for the "
            "host chase"
        )
    return be


def band_to_tridiagonal_hh_storage(ab, band: int, dt, device=None):
    """The Householder chase on compact lower-band storage ``ab`` (numpy or
    a tensor, ``>= band + 2`` rows).  Returns ``(d, e, phases, V[R, band],
    tau[R], band)`` as host numpy arrays (the JAX package's tuple; phases
    are ones for real dtypes)."""
    if isinstance(ab, torch.Tensor):
        device = ab.device if device is None else device
        ab = ab.detach().cpu().numpy()
    resolve_chase_backend("cpu" if device is None else device)
    dt = np.dtype(dt)
    if dt.kind == "c":
        raise NotImplementedError("band_to_tridiagonal_hh_storage: complex dtypes are not ported")
    d, e, v, tau = native.band2trid_hh(np.ascontiguousarray(ab[: band + 2]), band)
    rd = np.float32 if dt == np.float32 else np.float64
    return d.astype(rd), e.astype(rd), np.ones(d.shape[0], dt), v, tau, band
