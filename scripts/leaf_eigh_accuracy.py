#!/usr/bin/env python3
"""Accuracy of ``torch.linalg.eigh`` on the D&C leaves of path H.

    python3 scripts/leaf_eigh_accuracy.py

Runs path H's band stages (chip_smoke.py's NH, NBH, SEED_H and PATH_H:
reduction to band, SBR, the host chase) on the card, builds the leaf
blocks the D&C tridiagonal solver solves (tridiag_dc_dist: the tridiagonal
torn at every leaf boundary), and solves them with one batched
``torch.linalg.eigh`` in float32 on the card, in float64 on the card (what
the port does), and in float32 on the CPU (LAPACK).  Prints one JSON line:
for each, the largest residual max|T q - lambda q| and orthogonality
max|Q^T Q - I| over the leaves, measured in float64.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("leaf_eigh_accuracy: no CUDA device", flush=True)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import tune
    from dlaf_tpu_torch.algorithms.band_reduction import sbr_reduce
    from dlaf_tpu_torch.algorithms.band_to_tridiag import (
        band_to_tridiagonal_hh_storage,
        extract_band_storage,
    )
    from dlaf_tpu_torch.algorithms.eigensolver import _sbr_target
    from dlaf_tpu_torch.algorithms.reduction_to_band import get_band_size, reduction_to_band
    from dlaf_tpu_torch.algorithms.tridiag_dc_dist import _plan
    from dlaf_tpu_torch.testing import random_hermitian_pd

    n, nb = chip_smoke.NH, chip_smoke.NBH
    tune.initialize(**chip_smoke.PATH_H)
    dev = torch.device("cuda")
    a = torch.from_numpy(np.tril(random_hermitian_pd(n, np.float32, seed=chip_smoke.SEED_H)))
    mat = dtt.DistributedMatrix.from_global(dtt.Grid.create(), a.to(dev), (nb, nb))
    band = get_band_size(nb, dev)
    b2 = _sbr_target(band, dev)
    band_mat, _ = reduction_to_band(mat, band=band)
    ab2, _ = sbr_reduce(extract_band_storage(band_mat, band), band, b2, want_q=False)
    d, e = band_to_tridiagonal_hh_storage(ab2, b2, np.float32, device=dev)[:2]

    # the leaves of tridiag_dc_distributed: pad, tear every leaf boundary
    s0, _, n_pad = _plan(n, nb, tune.get_tune_parameters().dc_leaf_size)
    d_mod = np.concatenate([d, np.full(n_pad - n, 2.0 * np.abs(d).max(), np.float32)])
    e_pad = np.zeros(n_pad, np.float32)
    e_pad[: n - 1] = e[: n - 1]
    for m in range(s0, n_pad, s0):
        d_mod[m - 1] -= abs(e_pad[m - 1])
        d_mod[m] -= abs(e_pad[m - 1])
    dl = torch.from_numpy(d_mod.reshape(-1, s0))
    el = torch.from_numpy(e_pad.reshape(-1, s0)[:, : s0 - 1])
    tris = torch.diag_embed(dl) + torch.diag_embed(el, 1) + torch.diag_embed(el, -1)

    def accuracy(t, dtype, device):
        w, q = torch.linalg.eigh(t.to(device, dtype))
        t64, w64, q64 = t.double().to(device), w.double(), q.double()
        res = (t64 @ q64 - q64 * w64[:, None, :]).abs().amax().item()
        eye = torch.eye(s0, dtype=torch.float64, device=device)
        orth = (q64.transpose(1, 2) @ q64 - eye).abs().amax().item()
        return {"residual": res, "orthogonality": orth}

    print(json.dumps({
        "n": n, "leaf": s0, "leaves": int(tris.shape[0]), "card": chip_smoke.card_line(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "cuda_float32": accuracy(tris, torch.float32, dev),
        "cuda_float64": accuracy(tris, torch.float64, dev),
        "cpu_float32": accuracy(tris, torch.float32, torch.device("cpu")),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
