#!/usr/bin/env python3
"""Sweep by sweep trace of ``refine_eigenpairs`` on one GPU.

    python3 scripts/eig_refine_trace.py [N] [--max-iters K] [--runs CAP:F ...]

Runs the float32 pipeline (``hermitian_eigensolver``) of chip_smoke's path
H matrix, random_hermitian_pd(N, f32, seed 2), N = 8192 by default, on the
2x4 grid of rank threads under chip_smoke's PATH_R, then refines its
eigenvectors in float64 (``refine_eigenpairs``, ``max_iters`` K, 8 by
default) from that one start once per run CAP:F: CAP the largest cluster
a sweep rotates (``min(n, 512)`` in the JAX package), F the factor of the
gap threshold ``min(F ||I - G||_max, 1e-2)`` (10 in the JAX package).
Each sweep's ||I - G||_max, gap threshold, and clusters (count, largest,
columns covered, the runs skipped for their size and the largest run).  One JSON line per sweep and per run.  The library is
traced by wrapping its module functions in this process; nothing of it
changes.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=8192)
    ap.add_argument("--max-iters", type=int, default=8)
    ap.add_argument("--runs", nargs="*", default=["512:10"])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import dlaf_tpu_torch as dtt
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("eig_refine_trace: no CUDA device", flush=True)
        return 2
    import chip_smoke as cs
    from dlaf_tpu_torch import native, tune
    from dlaf_tpu_torch.algorithms import eig_refine as er
    from dlaf_tpu_torch.ops import _build
    from dlaf_tpu_torch.testing import random_hermitian_pd

    _build.build()
    _build.lib()
    native.build()
    native.lib()
    stamp = {"card": cs.card_line()}
    n, nb = args.n, cs.NBH
    dev = torch.device("cuda")
    tune.initialize(**cs.PATH_R)
    grid = dtt.Grid.create(cs.GRID_M, device=dev)
    a_low = torch.from_numpy(np.tril(random_hermitian_pd(n, np.float32, seed=cs.SEED_H))).to(dev)
    t0 = time.perf_counter()
    res = dtt.hermitian_eigensolver("L", dtt.DistributedMatrix.from_global(grid, a_low, (nb, nb)))
    torch.cuda.synchronize()
    w_ref = torch.linalg.eigvalsh((a_low.double() + torch.tril(a_low.double(), -1).T))
    gaps = torch.diff(w_ref)
    print(json.dumps({"n": n, "low_s": time.perf_counter() - t0,
                      "gap_min": gaps.min().item(), "gap_median": gaps.median().item(),
                      **stamp}), flush=True)
    v32 = res.eigenvectors
    trace = []
    orig_clusters, orig_ortho, orig_coeffs = er._clusters, er._ortho_err, er._refine_coeffs

    def ortho(*a, **k):
        r = orig_ortho(*a, **k)
        trace.append({"ortho": r})
        return r

    for run in args.runs:
        cap, factor = int(run.split(":")[0]), float(run.split(":")[1])

        def scaled(thresh, factor=factor):
            """The threshold the sweep computed, min(10 ortho, 1e-2), at F."""
            return thresh if thresh >= 1e-2 else min(thresh * factor / 10.0, 1e-2)

        def clusters(lam, gap_floor, max_size, cap=cap):
            gap_floor = scaled(gap_floor)
            every = orig_clusters(lam, gap_floor, len(lam))  # contiguous runs, any size
            out = [c for c in every if c[1] - c[0] <= min(len(lam), cap)]
            trace[-1].update(thresh=gap_floor, clusters=len(out),
                             largest=max([b - a for a, b in out] or [0]),
                             columns=sum(b - a for a, b in out),
                             skipped_for_size=len(every) - len(out),
                             largest_run=max([b - a for a, b in every] or [0]))
            return out

        def coeffs(s_data, g_data, lam, dist, gap_thresh):
            return orig_coeffs(s_data, g_data, lam, dist, scaled(gap_thresh))

        er._clusters, er._ortho_err, er._refine_coeffs = clusters, ortho, coeffs
        trace.clear()
        mat = dtt.DistributedMatrix.from_global(grid, a_low.double(), (nb, nb))
        t0 = time.perf_counter()
        try:
            _, _, info = er.refine_eigenpairs("L", mat, v32.astype(torch.float64),
                                              max_iters=args.max_iters)
        finally:
            er._clusters, er._ortho_err, er._refine_coeffs = (orig_clusters, orig_ortho,
                                                              orig_coeffs)
        torch.cuda.synchronize()
        for i, t in enumerate(trace):
            print(json.dumps({"run": run, "sweep": i, **t}), flush=True)
        print(json.dumps({"run": run, "iters": info.iters, "converged": info.converged,
                          "ortho_error": info.ortho_error, "wall_s": time.perf_counter() - t0,
                          **stamp}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
