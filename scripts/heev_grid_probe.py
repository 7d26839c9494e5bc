#!/usr/bin/env python3
"""Path H2 of chip_smoke.py alone, on one GPU: the HEEV pipeline on the
2x4 grid of rank threads.

    python3 scripts/heev_grid_probe.py

Builds the kernels, holds B10 at H2's per-rank shape (chip_smoke.B10_H2,
its mu table) to its first body by digest, makes one instrumented run of
hermitian_eigensolver("L", A, backend="pipeline") on chip_smoke.GRID_M
under chip_smoke.PATH_R (stage seconds, launches, the eigenvalue error
against eigvalsh in float64 on the card), and, when that run took less
than 150 s, runs chip_smoke's paths H and H2 (path_h, path_h2) with their
checks.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import dlaf_tpu_torch as dtt  # before torch touches the card (its CUDA settings)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("heev_grid_probe: no CUDA device", flush=True)
        return 2
    import chip_smoke as cs
    from dlaf_tpu_torch import native, ops, tune
    from dlaf_tpu_torch.common import stagetimer
    from dlaf_tpu_torch.ops import _build, secular
    from dlaf_tpu_torch.testing import random_hermitian_pd

    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    native.build()
    native.lib()
    stamp = {"card": cs.card_line()}
    print(json.dumps({"build_s": time.perf_counter() - t0, "torch": torch.__version__,
                      "cuda": torch.version.cuda, **stamp}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(7)
    args, _ = cs.secular_tables(gen, gen, *cs.B10_H2)["mu"]
    b10 = (*args, cs.ITERS_B10)
    new, ref = secular.secular_bisect(*b10), secular.secular_bisect_reference(*b10)
    torch.cuda.synchronize()
    print(json.dumps({"b10_shape": list(cs.B10_H2),
                      "bitwise_vs_reference": cs.digest(new) == cs.digest(ref)}), flush=True)

    a_low = torch.from_numpy(np.tril(random_hermitian_pd(cs.NH, np.float32, seed=cs.SEED_H)))
    a_low = a_low.cuda()
    tune.initialize(**cs.PATH_R)
    mat = dtt.DistributedMatrix.from_global(dtt.Grid.create(cs.GRID_M), a_low, (cs.NBH, cs.NBH))
    ops.reset_launch_counts()
    stagetimer.start()
    t0 = time.perf_counter()
    res = dtt.hermitian_eigensolver("L", mat, backend="pipeline")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = stagetimer.stop()
    w = torch.from_numpy(np.asarray(res.eigenvalues, np.float64)).cuda()
    a64 = a_low.double()
    a64 = a64 + torch.tril(a64, -1).T
    w_ref = torch.linalg.eigvalsh(a64)
    print(json.dumps({"first_H2_run_s": wall, "stage_s": stages, "launches": cs.launch_counts(),
                      "eig_err": ((w - w_ref).abs().max() / w_ref.abs().max()).item(), **stamp}),
          flush=True)
    del res, a64, mat
    torch.cuda.empty_cache()
    if wall < 150:
        kept = {}
        cs.path_h(stamp, kept)
        torch.cuda.empty_cache()
        cs.path_h2(stamp, kept)
    return 0


if __name__ == "__main__":
    sys.exit(main())
