#!/usr/bin/env python3
"""Paths MU and G2 of chip_smoke.py alone, on one GPU.

    python3 scripts/hegv_probe.py

Builds the kernels, then runs chip_smoke's path MU (path_mu: POSV from the
upper triangle at N on the 2x4 grid of rank threads, then shift recovery
at N_TIERS) on the main path's inputs (make_inputs), and path G2
(path_g2: the generalized eigensolver of the JAX miniapp's pair at NH on
the 2x4 grid, its checks, the two hegst backends and the U form), each
with its checks; a failed check ends the run with chip_smoke's message.
Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import dlaf_tpu_torch  # noqa: F401  (before torch touches the card: its CUDA settings)
    import torch

    if not torch.cuda.is_available():
        print("hegv_probe: no CUDA device", flush=True)
        return 2
    import chip_smoke as cs
    from dlaf_tpu_torch import native
    from dlaf_tpu_torch.ops import _build
    from dlaf_tpu_torch.testing import tol_for

    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    native.build()
    native.lib()
    stamp = {"card": cs.card_line()}
    print(json.dumps({"build_s": time.perf_counter() - t0, "torch": torch.__version__,
                      "cuda": torch.version.cuda, **stamp}), flush=True)

    a_glob, rhs = cs.make_inputs(torch.device("cuda"))
    a64 = a_glob.double()
    x_ref = torch.cholesky_solve(rhs.double(), torch.linalg.cholesky(a64))
    del a64

    def solve_err(x) -> float:
        return (torch.linalg.matrix_norm(x.double() - x_ref)
                / torch.linalg.matrix_norm(x_ref)).item()

    t0 = time.perf_counter()
    cs.path_mu(stamp, a_glob, rhs, solve_err, tol_for("float32", cs.N))
    del a_glob, rhs, x_ref
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    cs.path_g2(stamp)
    print(json.dumps({"path_MU_s": t1 - t0, "path_G2_s": time.perf_counter() - t1, **stamp}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
