#!/usr/bin/env python3
"""Paths E2, EW and P2 of chip_smoke.py alone, on one GPU.

    python3 scripts/mixed_heev_probe.py [E2] [EW] [P2] [O2] [SUB]

Builds the kernels, then runs chip_smoke's path E2 (path_e2: the
mixed-precision eigensolver of path H's matrix in float64 at N=8192 on the
2x4 grid of rank threads), path EW (path_ew: its narrow-window route,
spectrum (0, 1023)) and path P2 (path_p2: a partial spectrum and the
eigenvalues only at N=4096), each with its checks; a failed check ends the
run with chip_smoke's message.  With names, only those run; O2 (path_o2:
path M1's Cholesky at source rank (1, 2)) and SUB (sub_gemm_phase:
general_sub_multiplication) are run on request only.  The float32
pipeline's own eigenpairs, the wrong answers of E2's and EW's checks, are
computed first (chip_smoke takes path H2's).  Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("E2", "EW", "P2", "O2", "SUB")


def main(argv) -> int:
    names = argv or ["E2", "EW", "P2"]
    unknown = [n for n in names if n not in PATHS]
    if unknown:
        print(f"mixed_heev_probe: unknown paths {unknown}; choose from {PATHS}", flush=True)
        return 2
    sys.path.insert(0, ROOT)
    import dlaf_tpu_torch  # noqa: F401  (before torch touches the card: its CUDA settings)
    import torch

    if not torch.cuda.is_available():
        print("mixed_heev_probe: no CUDA device", flush=True)
        return 2
    import chip_smoke as cs
    from dlaf_tpu_torch import native
    from dlaf_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    native.build()
    native.lib()
    stamp = {"card": cs.card_line()}
    print(json.dumps({"build_s": time.perf_counter() - t0, "torch": torch.__version__,
                      "cuda": torch.version.cuda, **stamp}), flush=True)
    walls, kept = {}, {}
    for name in names:
        t0 = time.perf_counter()
        if name == "E2":
            cs.path_e2(stamp, kept)
        elif name == "EW":
            cs.path_ew(stamp, kept)
        elif name == "P2":
            cs.path_p2(stamp)
        elif name == "O2":
            a_glob, _ = cs.make_inputs(torch.device("cuda"))
            cs.path_o2(stamp, a_glob)
            del a_glob
        else:
            cs.sub_gemm_phase(stamp)
        torch.cuda.empty_cache()
        walls[f"path_{name}_s"] = time.perf_counter() - t0
    print(json.dumps({**walls, **stamp}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
