#!/usr/bin/env python3
"""B2's Hopper body (solve_rows, csrc/panel_trsm.cuh) against the first body
it replaced, on the card, alone: chip_smoke.py's phase of the kernel.

    python3 scripts/panel_trsm_ab.py [merge]

Runs ``chip_smoke.potrf_phase`` for B1's 512 x 512 f32 factor (the same
seeded inputs as chip_smoke.py), then ``chip_smoke.panel_trsm_phase``: at
heights 15872 down to 512 x 512 in f32, 15872 x 512 in f64, at ragged
shapes and with subnormal quotients, each bit for bit the reference kernel, the check first shown to
reject the reference with its last column block's GEMM term dropped,
within tol_for of the plain version, and timed in turns with the reference
(reference, new, new, reference) beside torch.linalg.solve_triangular; then
every height path A launches, summed over its 32 launches.  With ``merge``
it also runs B4's phase (``chip_smoke.merge_phase``: the select bit for bit
its plain version, timed beside torch.where with L2 hot and cold, and the
host's time per call).
Prints chip_smoke.py's JSON records, the build's ptxas line for both
bodies, and the card's name and power limit; exits non-zero if a check
fails or there is no CUDA device.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import dlaf_tpu_torch  # noqa: E402,F401  (before torch touches the card)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("panel_trsm_ab: no CUDA device", flush=True)
        return 2
    from dlaf_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = cs.card_line()
    stamp = {"card": card}
    print(f"card: {card}", flush=True)
    _build.build()
    _build.lib()
    cs.emit({"phase": "ptxas", "kernels": [e for e in _build.ptxas_report
                                           if "panel_trsm" in e["kernel"]
                                           or "merge" in e["kernel"]]})

    kgen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    _, ell = cs.potrf_phase(stamp, cs.bound, cs.timed_ms, kgen)
    cs.panel_trsm_phase(stamp, cs.bound, cs.timed_ms, kgen, ell)
    if "merge" in argv:
        cs.merge_phase(stamp, cs.bound, kgen)
    print(card, flush=True)
    print(json.dumps({"panel_trsm_ab": "passed"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
