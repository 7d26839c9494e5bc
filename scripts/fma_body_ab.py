#!/usr/bin/env python3
"""B3's and B9's FMA body (csrc/fma_gemm.cuh) against the first body it
replaced, on the card, alone: chip_smoke.py's phases of the two kernels.

    python3 scripts/fma_body_ab.py

Runs ``chip_smoke.trailing_update_phase`` (B3 at path B's and red2band's
shapes and in f64), ``chip_smoke.fma_edge_phase`` (both kernels, both
forms, at ragged shapes in f32 and f64) and B9's part of
``chip_smoke.consume_phases`` (path I's widest step on a 2x4 grid of rank
threads): each case bit for bit the reference kernel, the check first shown
to reject the reference with its last k slice dropped, within tol_for of
the plain version, and timed in turns with the reference (reference, new,
new, reference).  Prints chip_smoke.py's JSON records, the build's ptxas
line for the FMA body, and the card's name and power limit; exits non-zero
if a check fails or there is no CUDA device.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("fma_body_ab: no CUDA device", flush=True)
        return 2
    from dlaf_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = cs.card_line()
    stamp = {"card": card}
    print(f"card: {card}", flush=True)
    _build.build()
    _build.lib()
    cs.emit({"phase": "ptxas", "kernels": [e for e in _build.ptxas_report
                                           if "_fma_kernel" in e["kernel"]]})

    kgen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    cs.trailing_update_phase(stamp, cs.bound, cs.timed_ms, kgen)
    cs.fma_edge_phase(stamp, cs.timed_ms, kgen)
    cs.consume_phases(stamp, cs.bound, cs.timed_ms, None, only=("panel_contract",))
    print(card, flush=True)
    print(json.dumps({"fma_body_ab": "passed"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
