#!/usr/bin/env python3
"""Time the split-tier kernel phase of two checkouts in turns on one card.

    python3 scripts/split_ab.py OLD NEW

OLD and NEW are the roots of two checkouts of this repository (each holds
chip_smoke.py and dlaf_tpu_torch/).  Runs chip_smoke.py's ``split_phase``
(B3's and B9's split bodies against their plain versions, with their times
and the default-tier kernel's in the same process) of OLD, NEW, NEW, OLD,
each in a process of its own that builds and loads that checkout's
kernels (a checkout's second run reuses its build).  Prints one JSON line
per run: the checkout, the card, and per kernel and form the split body's
and the default-tier kernel's times in ms.  Needs a CUDA device; exits
non-zero if a run fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

_RUN = """
import json, sys, torch
sys.path.insert(0, {root!r})
import dlaf_tpu_torch  # before torch touches the card
import chip_smoke as cs

def timed_ms(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters

kgen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
rep = cs.split_phase({{"card": cs.card_line()}}, timed_ms, kgen)
print("AB " + json.dumps({{k: {{s: [f["kernel_ms"], f["default_tier_kernel_ms"]]
                             for s, f in r["forms"].items()}} for k, r in rep.items()}}))
"""


def run(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _RUN.format(root=os.path.abspath(root))],
                          capture_output=True, text=True, timeout=1200, cwd=root)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{root}: rc {proc.returncode}\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-2000:]}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    return {"checkout": root, "card": card.strip(),
            "ms_split_and_default": json.loads(lines[0][3:])}


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__)
        return 2
    old, new = sys.argv[1:]
    for root in (old, new, new, old):
        print(json.dumps(run(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
