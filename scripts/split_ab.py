#!/usr/bin/env python3
"""Time the split-tier kernel phase of two checkouts in turns on one card.

    python3 scripts/split_ab.py OLD NEW

OLD and NEW are the roots of two checkouts of this repository (each holds
chip_smoke.py and dlaf_tpu_torch/).  Runs chip_smoke.py's ``split_phase``
(B3's and B9's split bodies against their plain versions, with their times
and the default-tier kernel's in the same process) of OLD, NEW, NEW, OLD,
each in a process of its own that builds and loads that checkout's
kernels (a checkout's second run reuses its build), then digests (sha256
of the raw bytes) the outputs of B3 in both forms and B9 in both forms at
bf16x3 and bf16x6, f32 and f64, on ragged shapes made from one seed, and
again at K = 1000 with nine slots.
Prints one JSON line per run: the checkout, the card, per kernel and form
the split body's and the default-tier kernel's times in ms (and its
pre-pass's and body's alone, where the checkout's split_phase times them),
and the digests; then whether every digest is the same in all four runs.  Needs a
CUDA device; exits non-zero if a run fails or a digest differs.
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
ms = {{k: {{s: [f["kernel_ms"], f["default_tier_kernel_ms"]] for s, f in r["forms"].items()}}
      for k, r in rep.items()}}
# the pre-pass's and the body's times alone, where the checkout's phase has them
parts = {{k: {{s: [f["cut_ms"], f["body_ms"]] for s, f in r["forms"].items() if "cut_ms" in f}}
         for k, r in rep.items()}}

# the split bodies' bits: B3 and B9 in both forms at both tiers, ragged;
# then deep (K = 1000) with nine slots
from dlaf_tpu_torch.ops import trailing_update as tu
gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
digests = {{}}
for shape in ((4, 3, 200, 136, 168), (2, 9, 70, 90, 1000)):
    L, C, M, N, K = shape
    at = "" if shape[4] == 168 else f" {{list(shape)}}"
    for dt in (torch.float32, torch.float64):
        def randn(*s):
            return torch.randn(*s, generator=gen, device="cuda", dtype=dt)
        for tier in ("bf16x3", "bf16x6"):
            for sub, bshape in ((tu.CHOLESKY_SUBSCRIPTS, (C, N, K)),
                                (tu.TRSM_SUBSCRIPTS, (C, K, N))):
                x = randn(L, C, M, N)
                tu.trailing_update(x, randn(L, M, K), randn(*bshape), sub, tier)
                digests[f"B3 {{sub}} {{dt}} {{tier}}{{at}}"] = cs.digest(x)
            for sub, ashape, bshape in ((tu.TRTRI_LOWER_SUBSCRIPTS, (L, C, M, K), (C, K, N)),
                                        (tu.TRTRI_UPPER_SUBSCRIPTS, (L, M, K), (L, C, K, N))):
                out = tu.panel_contract(randn(*ashape), randn(*bshape), sub, tier)
                digests[f"B9 {{sub}} {{dt}} {{tier}}{{at}}"] = cs.digest(out)
torch.cuda.synchronize()
print("AB " + json.dumps({{"ms": ms, "parts_ms": parts, "digests": digests}}))
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
    res = json.loads(lines[0][3:])
    return {"checkout": root, "card": card.strip(), "ms_split_and_default": res["ms"],
            "ms_prepass_and_body": res["parts_ms"], "digests": res["digests"]}


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__)
        return 2
    old, new = sys.argv[1:]
    runs = []
    for root in (old, new, new, old):
        runs.append(run(root))
        print(json.dumps(runs[-1]), flush=True)
    same = {k: all(r["digests"][k] == runs[0]["digests"][k] for r in runs)
            for k in runs[0]["digests"]}
    print(json.dumps({"summary": {"digests_same_in_all_runs": same,
                                  "all_bitwise": all(same.values()), "card": runs[0]["card"]}}),
          flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
