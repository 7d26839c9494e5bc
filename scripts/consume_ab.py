#!/usr/bin/env python3
"""B6's and B8's update body in two checkouts, in turns, on one card.

    python3 scripts/consume_ab.py OLD NEW

OLD and NEW are the roots of two checkouts of this repository (each holds
dlaf_tpu_torch/; NEW also chip_smoke.py).  Four runs, OLD, NEW, NEW, OLD,
each in a process of its own that imports that checkout's package (a
checkout's first run builds its kernels afresh, its second reuses the build)
and runs NEW's ``chip_smoke.consume_phases`` for B6 and B8, so that both
trees face the same checks: B6 on step 0 of M5 and of M4 and on a ring of
4, B8 on step 0 of M4, each against its twin and bit for bit B3 on the
merged panel masked to the slots it applies (the check first shown to
reject a planted wrong answer), B6 also with every slot suppressed (the
ring alone).  Each run then runs their split bodies on NEW's
``chip_smoke.consume_split_cases`` (B6 at step 0 of M5, at red2band's
first window and in float64; B8 at step 0 of M4 and in float64) under
bf16x3 and under bf16x6: x bit for bit B3-split at the tier applied once to
the merged panel masked to the applied slots (``b3_bitwise_verdict``,
first shown to reject B3-split with the last k16 slice of one applied slot
dropped), each case timed at the tier and at 'default'; then path M4
(lookahead Cholesky under the fused tier on 2x4, B8 every step: two walls
after a warm-up; its ``kernel_ms`` entry is the better wall).  Every
output is digested (sha256 of its raw bytes: x, the merged panel and
have; B8's rp, lkk1, cp1 and d1).

Prints one JSON line per run (the checkout, the card, the times, the
checks, the digests, and ptxas's registers and spills of every
consume_kernel and fused_step_kernel instantiation from the checkout's
first run), then a summary: each output bit for bit between OLD and
NEW, the checks against B3 on both trees, the times in turns, and the
worst registers and spills.  Exits non-zero if a run fails, an output
differs between the trees, a check against B3 fails on either tree, or an
instantiation of NEW spills or takes more than 128 registers.  Needs a
CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

_RUN = """
import importlib.util, json, sys, torch
sys.path.insert(0, {root!r})
import dlaf_tpu_torch  # the checkout's package, before torch touches the card
assert dlaf_tpu_torch.__file__.startswith({root!r}), dlaf_tpu_torch.__file__
spec = importlib.util.spec_from_file_location("chip_smoke", {harness!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from dlaf_tpu_torch import tune
from dlaf_tpu_torch.comm.grid import Grid
from dlaf_tpu_torch.ops import _build
from dlaf_tpu_torch.ops import trailing_update as tu

if {fresh}:  # rebuild, so that ptxas reports this checkout's instantiations
    _build.library_path().unlink(missing_ok=True)
_build.build()
_build.lib()
ptxas = [e for e in _build.ptxas_report
         if "consume_kernel" in e["kernel"] or "fused_step_kernel" in e["kernel"]]
dev = torch.device("cuda")
stamp = {{"card": cs.card_line()}}
a_glob, _ = cs.make_inputs(dev)
rep = cs.consume_phases(stamp, cs.bound, cs.timed_ms, a_glob,
                        only=("dma_ring_consume", "fused_step"), digests=True)
keys = ("kernel_ms", "ring_alone_ms", "ring_alone_share", "bitwise_vs_b3",
        "dropped_slice_rejected", "rel_err", "digests")
b6 = rep["dma_ring_consume"]
out = {{"M5_step0": {{k: b6.get(k) for k in keys}},
        "M4_step0": {{k: b6["at_M4"].get(k) for k in keys}},
        "ring_of_4": {{k: b6["ring_of_4"].get(k) for k in keys}},
        "fused_step": {{k: rep["fused_step"].get(k) for k in keys + ("two_piece_ms",)}}}}

# the split bodies on every case of consume_split_phase, at both split
# tiers: the check against B3-split, the outputs, the times
gpu = Grid.create(cs.GRID_M, device=dev)
tune.initialize(**cs.PATH_M4)
names = {{"dma_ring_consume_split": ("x", "yf", "h"),
          "fused_step_split": ("x", "rp", "lkk1", "cp1", "d1")}}
for tier in ("bf16x3", "bf16x6"):
    for spec in cs.consume_split_cases(gpu, a_glob):
        body, rest, x0 = spec["body"], spec["rest"], spec["x0"]
        label = f"{{spec['kernel']}} [{{spec['label']}}] at {{tier}}"
        x = x0.clone()
        with tune.gemm_precision_scope(tier):
            outs = cs.on_ranks(gpu, body, [x, spec["y"]] + rest)
        torch.cuda.synchronize()
        panel, applied, same, near = spec["post"](outs, rest)
        verdict = cs.b3_bitwise_verdict(label, x, x0, spec["cp"], panel, applied, tier)
        kept = [x] + list(outs) if spec["kernel"] == "dma_ring_consume_split" else [x] + same + near
        digests = {{nm: cs.digest(t) for nm, t in zip(names[spec["kernel"]], kept)}}
        del x, outs, panel, applied, same, near, kept
        ms = {{}}
        for t_ in (tier, "default"):
            xs = x0.clone()
            with tune.gemm_precision_scope(t_):
                ms[t_] = cs.grid_span_ms(gpu, body, [xs, spec["y"]] + rest, 3)[0]
            del xs
        out[f"{{spec['kernel']}}/{{spec['key']}}/{{tier}}"] = {{
            "kernel_ms": ms[tier], "default_tier_ms": ms["default"],
            "bitwise_vs_b3": verdict["bitwise_vs_b3"],
            "dropped_slice_rejected": verdict["dropped_slice_rejected"],
            "problems": verdict["problems"], "digests": digests}}
        del spec, body, rest, x0
        torch.cuda.empty_cache()

# path M4 (lookahead Cholesky under the fused tier on 2x4, B8 every step):
# its wall as chip_smoke.py times it, after a warm-up that makes the rings
import time
import dlaf_tpu_torch as dtt

def factor():
    mat = dtt.DistributedMatrix.from_global(gpu, a_glob, (cs.NB, cs.NB))
    return dtt.cholesky_factorization("L", mat, backend="distributed")

factor()
walls = []
for _ in range(2):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    factor()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
out["path_M4"] = {{"kernel_ms": min(walls) * 1e3, "walls_s": walls,
                   "gflops": [cs.N ** 3 / 3 / 1e9 / w for w in walls], "digests": {{}}}}
print("AB " + json.dumps({{"runs": out, "ptxas": ptxas}}))
"""


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def run(root: str, harness: str, fresh: bool) -> dict:
    root = os.path.abspath(root)
    proc = subprocess.run([sys.executable, "-c", _RUN.format(root=root, harness=harness,
                                                             fresh=fresh)],
                          capture_output=True, text=True, timeout=1200, cwd=root)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{root}: rc {proc.returncode}\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return {"checkout": root, "card": card(), **json.loads(lines[0][3:])}


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__)
        return 2
    old, new = sys.argv[1:]
    harness = os.path.join(os.path.abspath(new), "chip_smoke.py")
    runs = []
    for i, root in enumerate((old, new, new, old)):
        res = run(root, harness, fresh=i < 2)
        runs.append(res)
        print(json.dumps(res), flush=True)
    o, n = runs[0]["runs"], runs[1]["runs"]
    same = {case: {nm: o[case]["digests"][nm] == n[case]["digests"][nm]
                   for nm in o[case]["digests"]} for case in o}
    for r in runs[2:]:  # each tree's second run gives its first run's bits
        for case in o:
            for nm in o[case]["digests"]:
                ref = (o if r["checkout"] == runs[0]["checkout"] else n)[case]["digests"][nm]
                same[case][nm] = same[case][nm] and r["runs"][case]["digests"][nm] == ref
    turns = {case: {"old": [runs[0]["runs"][case]["kernel_ms"], runs[3]["runs"][case]["kernel_ms"]],
                    "new": [runs[1]["runs"][case]["kernel_ms"], runs[2]["runs"][case]["kernel_ms"]]}
             for case in o}
    for case in ("M5_step0", "M4_step0"):
        turns[case]["ring_alone_old"] = [runs[i]["runs"][case]["ring_alone_ms"] for i in (0, 3)]
        turns[case]["ring_alone_new"] = [runs[i]["runs"][case]["ring_alone_ms"] for i in (1, 2)]
    def worst_of(ptx):
        return {"registers": max((e.get("registers", 0) for e in ptx), default=None),
                "spill_bytes": max((e.get("spill_stores", 0) + e.get("spill_loads", 0)
                                    for e in ptx), default=None),
                "spilling": [e["kernel"] for e in ptx if e.get("spill_stores")]}

    ptx_new = runs[1]["ptxas"]
    worst = worst_of(ptx_new)
    b3 = {label: {case: r["runs"][case].get("bitwise_vs_b3") for case in o}
          for label, r in (("old", runs[0]), ("new", runs[1]))}
    rejected = {label: {case: r["runs"][case].get("dropped_slice_rejected") for case in o}
                for label, r in (("old", runs[0]), ("new", runs[1]))}
    b3_ok = all(v is not False for c in list(b3.values()) + list(rejected.values())
                for v in c.values())
    all_same = all(v for c in same.values() for v in c.values())
    ok = (all_same and b3_ok and bool(ptx_new) and worst["registers"] <= 128
          and worst["spill_bytes"] == 0)
    print(json.dumps({"summary": {"bitwise_between_trees": same, "all_bitwise": all_same,
                                  "bitwise_vs_b3": b3, "b3_check_rejects": rejected,
                                  "turns_ms": turns,
                                  "new_worst_ptxas": worst,
                                  "old_worst_ptxas": worst_of(runs[0]["ptxas"]),
                                  "card": runs[0]["card"]}}), flush=True)
    print(runs[0]["card"], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
