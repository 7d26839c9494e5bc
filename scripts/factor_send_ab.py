#!/usr/bin/env python3
"""B7 and B8's tail in two checkouts, and a variant, in turns, on one card.

    python3 scripts/factor_send_ab.py OLD NEW

OLD and NEW are the roots of two checkouts of this repository (each holds
dlaf_tpu_torch/; NEW also chip_smoke.py).  A third tree, ROOT, is a copy of
NEW's package under _variants/root_solve/ (git-ignored) in which the root
of each ring solves every chunk of its panel and the other ranks only pull
(csrc/factor_send.cuh, solve_send): the variant of the shared solve.  Six
runs, OLD, NEW, ROOT, ROOT, NEW, OLD, each in a process of its own that
imports that tree's package (a tree's first run builds its kernels afresh,
its second reuses the build) and runs NEW's harness, so that every tree
faces the same checks:

- B7 (``chip_smoke.fused_case``) at path M's shape (f32, nb = 512, 16
  tiles a rank, 2x4 grid, rings of 4), at M5's nb = 192 and at S7's f64
  shapes (N = 4096, nb = 192 and 512): bit for bit the unfused composition
  (B1 -> B2 -> mask -> B5) on the card, timed in turns with it;
- B8 (``chip_smoke.consume_phases``, fused_step) at M4's step 0 at the
  default tier: within tol_for of its twin and the two-piece step, x bit
  for bit B3 on the merged, masked panel, the inputs' lifetime run;
- B8's split body (``chip_smoke.consume_split_cases``, fused_step_split) at
  M4's step 0 and at S7's f64 step 0, at bf16x3 and bf16x6: x bit for bit
  B3-split at the tier, timed at the tier and at 'default'.

Every output is digested (sha256 of its raw bytes: B7's lkk and cp; B8's
x, rp, lkk1, cp1 and d1).  Prints one JSON line per run (the tree, the
card, the times, the checks, the digests, ptxas's registers and spills of
B7's and B8's instantiations and of the functions they call out of line,
from the tree's first run), then a summary: each output bit for bit
between the trees, the times in turns, the worst registers and spills.
Exits non-zero if a run fails, an output differs between the trees, a
check fails on any tree, or an instantiation of NEW spills.  Needs a CUDA
device.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the root-only variant of the shared solve: (old, new) in factor_send.cuh
ROOT_ONLY = [
    ("  const int lo = share_lo(nc, s.me, s.P), hi = share_lo(nc, s.me + 1, s.P);\n",
     "  const int lo = s.me == s.root ? 0 : nc, hi = nc;\n"),
    ("      const int k = share_lo(nc, q, s.P) + j;\n"
     "      if (k >= share_lo(nc, q + 1, s.P)) continue;\n",
     "      const int k = j;\n      if (q != s.root || k >= nc) continue;\n"),
    ("  const int most = (nc + s.P - 1) / s.P;  // the largest share\n",
     "  const int most = nc;\n"),
]

_RUN = """
import importlib.util, json, sys, torch
sys.path.insert(0, {root!r})
import dlaf_tpu_torch  # the tree's package, before torch touches the card
assert dlaf_tpu_torch.__file__.startswith({root!r}), dlaf_tpu_torch.__file__
spec = importlib.util.spec_from_file_location("chip_smoke", {harness!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from dlaf_tpu_torch import tune
from dlaf_tpu_torch.comm.grid import Grid
from dlaf_tpu_torch.ops import _build

if {fresh}:  # rebuild, so that ptxas reports this tree's instantiations
    _build.library_path().unlink(missing_ok=True)
_build.build()
_build.lib()
ptxas = [e for e in _build.ptxas_report
         if "fused_kernel" in e["kernel"] or "fused_step_kernel" in e["kernel"]
         or (e.get("device_function") and e["source"].endswith(("consume.cu",
                                                                "panel_exchange.cu")))]
dev = torch.device("cuda")
stamp = {{"card": cs.card_line()}}
gpu = Grid.create(cs.GRID_M, device=dev)
out = {{}}

# B7 at path M's shape, M5's nb and S7's f64 shapes, inputs from fixed seeds
cases = [("M", "float32", cs.NB, cs.N // cs.NB // cs.GRID_M[0], 4)] + list(cs.FUSED_CASES)
for label, dtype_name, nb, ltr, above in cases:
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7 + nb + ltr)
    rec, _ = cs.fused_case(gpu, dtype_name, nb, ltr, above, gen)
    out["B7/" + label] = {{k: rec[k] for k in ("kernel_ms", "unfused_ms", "spans_ms_in_turns",
                                               "bitwise_vs_unfused", "flipped_bit_rejected",
                                               "digests")}}
    torch.cuda.empty_cache()

# B8 at M4's step 0, default tier
a_glob, _ = cs.make_inputs(dev)
rep = cs.consume_phases(stamp, cs.bound, cs.timed_ms, a_glob, only=("fused_step",),
                        digests=True)["fused_step"]
out["B8/M4_step0/default"] = {{k: rep.get(k) for k in (
    "kernel_ms", "two_piece_ms", "bitwise_vs_b3", "dropped_slice_rejected",
    "input_lifetime_bitwise", "rel_err", "rel_err_vs_two_piece", "digests")}}

# B8's split body at M4's step 0 and S7's f64 step 0, at both split tiers
tune.initialize(**cs.PATH_M4)
for tier in ("bf16x3", "bf16x6"):
    for spec in cs.consume_split_cases(gpu, a_glob, only=("fused_step_split",)):
        body, rest, x0 = spec["body"], spec["rest"], spec["x0"]
        label = f"{{spec['kernel']}} [{{spec['label']}}] at {{tier}}"
        x = x0.clone()
        with tune.gemm_precision_scope(tier):
            outs = cs.on_ranks(gpu, body, [x, spec["y"]] + rest)
        torch.cuda.synchronize()
        panel, applied, same, near = spec["post"](outs, rest)
        verdict = cs.b3_bitwise_verdict(label, x, x0, spec["cp"], panel, applied, tier)
        digests = {{nm: cs.digest(t) for nm, t in zip(("x", "rp", "lkk1", "cp1", "d1"),
                                                   [x] + same + near)}}
        del x, outs, panel, applied, same, near
        ms = {{}}
        for t_ in (tier, "default"):
            xs = x0.clone()
            with tune.gemm_precision_scope(t_):
                ms[t_] = cs.grid_span_ms(gpu, body, [xs, spec["y"]] + rest, 3)[0]
            del xs
        out[f"B8/{{spec['key']}}/{{tier}}"] = {{
            "kernel_ms": ms[tier], "default_tier_ms": ms["default"],
            "bitwise_vs_b3": verdict["bitwise_vs_b3"],
            "dropped_slice_rejected": verdict["dropped_slice_rejected"],
            "problems": verdict["problems"], "digests": digests}}
        del spec, body, rest, x0
        torch.cuda.empty_cache()
print("AB " + json.dumps({{"runs": out, "ptxas": ptxas}}))
"""

#: the checks every run's cases must pass (a key absent from a case is not
#: checked)
CHECKS = ("bitwise_vs_unfused", "flipped_bit_rejected", "bitwise_vs_b3",
          "dropped_slice_rejected", "input_lifetime_bitwise")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def variant(new: str) -> str:
    """NEW's package with the root-only solve, under _variants/root_solve/."""
    dst = os.path.join(ROOT_DIR, "_variants", "root_solve")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(new, "dlaf_tpu_torch"), os.path.join(dst, "dlaf_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = os.path.join(dst, "dlaf_tpu_torch", "csrc", "factor_send.cuh")
    text = open(src).read()
    for old, rep in ROOT_ONLY:
        if text.count(old) != 1:
            raise RuntimeError(f"root_solve: a text to replace occurs {text.count(old)} times")
        text = text.replace(old, rep)
    open(src, "w").write(text)
    return dst


def run(root: str, harness: str, fresh: bool) -> dict:
    root = os.path.abspath(root)
    proc = subprocess.run([sys.executable, "-c", _RUN.format(root=root, harness=harness,
                                                             fresh=fresh)],
                          capture_output=True, text=True, timeout=1500, cwd=root)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{root}: rc {proc.returncode}\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return {"tree": root, "card": card(), **json.loads(lines[0][3:])}


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__)
        return 2
    old, new = (os.path.abspath(a) for a in sys.argv[1:])
    harness = os.path.join(new, "chip_smoke.py")
    trees = {"old": old, "new": new, "root_only": variant(new)}
    runs = []
    for i, which in enumerate(("old", "new", "root_only", "root_only", "new", "old")):
        res = run(trees[which], harness, fresh=i < 3)
        res["which"] = which
        runs.append(res)
        print(json.dumps(res), flush=True)
    first = {r["which"]: r["runs"] for r in runs[:3]}
    cases = list(first["new"])
    same = {c: {nm: all(r["runs"][c]["digests"][nm] == first["new"][c]["digests"][nm]
                        for r in runs)
                for nm in first["new"][c]["digests"]} for c in cases}
    turns = {c: {w: [r["runs"][c]["kernel_ms"] for r in runs if r["which"] == w]
                 for w in trees} for c in cases}
    for c in cases:
        if c.startswith("B7/"):
            turns[c]["unfused"] = [r["runs"][c]["unfused_ms"] for r in runs]
    failed = [f"{r['which']} {c} {k}" for r in runs for c in cases for k in CHECKS
              if r["runs"][c].get(k) is False]

    def worst_of(ptx):
        return {"registers": max((e.get("registers") or 0 for e in ptx), default=None),
                "spill_bytes": max((e.get("spill_stores", 0) + e.get("spill_loads", 0)
                                    for e in ptx), default=None),
                "spilling": [e["kernel"] for e in ptx
                             if e.get("spill_stores") or e.get("spill_loads")]}

    worst = {w: worst_of(first_run["ptxas"]) for w, first_run in
             ((r["which"], r) for r in runs[:3])}
    all_same = all(v for c in same.values() for v in c.values())
    new_kernels = [e for e in runs[1]["ptxas"] if not e.get("device_function")]
    ok = all_same and not failed and bool(new_kernels) and \
        all(not e.get("spill_stores") and not e.get("spill_loads") for e in new_kernels)
    print(json.dumps({"summary": {"bitwise_between_trees": same, "all_bitwise": all_same,
                                  "failed_checks": failed, "turns_ms": turns,
                                  "worst_ptxas": worst, "card": runs[0]["card"]}}), flush=True)
    print(runs[0]["card"], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
