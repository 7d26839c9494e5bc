#!/usr/bin/env python3
"""Time B6 and B8 on variants of their sources, each built in a copy.

    python3 scripts/consume_variants.py [NAME ...]   # every variant by default

Each variant is a few edits of dlaf_tpu_torch/csrc/ made in a copy of
dlaf_tpu_torch/ under _variants/<name>/ (listed in .gitignore; the
repository's own files are never edited).  The copy builds its kernels in
a process of its own and times, at step 0 of path M4 on the 2x4 grid (the
inputs of chip_smoke.py), B8 and B6 at the 'default' tier and under
bf16x3 (device span of 3 calls on every rank, twice), and reports ptxas's
registers and spills of every consume_kernel and fused_step_kernel
instantiation.  The unmodified tree runs first and last.  Variants marked
"probe" change the arithmetic: their times say where the body's time goes,
and their outputs are not checked.  Prints one JSON line per run and the
card's name and power limit; needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "_variants")

_COMPUTE = "      compute_slice<T>(acc, sm + (t % kStages) * G::STAGE, tx, ty);\n"
_STORE = "    store<T>(x, ltc, j, M, N, rows, ncols, c0, r0, acc, tx, ty);\n"

#: name -> (what it tries, [(file under csrc/, text, its replacement)])
VARIANTS = {
    "tree": ("the sources as they are", []),
    # B8's split instantiations with the update inlined, as B6 has it
    "inline_split_update": (
        "B8's split consume phase inlined into the step kernel",
        [("consume.cu", "  ConsumeHooks<T, NS, NS != 0> hooks{", "  ConsumeHooks<T, NS> hooks{")]),
    # the larger register tile: 256 x 64 in f32, 8 x 4 outputs a thread
    "tile_8x4": (
        "f32 tiles of 256 x 64, 8 x 4 outputs a thread",
        [("consume_gemm.cuh", "static constexpr int BM = sizeof(T) == 4 ? 128 : 64;",
          "static constexpr int BM = sizeof(T) == 4 ? 256 : 64;")]),
    "stages_6": (
        "six stages of copies in flight",
        [("consume_gemm.cuh", "constexpr int kStages = 4;", "constexpr int kStages = 6;")]),
    # probes: each slice's FMAs done twice; the epilogue skipped
    "probe_fma_twice": (
        "probe: each slice's FMAs twice (the loads and barriers once)",
        [("consume_gemm.cuh", _COMPUTE, _COMPUTE + _COMPUTE)]),
    "probe_no_epilogue": (
        "probe: no epilogue (x never read or written)",
        [("consume_gemm.cuh", _STORE, "    if (acc[0][0] == T(12345.678)) " + _STORE.lstrip())]),
}

_RUN = """
import importlib.util, json, re, sys, torch
sys.path.insert(0, {copy!r})
import dlaf_tpu_torch  # the copy's package, before torch touches the card
spec = importlib.util.spec_from_file_location("chip_smoke", {harness!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from dlaf_tpu_torch import tune
from dlaf_tpu_torch.comm.grid import Grid
from dlaf_tpu_torch.ops import _build
from dlaf_tpu_torch.ops import trailing_update as tu

_build.build()
ptxas = []
for e in _build.ptxas_report:
    m = re.search(r"(consume_kernel|fused_step_kernel)<[^>]*>", e["kernel"])
    if m:
        ptxas.append({{"kernel": m.group(0), "registers": e.get("registers"),
                      "spill_bytes": e.get("spill_stores", 0) + e.get("spill_loads", 0)}})
dev = torch.device("cuda")
a_glob, _ = cs.make_inputs(dev)
gpu = Grid.create(cs.GRID_M, device=dev)
tune.initialize(**cs.PATH_M4)
g, x0, cp, taken, have, supp, below1 = cs._step0(gpu, a_glob, cs.NB)
params = (1 % g.pc, 1 % g.pr, 1 // g.pc, 1 // g.pr, 1 // g.pc)

def b8(x, tk, hv, c, z, bl):
    return tu.fused_step(x, tk, hv, z, c, bl, params)[1:]

def b6(x, tk, hv, c, z, bl):
    _, y, h = tu.dma_ring_consume(x, tk, hv.to(torch.int32).reshape(-1, 1), c,
                                  z.to(torch.int32).reshape(-1, 1), "r")
    return y, h

args = [taken, have, cp, supp, below1]
ms = {{}}
for name, fn in (("fused_step", b8), ("dma_ring_consume", b6)):
    for tier in ("default", "bf16x3"):
        x = x0.clone()
        with tune.gemm_precision_scope(tier):
            cs.on_ranks(gpu, fn, [x] + args)
            ms[name + "_" + tier] = [cs.grid_span_ms(gpu, fn, [x] + args, 3)[0] for _ in range(2)]
print("V " + json.dumps({{"ms_at_M4_step0": ms, "ptxas": ptxas}}))
"""


def run(name: str) -> dict:
    what, edits = VARIANTS[name]
    copy = os.path.join(WORK, name)
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "dlaf_tpu_torch"), os.path.join(copy, "dlaf_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for fname, old, new in edits:
        path = os.path.join(copy, "dlaf_tpu_torch", "csrc", fname)
        text = open(path).read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: a text to replace occurs {text.count(old)} times in "
                               f"{fname}")
        open(path, "w").write(text.replace(old, new))
    proc = subprocess.run([sys.executable, "-c", _RUN.format(
        copy=copy, harness=os.path.join(ROOT, "chip_smoke.py"))],
        capture_output=True, text=True, timeout=900, cwd=copy)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("V ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{name}: rc {proc.returncode}\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-2000:]}")
    res = json.loads(lines[0][2:])
    spilling = [p["kernel"] for p in res["ptxas"] if p["spill_bytes"]]
    return {"variant": name, "what": what, **res, "spilling": spilling}


def main() -> int:
    names = sys.argv[1:] or [n for n in VARIANTS if n != "tree"]
    for name in ["tree"] + names + ["tree"]:
        print(json.dumps(run(name)), flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
