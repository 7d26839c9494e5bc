#!/usr/bin/env python3
"""Time B6 and B8 on variants of their sources, each built in a copy.

    python3 scripts/consume_variants.py [NAME ...]   # every variant by default

Each variant is a few edits of dlaf_tpu_torch/csrc/ made in a copy of
dlaf_tpu_torch/ under _variants/<name>/ (listed in .gitignore; the
repository's own files are never edited).  The copy builds its kernels in
a process of its own and times, at step 0 of path M4 on the 2x4 grid (the
inputs of chip_smoke.py), B8 and B6 at the 'default' tier and under
bf16x3 (device span of 3 calls on every rank, twice), B6 also at step 0
of path M5 (nb = 192), and reports ptxas's
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
_SPLIT_COMPUTE = ("      if (active()) compute_slice<T, NS>(acc, st0 + (t % kStages) * G::STAGE, "
                  "sb, rp, ncols, kt);\n")
_SPLIT_STORE = "    if (active()) store<T, NS>(x, ltc, j, M, N, rows, ncols, c0, r0, acc);\n"
_NEVER = "if (active() && acc[0][0][0][0] == 12345.678f)"  # a probe's skipped part

#: name -> (what it tries, [(file under csrc/, text, its replacement)])
VARIANTS = {
    "tree": ("the sources as they are", []),
    # B8's split update behind a call, as its first split body had it
    "called_split_update": (
        "B8's split consume phase behind a call (__noinline__), B6's inlined",
        [("consume.cu", "template <typename T, int NS>\nstruct ConsumeHooks {",
          "template <typename T, int NS>\n__device__ __noinline__ void apply_rows_called("
          "const Panel<T>& p, const T* src, int j, int r0, void* sm) {\n"
          "  apply_rows<T, NS>(p, src, j, r0, sm);\n}\n\n"
          "template <typename T, int NS, bool kCalled = false>\nstruct ConsumeHooks {"),
         ("consume.cu", "      apply_rows<T, NS>(p, src, j, r0, dlaf_smem);\n",
          "      if constexpr (kCalled) apply_rows_called<T, NS>(p, src, j, r0, dlaf_smem);\n"
          "      else apply_rows<T, NS>(p, src, j, r0, dlaf_smem);\n"),
         ("consume.cu", "  ConsumeHooks<T, NS> hooks{a.p,",
          "  ConsumeHooks<T, NS, NS != 0> hooks{a.p,")]),
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
    # probes of the split body (csrc/consume_split.cuh): what each part of a
    # slice's work costs at bf16x3
    "split_probe_no_epilogue": (
        "probe: the split body without its epilogue (x never read or written)",
        [("consume_split.cuh", _SPLIT_STORE,
          _SPLIT_STORE.replace("if (active())", _NEVER))]),
    "split_probe_no_products": (
        "probe: the split body without its products (copies, cuts and epilogue only)",
        [("consume_split.cuh", _SPLIT_COMPUTE,
          _SPLIT_COMPUTE.replace("if (active())", _NEVER))]),
    "split_probe_products_twice": (
        "probe: the split body's products of each slice twice (copies and cuts once)",
        [("consume_split.cuh", _SPLIT_COMPUTE, _SPLIT_COMPUTE + _SPLIT_COMPUTE)]),
    "split_parts_1": (
        "the split body as one pipeline of the whole block (128-row tiles at bf16x3)",
        [("consume_split.cuh", "constexpr int kParts = 4;", "constexpr int kParts = 1;")]),
    "split_parts_2": (
        "the split body as two pipelines of 8 warps (64-row tiles at bf16x3)",
        [("consume_split.cuh", "constexpr int kParts = 4;", "constexpr int kParts = 2;")]),
    "split_stages_5": (
        "the split body with five stages (three slices in flight beyond the one cut)",
        [("consume_split.cuh", "constexpr int kStages = 4;", "constexpr int kStages = 5;")]),
    "split_probe_no_prefetch": (
        "probe: the split body without its L2 prefetch of x",
        [("consume_split.cuh", "    prefetch_x<T, NS>(x, ltc, j, M, N, rows, ncols, c0, r0);\n",
          "")]),
    "split_probe_cp_from_l2": (
        "probe: every tile's cp copies read the panel's first tile (L2-resident)",
        [("consume_split.cuh", "        const int gr = (part + kParts * tl) * G::BM + cr + p * RPC;\n",
          "        const int gr = cr + p * RPC + 0 * tl;\n")]),
    "split_probe_no_copies": (
        "probe: no cp copies after the first stages (the products read stale stages)",
        [("consume_split.cuh", "    if (t < total) {\n      const int ct = tid_now() % kPart,",
          "    if (t < kStages - 1) {\n      const int ct = tid_now() % kPart,")]),
    "split_tid_held": (
        "the split body with threadIdx.x read once (the offsets derived from it hoisted)",
        [("consume_split.cuh",
          '  asm volatile("mov.b32 %0, %1;\\n" : "=r"(t) : "r"((int)threadIdx.x));\n',
          "  t = threadIdx.x;\n")]),
    "split_tid_reread": (
        "the split body reading %tid.x again at each use",
        [("consume_split.cuh",
          '  asm volatile("mov.b32 %0, %1;\\n" : "=r"(t) : "r"((int)threadIdx.x));\n',
          '  asm volatile("mov.u32 %0, %%tid.x;\\n" : "=r"(t));\n')]),
    "split_probe_no_cut": (
        "probe: the split body's cp slices not cut (the products read the landed values)",
        [("consume_split.cuh", "      if (t + 1 < total) cut_stage(t + 1);\n", "")]),
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
del g, x0, cp, taken, have, supp, below1, x, args
torch.cuda.empty_cache()
g, x0, cp, taken, have, supp, below1 = cs._step0(gpu, a_glob, cs.NB_M5)
args = [taken, have, cp, supp, below1]
for tier in ("default", "bf16x3"):
    x = x0.clone()
    with tune.gemm_precision_scope(tier):
        cs.on_ranks(gpu, b6, [x] + args)
        ms["dma_ring_consume_M5_" + tier] = [cs.grid_span_ms(gpu, b6, [x] + args, 3)[0]
                                             for _ in range(2)]
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
