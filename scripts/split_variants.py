#!/usr/bin/env python3
"""Time B3-split and B9-split on variants of their sources, each built in a copy.

    python3 scripts/split_variants.py [NAME ...]   # every variant by default

Each variant is a few edits of dlaf_tpu_torch/csrc/ made in a copy under
_variants/split/<name>/ (listed in .gitignore; the repository's own files
are never edited).  Only the copy's trailing_update.cu (B3 and B9, with
csrc/split_gemm.cuh) is compiled, into a library of its own; every
variant's nvcc runs at once.  Each library is then loaded in turn and
times, by CUDA events, B3-split at chip_smoke.py's four split_phase shapes
(bf16x3 f32 at 32 x 32 x 512^2, 32 x 1 x 512^2 and red2band's 16 x 16 x
512^2 with K = 128; bf16x6 f64 at 16 x 16 x 512^2) and B9-split on one
rank's share of path I's widest step (a [16, 8, 512, 512] or [16, 512,
512], bf16x3 f32), both forms: the whole call, the pre-pass alone and the
body alone.  It reports ptxas's registers and spills of the split
kernels and whether each output is bit for bit the unmodified tree's
(variants marked "probe" change the arithmetic: their times say where the
body's time goes).  The unmodified tree runs first and last.  Prints one
JSON line per run and the card's name and power limit; needs a CUDA
device.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "_variants", "split")
sys.path.insert(0, ROOT)

_STORE = "      tile(ci, o, m0, n0);\n      store<T, G, kSub>("
_COMPUTE = "    compute_stage<G>(acc, sm + cring * G::STAGE);\n"
_NEVER = "if (acc[0][0][0][0] == 12345.678f) "  # a probe's skipped part
_TILE = "using SplitBody = dlaf_split::Body<NS, !kSub && sizeof(T) == 4>;"
_STAGES = "  static constexpr int kStages = 3;\n"
_PREFETCH = "      prefetch_x<T, G>(x + o * j.M * (long long)j.N, j.M, j.N, m0, n0);\n"

#: name -> (what it tries, [(file under csrc/, text, its replacement)])
VARIANTS = {
    "tree": ("the sources as they are", []),
    "all_narrow": ("128 x 64 tiles at bf16x3 for B9 in f32 too",
                   [("trailing_update.cu", _TILE, "using SplitBody = dlaf_split::Body<NS, false>;")]),
    "all_wide": ("128 x 128 tiles at bf16x3 for B3 and for B9 in f64 too",
                 [("trailing_update.cu", _TILE, "using SplitBody = dlaf_split::Body<NS, true>;")]),
    "ns3_128x64": (
        "bf16x6 on 128 x 64 tiles (warps of 32 x 32, 192 accumulators a thread)",
        [("split_gemm.cuh", "  static constexpr int NI = NS == 2 ? 4 : 2;            // n8 blocks a warp\n",
          "  static constexpr int NI = 4;\n"),
         ("split_gemm.cuh", "  static constexpr int WM = NS == 2 && !kWide ? 4 : 2;  // warps down the tile\n",
          "  static constexpr int WM = NS == 3 || !kWide ? 4 : 2;\n")]),
    "stages_2": ("two stages", [("split_gemm.cuh", _STAGES,
                                 "  static constexpr int kStages = 2;\n")]),
    "stages_4": ("four stages", [("split_gemm.cuh", _STAGES,
                                  "  static constexpr int kStages = 4;\n")]),
    "put_batch_16": (
        "the epilogue's loads of x in batches of 16 a thread",
        [("split_gemm.cuh", "J = O::ROWS * PR / G::kThreads, JB = J < 8 ? J : 8;",
          "J = O::ROWS * PR / G::kThreads, JB = J < 16 ? J : 16;")]),
    "no_prefetch": ("x not prefetched to L2 (B3)", [("split_gemm.cuh", _PREFETCH, "")]),
    "probe_no_epilogue": (
        "probe: no epilogue (x and out never read or written)",
        [("split_gemm.cuh", _STORE, _STORE.replace("store<", _NEVER + "store<"))]),
    "probe_no_products": (
        "probe: no products (copies, barriers and epilogue only)",
        [("split_gemm.cuh", _COMPUTE, "    " + _NEVER + _COMPUTE.lstrip())]),
    "probe_products_twice": (
        "probe: each stage's products twice (the copies and barriers once)",
        [("split_gemm.cuh", _COMPUTE, _COMPUTE + _COMPUTE)]),
}


def build(name: str):
    """Start the nvcc of one variant's trailing_update.cu; returns (copy, process)."""
    from dlaf_tpu_torch.ops import _build

    what, edits = VARIANTS[name]
    copy = os.path.join(WORK, name)
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "dlaf_tpu_torch", "csrc"), copy)
    for fname, old, new in edits:
        path = os.path.join(copy, fname)
        text = open(path).read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: a text to replace occurs {text.count(old)} times in "
                               f"{fname}")
        open(path, "w").write(text.replace(old, new))
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", os.path.join(copy, "lib.so"),
           os.path.join(copy, "trailing_update.cu")]
    return copy, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)


def measure(name: str, copy: str, log: str) -> dict:
    import torch

    from dlaf_tpu_torch.ops import _build
    from dlaf_tpu_torch.ops import trailing_update as tu

    lib = ctypes.CDLL(os.path.join(copy, "lib.so"))
    for fn in ("dlaf_trailing_update_split_f32", "dlaf_trailing_update_split_f64",
               "dlaf_panel_contract_split_f32"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    ptxas = [{"kernel": e["kernel"].split("(")[1].split("::")[-1] if "(" in e["kernel"]
              else e["kernel"],
              "registers": e.get("registers"),
              "spill_bytes": (e.get("spill_stores") or 0) + (e.get("spill_loads") or 0)}
             for e in _build.parse_ptxas("trailing_update.cu", log)
             if "split_" in e["kernel"] and not e.get("device_function")]
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dt)

    def timed(fn, iters):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    def check(rc):
        if rc:
            raise RuntimeError(f"{name}: launch failed with error {rc}")

    ms, digests = {}, {}
    for label, sub, L, C, K, dt, ns, iters in (
            ("B3 iab,jcb 32x32", tu.CHOLESKY_SUBSCRIPTS, 32, 32, 512, torch.float32, 2, 5),
            ("B3 iab,jbc 32x1", tu.TRSM_SUBSCRIPTS, 32, 1, 512, torch.float32, 2, 20),
            ("B3 red2band K=128", tu.CHOLESKY_SUBSCRIPTS, 16, 16, 128, torch.float32, 2, 10),
            ("B3 f64 bf16x6 16x16", tu.CHOLESKY_SUBSCRIPTS, 16, 16, 512, torch.float64, 3, 5)):
        M = N = 512
        b_nk = sub == tu.CHOLESKY_SUBSCRIPTS
        x0 = randn(L, C, M, N, dt=dt)
        a = randn(L, M, K, dt=dt)
        b = randn(*((C, N, K) if b_nk else (C, K, N)), dt=dt)
        ws = tu._split_workspace(L * M + C * N, K, ns, "cuda")
        fn = lib.dlaf_trailing_update_split_f32 if dt == torch.float32 else \
            lib.dlaf_trailing_update_split_f64
        x = x0.clone()

        def call(phases, x=x, a=a, b=b, ws=ws, fn=fn, L=L, C=C, K=K, b_nk=b_nk, ns=ns):
            check(fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), ws.data_ptr(), ws.numel(), L, C,
                     M, N, K, int(b_nk), ns, phases, _build.stream_of(x)))

        call(3)
        torch.cuda.synchronize()
        digests[label] = hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
        ms[label] = [timed(lambda: call(3), iters), timed(lambda: call(1), iters),
                     timed(lambda: call(2), iters)]
        del x0, a, b, ws, x
        torch.cuda.empty_cache()
    nb = 512
    big, small_l, small_u = randn(16, 8, nb, nb), randn(8, nb, nb), randn(16, nb, nb)
    for label, form, a, b, L, C in (("B9 ijab,jbc", 0, big, small_l, 16, 8),
                                    ("B9 iab,ijbc", 1, small_u, big, 16, 8)):
        rows = (L * C * nb + C * nb) if form == 0 else (L * nb + L * C * nb)
        ws = tu._split_workspace(rows, nb, 2, "cuda")
        out = torch.empty((L if form == 0 else C), nb, nb, device="cuda")

        def call(phases, a=a, b=b, ws=ws, out=out, form=form, L=L, C=C):
            check(lib.dlaf_panel_contract_split_f32(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(), form, L,
                C, nb, nb, nb, 2, phases, _build.stream_of(out)))

        call(3)
        torch.cuda.synchronize()
        digests[label] = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        ms[label] = [timed(lambda: call(3), 5), timed(lambda: call(1), 5),
                     timed(lambda: call(2), 5)]
        del ws, out
    del big, small_l, small_u
    torch.cuda.empty_cache()
    return {"ms_call_prepass_body": ms, "digests": digests, "ptxas": ptxas}


def main() -> int:
    import torch  # noqa: F401  (the card is touched by measure only)

    names = sys.argv[1:] or [n for n in VARIANTS if n != "tree"]
    built = {}
    for name in dict.fromkeys(["tree"] + names):
        built[name] = build(name)
    logs = {}
    for name, (copy, proc) in built.items():
        out, err = proc.communicate()
        logs[name] = out + err
        if proc.returncode != 0:
            print(json.dumps({"variant": name, "nvcc_failed": (out + err)[-3000:]}), flush=True)
    runs, ref = [], None
    for name in ["tree"] + names + ["tree"]:
        if not os.path.exists(os.path.join(built[name][0], "lib.so")):
            continue
        res = measure(name, built[name][0], logs[name])
        ref = ref or res["digests"]
        same = {k: v == ref[k] for k, v in res["digests"].items()}
        rec = {"variant": name, "what": VARIANTS[name][0], **res,
               "bitwise_vs_tree": all(same.values()),
               "spilling": [p["kernel"] for p in res["ptxas"] if p["spill_bytes"]]}
        rec.pop("digests")
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
