#!/usr/bin/env python3
"""B10, the secular bisection (csrc/secular.cu), on the card: its body (each
row stopped at its bracket's fixed point, one barrier a round) against its
first body (the reference kernel, every round, two barriers), probes and
variant copies of the source, the SASS of the round loop, and path H's
eight real tables.

    python3 scripts/secular_ab.py [--no-path-h] [--sass=FILE] [VARIANT ...]

Every variant runs unless some are named.

1. Builds the tree's kernel library (ptxas's registers and spills of every
   B10 instantiation, both bodies) and, at the same time, each variant: a
   copy of csrc/secular.cu under _variants/secular/<name>/ (listed in
   .gitignore; the repository's files are never edited) with a few edits,
   compiled alone into a library of its own.  Variants named "probe_..."
   change the arithmetic (their answers are wrong; their times say where
   the time goes); the others must give the reference's bits.
2. Reads the SASS of both bodies (``cuobjdump -sass`` of the tree's
   library; with --sass=FILE, writes it to FILE) and counts, in each
   instantiation and in its round loop (the span of its backward branch),
   the divisions' instructions: MUFU.RCP, FCHK (the range check of the
   IEEE division's fast path), CALL.REL (to its out-of-line slow path),
   BRA, BSSY, BAR.SYNC.
3. On chip_smoke.py's B10 tables (``secular_tables``: "mu" and "mixed"),
   K = 8192 rows at S = 1024, 2048, 4096, 8192, drawn from the phase's
   generators afresh: the rounds each row needs (``secular_rounds_plain``),
   digests of every output, and times (CUDA events, 10 launches each) in
   turns: reference, body, each variant in order, each variant in reverse,
   body, reference.
4. Unless --no-path-h: runs path H once (chip_smoke.py's PATH_H at NH,
   NBH, SEED_H) with ``ops.secular.secular_bisect`` wrapped to keep a copy
   of each of its eight launches' (dw, z2w, rho, anchor, lo0, hi0), then
   on each table: its rounds needed, its share of zero-weight poles, both
   bodies' digests and times in turns (reference, body, body, reference),
   and each non-probe variant's digest and time.
5. Where the tree's source defines ``quotient_fast``, the branch-free
   division: compiles a check kernel with that source and holds
   ``quotient_fast`` to ``__fdiv_rn`` on 2^36 random pairs inside and
   around the range the kernel admits it in (``fold_weight``,
   ``gap_range``).

Prints one JSON line per record and the card's name and power limit;
exits non-zero if a non-probe output differs from the reference's, a
division check finds a difference, or there is no CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import dlaf_tpu_torch  # noqa: E402,F401  (before torch touches the card)

WORK = os.path.join(ROOT, "_variants", "secular")

_SPLIT = "}  // namespace first\n"  # the first body lies before it, the body after
_TERM = "  return __fdiv_rn(z2, diff == 0.0f ? FLT_MIN : diff);\n"
_FIRST_SUM = "    const float fm = __fadd_rn(1.0f, __fmul_rn(rh, block_sum(acc, red, &total)));\n"
_FIRST_UPDATE = "    if (fm < 0.0f)\n      lo = mid;\n    else\n      hi = mid;\n  }\n"
_STORE = "  if (tid == 0) out[r] = __fmul_rn(0.5f, __fadd_rn(lo, hi));\n"
_STOP = "    if (moved == __float_as_uint(mid)) break;\n"
_ROW_TERMS = ("      acc = S >= E * kThreads ? row_terms<E, true>(ag, zz, mid, S, dlo, dhi, slow)\n"
              "                              : row_terms<E, false>(ag, zz, mid, S, dlo, dhi, "
              "slow);\n"
              "      slow |= !(fabsf(mid) <= FLT_MAX);\n")
_LOOP = ("#pragma unroll\n      for (int e = 0; e < E; ++e) {\n"
         "        const bool in = tid + e * kThreads < S;\n")
_REGISTER_SUM = r"""  const float4 p = *reinterpret_cast<const float4*>(red);
  const float4 q = *reinterpret_cast<const float4*>(red + 4);
  const float a0 = __fadd_rn(p.x, 0.0f), a1 = __fadd_rn(p.y, 0.0f), a2 = __fadd_rn(p.z, 0.0f),
              a3 = __fadd_rn(p.w, 0.0f), a4 = __fadd_rn(q.x, 0.0f), a5 = __fadd_rn(q.y, 0.0f),
              a6 = __fadd_rn(q.z, 0.0f), a7 = __fadd_rn(q.w, 0.0f);
  return __fadd_rn(__fadd_rn(__fadd_rn(a0, a4), __fadd_rn(a2, a6)),
                   __fadd_rn(__fadd_rn(a1, a5), __fadd_rn(a3, a7)));
"""
_SHUFFLE_SUM = r"""  const int lane = threadIdx.x & 31;
  return warp_sum(lane < kWarps ? red[lane] : 0.0f);
"""
_TWO_BARRIERS = r"""  __shared__ float total;
  if (threadIdx.x < 32) {
    float w = threadIdx.x < kWarps ? red[threadIdx.x] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) w = __fadd_rn(w, __shfl_xor_sync(0xffffffffu, w, off));
    if (threadIdx.x == 0) total = w;
  }
  __syncthreads();
  return total;
"""
_BOUNDS = ("__launch_bounds__(kThreads, kEPT == 32 ? 2 : kEPT == 16 ? 3 : kEPT == 8 ? 5 : 6)\n"
           "secular_bisect_kernel(")
_QUOTIENT = ("  const float q = __fmul_rn(z, r);\n"
             "  return __fmaf_rn(r, __fmaf_rn(-den, q, z), q);\n")

#: name -> (what it tries, entry point it changes ("ref" or "body"),
#: [(region "first" or "body", text, its replacement)])
VARIANTS = {
    "probe_div_as_mul": (
        "probe: the first body with each division a multiplication (the division's share)",
        "ref", [("first", _TERM, "  return __fmul_rn(z2, diff == 0.0f ? FLT_MIN : diff);\n")]),
    "probe_no_reduction": (
        "probe: the first body without its round's reduction (each thread bisects on its own "
        "partial sum; every thread stores, so none of it is dead code)",
        "ref", [("first", _FIRST_SUM,
                 "    const float fm = __fadd_rn(1.0f, __fmul_rn(rh, acc));\n"),
                ("first", _STORE, "  if (tid == 0 || lo == -12345.0f) out[r] = "
                                  "__fmul_rn(0.5f, __fadd_rn(lo, hi));\n")]),
    "ref_stop": (
        "the first body stopping at the fixed point (two barriers a round, __fdiv_rn)",
        "ref", [("first", _FIRST_UPDATE,
                 "    const bool neg = fm < 0.0f;\n"
                 "    const unsigned moved = __float_as_uint(neg ? lo : hi);\n"
                 "    if (neg)\n      lo = mid;\n    else\n      hi = mid;\n"
                 "    if (moved == __float_as_uint(mid)) break;\n  }\n")]),
    "body_no_stop": (
        "the body without its stop (every round)",
        "body", [("body", _STOP, "")]),
    "body_ieee_div": (
        "the body with __fdiv_rn for every term (no branch-free division)",
        "body", [("body", _ROW_TERMS, _LOOP + "        if (in) acc = __fadd_rn(acc, "
                                              "first::term(ag[e], zz[e], mid));\n      }\n")]),
    "branch_per_element": (
        "the body with each element's quotient and range check under its own branch on the "
        "row's length",
        "body", [("body", _ROW_TERMS, _LOOP + "        if (in) {\n"
                  "          const float den = __fsub_rn(ag[e], mid);\n"
                  "          slow |= !(fabsf(den) >= dlo && fabsf(den) < dhi);\n"
                  "          acc = __fadd_rn(acc, quotient_fast(zz[e], den));\n"
                  "        }\n      }\n")]),
    "per_element_check": (
        "the body with each gap's range checked on its own (two compares an element) and the "
        "add predicated on the row's length, whole rows or not",
        "body", [("body", _ROW_TERMS, _LOOP + "        const float den = __fsub_rn(ag[e], mid);\n"
                  "        slow |= in && !(fabsf(den) >= dlo && fabsf(den) < dhi);\n"
                  "        const float q = quotient_fast(zz[e], den);\n"
                  "        if (in) acc = __fadd_rn(acc, q);\n      }\n")]),
    "two_blocks": (
        "the body with at most 128 registers a thread (two blocks an SM) at every "
        "instantiation",
        "body", [("body", _BOUNDS, "__launch_bounds__(kThreads, 2)\nsecular_bisect_kernel(")]),
    "body_shuffle_sum": (
        "the body with each warp summing the eight warp sums by the first body's butterfly "
        "of shuffles (one barrier)",
        "body", [("body", _REGISTER_SUM, _SHUFFLE_SUM)]),
    "body_two_barriers": (
        "the body with the first body's reduction (warp 0 sums, a second barrier, a shared "
        "total)",
        "body", [("body", _REGISTER_SUM, _TWO_BARRIERS)]),
    "fallback_noinline": (
        "the body with its __fdiv_rn fallback called out of line",
        "body", [("body", "__device__ __forceinline__ float row_sum_ieee(",
                  "__device__ __noinline__ float row_sum_ieee(")]),
    "three_blocks": (
        "the body with at most 85 registers a thread (three blocks an SM) at every "
        "instantiation",
        "body", [("body", _BOUNDS, "__launch_bounds__(kThreads, 3)\nsecular_bisect_kernel(")]),
    "ptxas_registers": (
        "the body with ptxas choosing its registers (no blocks an SM asked for)",
        "body", [("body", _BOUNDS, "__launch_bounds__(kThreads)\nsecular_bisect_kernel(")]),
    "probe_body_div_as_mul_no_stop": (
        "probe: the body without its stop, each quotient a multiplication",
        "body", [("body", _STOP, ""), ("body", _QUOTIENT, "  return __fmul_rn(z, den);\n")]),
}

_DIV_CHECK = r'''
#include "secular.cu"

namespace {

__device__ __forceinline__ unsigned mix(unsigned long long x) {  // splitmix64
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return (unsigned)(x ^ (x >> 31));
}

// a float of random mantissa and sign (sign_bits of the word's top), with
// its exponent uniform in [-span, span)
__device__ __forceinline__ float draw(unsigned h, unsigned g, int span, bool any_sign) {
  const int e = (int)(g % (unsigned)(2 * span)) - span;
  const unsigned sign = any_sign ? (h & 0x80000000u) : 0u;
  return __uint_as_float(sign | ((unsigned)(e + 127) << 23) | (h & 0x7fffffu));
}

__global__ void div_check_kernel(unsigned long long n, unsigned long long seed,
                                 unsigned long long* counts, unsigned* example) {
  unsigned long long admitted = 0, differ = 0;
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x; i < n;
       i += step) {
    const unsigned h[4] = {mix(seed ^ (4 * i)), mix(seed ^ (4 * i + 1)), mix(seed ^ (4 * i + 2)),
                           mix(seed ^ (4 * i + 3))};
    // weights: +0 one time in 64, otherwise normal (negative one time in 8),
    // exponents a little past the admitted range on both sides
    float z = draw(h[0], h[2] >> 8, kZE + 4, (h[2] & 7u) == 0u);
    if ((h[2] & 0xfc0u) == 0u) z = 0.0f;
    const float den = draw(h[1], h[3] >> 1, kDE + 4, true);
    int emin = 1 << 20, emax = -(1 << 20);
    bool bad = false;
    fold_weight(z, emin, emax, bad);
    float dlo, dhi;
    gap_range(emin, emax, bad, dlo, dhi);
    if (fabsf(den) >= dlo && fabsf(den) < dhi) {
      ++admitted;
      const float fast = quotient_fast(z, den), ieee = __fdiv_rn(z, den);
      if (__float_as_uint(fast) != __float_as_uint(ieee)) {
        ++differ;
        example[0] = __float_as_uint(z);
        example[1] = __float_as_uint(den);
        example[2] = __float_as_uint(fast);
        example[3] = __float_as_uint(ieee);
      }
    }
  }
  atomicAdd(&counts[0], admitted);
  atomicAdd(&counts[1], differ);
}

}  // namespace

extern "C" int dlaf_secular_div_check(unsigned long long n, unsigned long long seed, void* counts,
                                      void* example) {
  div_check_kernel<<<132 * 8, 256>>>(n, seed, static_cast<unsigned long long*>(counts),
                                     static_cast<unsigned*>(example));
  return (int)cudaGetLastError();
}
'''


def _short(kernel: str) -> str:
    """A demangled kernel name without its parameter list."""
    return re.sub(r"\([^()]*\)$", "", kernel)


def _edit(text: str, region: str, old: str, new: str, name: str) -> str:
    head, tail = text.split(_SPLIT)
    part = head if region == "first" else tail
    if part.count(old) != 1:
        raise RuntimeError(f"{name}: a text to replace occurs {part.count(old)} times in the "
                           f"{region} body")
    part = part.replace(old, new)
    return part + _SPLIT + tail if region == "first" else head + _SPLIT + part


def start_build(name: str, src: str, out: str):
    """Start nvcc on ``src`` into the shared library ``out``."""
    from dlaf_tpu_torch.ops import _build

    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", out, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(src))


def variant_sources(names: list) -> dict:
    """Write each variant's copy of secular.cu; name -> its path."""
    base = open(os.path.join(ROOT, "dlaf_tpu_torch", "csrc", "secular.cu")).read()
    paths = {}
    for name in names:
        text = base
        for region, old, new in VARIANTS[name][2]:
            text = _edit(text, region, old, new, name)
        d = os.path.join(WORK, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        paths[name] = os.path.join(d, "secular.cu")
        open(paths[name], "w").write(text)
    return paths


def sass_report(lib_path: str, out: str | None) -> dict:
    """cuobjdump -sass of the secular kernels: the text to ``out`` (if
    given), the counts per instantiation, in all and in its round loop."""
    from dlaf_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_build._nvcc()),
                                                     "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True)
    if proc.returncode != 0:
        return {"error": proc.stderr[-2000:]}
    funcs = [f for f in proc.stdout.split("Function : ")[1:] if "secular_bisect_kernel" in
             f.split("\n", 1)[0]]
    names = _build._demangle([f.split("\n", 1)[0].strip() for f in funcs])
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            for name, f in zip(names, funcs):
                fh.write(f"Function : {name}\n{f.split(chr(10), 1)[1]}\n")
    ops = ("MUFU.RCP", "FCHK", "CALL.REL", "BRA", "BSSY", "BAR.SYNC", "FFMA", "FADD", "SHFL")
    report = {}
    for name, f in zip(names, funcs):
        ins = []
        for line in f.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                ins.append((int(m.group(1), 16), m.group(2)))

        def count(seq):
            return {op: sum(1 for _, s in seq if re.search(r"(^|\s|\})" + re.escape(op) + r"\b",
                                                           s)) for op in ops} | {"all": len(seq)}

        loops = []
        for addr, s in ins:
            m = re.search(r"\bBRA[\w.]*\s+.*?(0x[0-9a-f]+)", s)
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
        span = max(loops, key=lambda ab: ab[1] - ab[0]) if loops else None
        report[_short(name)] = {
            "all": count(ins),
            "round_loop": count([(a, s) for a, s in ins if span and span[0] <= a <= span[1]])
            if span else None,
            "round_loop_bytes": [hex(span[0]), hex(span[1])] if span else None}
    return report


def bind(path: str):
    from dlaf_tpu_torch.ops import _build

    lib = ctypes.CDLL(path)
    for fn in ("dlaf_secular_bisect_f32", "dlaf_secular_bisect_ref_f32"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def runner(lib, entry: str):
    """fn(args, iters) -> a new (K,) output, launched through ``lib``'s ``entry``."""
    import torch

    from dlaf_tpu_torch.ops import _build

    f = getattr(lib, entry)

    def run(args, iters, out=None):
        dw = args[0]
        out = torch.empty(dw.shape[0], device=dw.device) if out is None else out
        rc = f(*(t.data_ptr() for t in args), out.data_ptr(), dw.shape[0], dw.shape[1], iters,
               _build.stream_of(dw))
        if rc:
            raise RuntimeError(f"{entry}: launch failed with error {rc}")
        return out
    return run


def capture_path_h() -> list:
    """Path H's eight secular tables, as its launches gave them."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import tune
    from dlaf_tpu_torch.ops import secular
    from dlaf_tpu_torch.testing import random_hermitian_pd

    a_low = torch.from_numpy(np.tril(random_hermitian_pd(cs.NH, np.float32, seed=cs.SEED_H)))
    tune.initialize(**cs.PATH_H)
    seen, wrapper = [], secular.secular_bisect

    def capturing(*args):
        seen.append(tuple(t.clone() for t in args[:6]) + (args[6],))
        return wrapper(*args)

    secular.secular_bisect = capturing
    try:
        mat = dtt.DistributedMatrix.from_global(dtt.Grid.create(), a_low.cuda(), (cs.NBH, cs.NBH))
        dtt.hermitian_eigensolver("L", mat, backend="pipeline")
        torch.cuda.synchronize()
    finally:
        secular.secular_bisect = wrapper
    return seen


def main(argv: list) -> int:
    import torch

    import chip_smoke as cs
    from dlaf_tpu_torch.ops import _build, secular

    if not torch.cuda.is_available():
        print("secular_ab: no CUDA device", flush=True)
        return 2
    path_h = "--no-path-h" not in argv
    sass = next((a.split("=", 1)[1] for a in argv if a.startswith("--sass=")), None)
    names = [a for a in argv if not a.startswith("--")] or list(VARIANTS)
    card = cs.card_line()
    stamp = {"card": card}
    print(f"card: {card}", flush=True)

    # 1. every library at once: the variants' nvcc, then the tree's build
    srcs = variant_sources(names)
    procs = {n: start_build(n, p, os.path.join(WORK, n, "lib.so")) for n, p in srcs.items()}
    tree_lib = str(_build.build())
    _build.lib()
    cs.emit({"phase": "ptxas", "kernels": [e for e in _build.ptxas_report
                                           if "secular" in e["kernel"]], **stamp})
    libs = {}
    for n, proc in procs.items():
        out, err = proc.communicate()
        ptx = [{"kernel": _short(e["kernel"]), "registers": e.get("registers"),
                "spill_bytes": (e.get("spill_stores") or 0) + (e.get("spill_loads") or 0)}
               for e in _build.parse_ptxas("secular.cu", out + err)]
        if proc.returncode:
            cs.emit({"variant": n, "nvcc_failed": (out + err)[-3000:]})
            continue
        libs[n] = bind(os.path.join(WORK, n, "lib.so"))
        cs.emit({"variant": n, "what": VARIANTS[n][0], "ptxas": ptx})

    # 2. the SASS of both bodies
    cs.emit({"phase": "sass", "file": sass, "kernels": sass_report(tree_lib, sass), **stamp})

    tree = bind(tree_lib)
    ref_run = runner(tree, "dlaf_secular_bisect_ref_f32")
    new_run = runner(tree, "dlaf_secular_bisect_f32")
    var_run = {n: runner(lib, "dlaf_secular_bisect_ref_f32" if VARIANTS[n][1] == "ref"
                         else "dlaf_secular_bisect_f32") for n, lib in libs.items()}
    bad = []

    def compare(label, args, iters, order, reps=10):
        """Digests and times of the reference, the body and ``order``'s
        variants on one table, in turns."""
        ref = ref_run(args, iters)
        outs = {"body": new_run(args, iters), **{n: var_run[n](args, iters) for n in order}}
        torch.cuda.synchronize()
        rd = cs.digest(ref)
        same = {n: cs.digest(o) == rd for n, o in outs.items()}
        for n, ok in same.items():
            if not ok and not n.startswith("probe_"):
                rows = int(outs[n].view(torch.int32).ne(ref.view(torch.int32)).sum())
                bad.append(f"{label}: {n} differs from the reference in {rows} rows")
        seq = ["reference", "body", *order, *order[::-1], "body", "reference"]
        fns = {"reference": ref_run, "body": new_run, **var_run}
        out = torch.empty_like(ref)
        ms = {}
        for n in seq:
            ms.setdefault(n, []).append(cs.timed_ms(lambda f=fns[n]: f(args, iters, out), reps))
        return {"bitwise_vs_reference": same, "reference_digest": rd, "ms": ms}

    # 3. the phase's tables
    kgen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    order = list(libs)
    for ss in cs.S_B10:
        for label, (args, _) in cs.secular_tables(kgen, gen, cs.K_B10, ss).items():
            need = secular.secular_rounds_plain(*args, cs.ITERS_B10)
            kk = cs.K_B10
            rec = {"table": label, "shape": [kk, ss],
                   "rounds_needed_mean": need.double().mean().item(),
                   "share_needing_all": (need == cs.ITERS_B10).double().mean().item(),
                   "bound_ms": cs.bound(4.0 * ss * need.sum().item(), (2 * kk * ss + 5 * kk) * 4),
                   "bound_42_rounds_ms": cs.bound(4.0 * cs.ITERS_B10 * kk * ss,
                                                  (2 * kk * ss + 5 * kk) * 4),
                   **compare(f"S={ss} {label}", args, cs.ITERS_B10, order), **stamp}
            cs.emit(rec)
            del args, need
        torch.cuda.empty_cache()

    # 4. path H's eight tables
    if path_h:
        tables = capture_path_h()
        keep = [n for n in order if not n.startswith("probe_")]
        for i, (dw, z2w, rho, anchor, lo0, hi0, iters) in enumerate(tables):
            args = (dw, z2w, rho, anchor, lo0, hi0)
            kk, ss = dw.shape
            need = secular.secular_rounds_plain(*args, iters)
            side = "mu" if bool((lo0 == 0).all()) else "nu" if bool((hi0 == 0).all()) else "?"
            cs.emit({"path_h_table": i, "side": side, "shape": [kk, ss], "iters": iters,
                     "rounds_needed_mean": need.double().mean().item(),
                     "share_needing_all": (need == iters).double().mean().item(),
                     "rounds_histogram": torch.bincount(need, minlength=iters + 1).tolist(),
                     "zero_weight_share": (z2w == 0).double().mean().item(),
                     "bound_ms": cs.bound(4.0 * ss * need.sum().item(),
                                          (2 * kk * ss + 5 * kk) * 4),
                     **compare(f"path H table {i}", args, iters, keep), **stamp})
        del tables
        torch.cuda.empty_cache()

    # 5. the branch-free division against __fdiv_rn
    checks = {}
    tree_src = os.path.join(ROOT, "dlaf_tpu_torch", "csrc", "secular.cu")
    if "quotient_fast" in open(tree_src).read():
        os.makedirs(os.path.join(WORK, "tree"), exist_ok=True)
        shutil.copy(tree_src, os.path.join(WORK, "tree", "secular.cu"))
        checks["tree"] = os.path.join(WORK, "tree", "secular.cu")
    for n, p in checks.items():
        src = os.path.join(os.path.dirname(p), "div_check.cu")
        open(src, "w").write(_DIV_CHECK)
        lib_path = os.path.join(os.path.dirname(p), "div_check.so")
        proc = start_build(n, src, lib_path)
        out, err = proc.communicate()
        if proc.returncode:
            bad.append(f"{n}: the division check did not build")
            cs.emit({"div_check": n, "nvcc_failed": (out + err)[-3000:]})
            continue
        lib = ctypes.CDLL(lib_path)
        lib.dlaf_secular_div_check.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong,
                                               ctypes.c_void_p, ctypes.c_void_p]
        counts = torch.zeros(2, dtype=torch.int64, device="cuda")
        example = torch.zeros(4, dtype=torch.int32, device="cuda")
        pairs = 1 << 36
        for seed in range(4):
            rc = lib.dlaf_secular_div_check(pairs // 4, 0x5EC0 + seed, counts.data_ptr(),
                                            example.data_ptr())
            if rc:
                raise RuntimeError(f"div check launch failed with error {rc}")
        torch.cuda.synchronize()
        admitted, differ = counts.tolist()
        rec = {"div_check": n, "pairs": pairs, "admitted": admitted, "differ": differ,
               "example_z_den_fast_ieee_bits": [hex(v & 0xffffffff) for v in example.tolist()]
               if differ else None, **stamp}
        cs.emit(rec)
        if differ:
            bad.append(f"{n}: quotient_fast differs from __fdiv_rn on {differ} admitted pairs")

    shutil.rmtree(WORK, ignore_errors=True)
    print(card, flush=True)
    print(json.dumps({"secular_ab": "failed" if bad else "passed", "problems": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
