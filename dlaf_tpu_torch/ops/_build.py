"""Build and load the port's CUDA kernels (the role
``dlaf_tpu/common/nativebuild.py`` plays for the JAX package's C++ code).

Every ``csrc/*.cu`` (with the ``csrc/*.cuh`` block bodies they share) is
compiled at first use, one ``nvcc`` per source, all started together, and
linked into a shared library with a plain C interface, which is loaded
with ``ctypes``.
The library lands in ``dlaf_tpu_torch/_build/`` (listed in ``.gitignore``)
under a name keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing is built when the package
is imported: only the first kernel launch on a CUDA tensor calls
:func:`lib`.  ptxas reports each kernel's registers and spills
(``-Xptxas -v``); a build keeps them in :data:`ptxas_report`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ULL = ctypes.c_ulonglong
#: C entry points and their argument types; every one returns the
#: ``cudaGetLastError()`` of its launch as an int
SIGNATURES = {
    # (a, out, n, stream): B1 on one block
    "dlaf_potrf_f32": [_P, _P, _I, _P],
    "dlaf_potrf_f64": [_P, _P, _I, _P],
    # (a, out, n, cluster_blocks, stream): B1 on a thread-block cluster
    "dlaf_potrf_cluster_f32": [_P, _P, _I, _I, _P],
    "dlaf_potrf_cluster_f64": [_P, _P, _I, _I, _P],
    # (ell, b, x, rows, nb, stream)
    "dlaf_panel_trsm_f32": [_P, _P, _P, _LL, _I, _P],
    "dlaf_panel_trsm_f64": [_P, _P, _P, _LL, _I, _P],
    # the same on B2's first body (the before/after reference)
    "dlaf_panel_trsm_ref_f32": [_P, _P, _P, _LL, _I, _P],
    "dlaf_panel_trsm_ref_f64": [_P, _P, _P, _LL, _I, _P],
    # (x, a, b, L, C, M, N, K, b_is_nk, stream)
    "dlaf_trailing_update_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dlaf_trailing_update_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (a, b, out, form, L, C, M, N, K, stream)
    "dlaf_panel_contract_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dlaf_panel_contract_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # the same on B3's and B9's first tile body (the before/after reference)
    "dlaf_trailing_update_ref_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dlaf_trailing_update_ref_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dlaf_panel_contract_ref_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dlaf_panel_contract_ref_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (x, a, b, ws, ws_bytes, L, C, M, N, K, b_is_nk, nslices, phases, stream): B3 under a
    # split tier; ws the workspace of the operands' bf16 planes, phases 1 the pre-pass,
    # 2 the body, 3 both
    "dlaf_trailing_update_split_f32": [_P, _P, _P, _P, _LL] + [_I] * 8 + [_P],
    "dlaf_trailing_update_split_f64": [_P, _P, _P, _P, _LL] + [_I] * 8 + [_P],
    # (a, b, out, ws, ws_bytes, form, L, C, M, N, K, nslices, phases, stream): B9 under
    # a split tier
    "dlaf_panel_contract_split_f32": [_P, _P, _P, _P, _LL] + [_I] * 8 + [_P],
    "dlaf_panel_contract_split_f64": [_P, _P, _P, _P, _LL] + [_I] * 8 + [_P],
    # (y, h, z, out, oh, x, cp, land, land_h, entry, rflag, aflag, err, ltr, ltc, M, N, K,
    #  G, P, me, nslices, epoch, timeout_ns, stream): nslices 0, 2 or 3 (the split tiers)
    "dlaf_dma_ring_consume_f32": [_P] * 13 + [_I] * 9 + [_ULL, _ULL, _P],
    "dlaf_dma_ring_consume_f64": [_P] * 13 + [_I] * 9 + [_ULL, _ULL, _P],
    # (the int64 argument array named by dlaf_fused_step_fields, nslices, stream)
    "dlaf_fused_step_f32": [_P, _I, _P],
    "dlaf_fused_step_f64": [_P, _I, _P],
    # (step, f64, nslices, ltr, ltc, mb, K, G): blocks per SM of B6 (step 0, at depth K)
    # or B8 (step 1)
    "dlaf_ring_consumer_blocks_per_sm": [_I, _I, _I, _I, _I, _I, _I, _I],
    # (dw, z2, rho, anchor, lo0, hi0, out, K, S, iters, stream)
    "dlaf_secular_bisect_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # the same on B10's first body (the before/after reference)
    "dlaf_secular_bisect_ref_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # (S, reference): blocks per SM of the instantiation rows of S elements take
    "dlaf_secular_blocks_per_sm": [_I, _I],
    # (y, y_in, h, h_in, oy, oh, total, w, slots, stream)
    "dlaf_merge_hop": [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _P],
    # (ys, hs, out, oh, entry, done, err, total, w, slots, seg, G, P, me, epoch,
    #  timeout_ns, stream): B5, the pull; ys and hs host arrays of P device pointers
    "dlaf_pull_exchange": [_P] * 7 + [_LL, _LL, _I, _LL, _I, _I, _I, _ULL, _ULL, _P],
    # (y, h, out, oh, land, land_h, entry, rflag, aflag, err, total, w, slots, seg,
    #  G, P, me, epoch, timeout_ns, stream): B5 as the hop ring
    "dlaf_ring_exchange": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _LL,
                           _I, _I, _I, _ULL, _ULL, _P],
    # (d, xc_root, cps, below, lkk, nb, ltr, root, flags, scratch, err, P, me, G, epoch,
    #  timeout_ns, stream): B7; cps a host array of P device pointers
    "dlaf_fused_factor_bcast_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I,
                                    _ULL, _ULL, _P],
    "dlaf_fused_factor_bcast_f64": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I,
                                    _ULL, _ULL, _P],
    # (f64, nb, ltr, G, out[3]): B7's blocks per SM, factor team, shared memory
    "dlaf_fused_occupancy": [_I, _I, _I, _I, _P],
    # (f64, n, cluster_blocks): clusters of B1's cluster kernel the card holds at once
    "dlaf_potrf_cluster_occupancy": [_I, _I, _I],
}

_lib = None
_lib_lock = threading.Lock()
#: held around every wrapper's launch-count increment: rank threads launch
#: concurrently, and ``launches += 1`` is not atomic
COUNT_LOCK = threading.Lock()
#: wall seconds of the last nvcc run in this process (0.0 when the cached
#: library was reused)
build_seconds = 0.0
#: what ptxas said of each kernel in the last build in this process: one
#: dict per entry function (source, kernel, registers, stack, spill stores
#: and loads in bytes); empty when the cached library was reused
ptxas_report: list = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin)")


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdlaf_tpu_torch_{h.hexdigest()[:16]}.so"


def _demangle(names: list) -> list:
    tool = shutil.which("c++filt")
    if not tool or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else names


def parse_ptxas(source: str, text: str) -> list:
    """The entry functions of one ``-Xptxas -v`` log: registers from their
    "Used N registers" line, stack and spills from their "Function
    properties" lines; then the functions called out of line (``__noinline__``
    device functions: ``"device_function": True``, their own stack and
    spills, registers None), whose spills an entry's line does not show."""
    props, entries, cur, named = {}, [], None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"source": source, "kernel": m.group(1)}
            entries.append(cur)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            named = props.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and named is not None:
            named.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    for e in entries:
        e.update(props.get(e["kernel"], {}))
    kernels = {e["kernel"] for e in entries}
    entries += [{"source": source, "kernel": name, "device_function": True, "registers": None,
                 **p} for name, p in props.items() if name not in kernels and p]
    for e, name in zip(entries, _demangle([e["kernel"] for e in entries])):
        e["kernel"] = name
    return entries


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one library unless it exists: one
    ``nvcc -c`` per source, all started together, then one link.  Raises
    ``RuntimeError`` with nvcc's output when a step fails."""
    global build_seconds, ptxas_report
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(work, src.stem + ".o")
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
            objs.append(obj)
        failed, report = [], []
        for src, (cmd, proc) in zip(sources(), procs):
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed (rc {proc.returncode}): {' '.join(cmd)}\n"
                              f"{stdout}\n{stderr}")
            else:
                report += parse_ptxas(src.name, stdout + stderr)
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(work, out.name)
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc {proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    build_seconds = time.perf_counter() - t0
    ptxas_report = report
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:  # rank threads may ask for it together: build once
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.dlaf_error_string.argtypes = [ctypes.c_int]
            handle.dlaf_error_string.restype = ctypes.c_char_p
            handle.dlaf_fused_step_fields.argtypes = []
            handle.dlaf_fused_step_fields.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = lib().dlaf_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} ({msg})")


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as an int handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
