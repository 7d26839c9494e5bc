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
:func:`lib`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
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
    "-Xcompiler", "-fPIC",
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
    # (x, a, b, L, C, M, N, K, b_is_nk, stream)
    "dlaf_trailing_update_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dlaf_trailing_update_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (a, b, out, form, L, C, M, N, K, stream)
    "dlaf_panel_contract_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dlaf_panel_contract_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (x, a, b, L, C, M, N, K, b_is_nk, nslices, stream): B3 under a split tier
    "dlaf_trailing_update_split_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "dlaf_trailing_update_split_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # (a, b, out, form, L, C, M, N, K, nslices, stream): B9 under a split tier
    "dlaf_panel_contract_split_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "dlaf_panel_contract_split_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # (y, h, z, out, oh, x, cp, land, land_h, entry, rflag, aflag, err, ltr, ltc, M, N, K,
    #  G, P, me, epoch, timeout_ns, stream)
    "dlaf_dma_ring_consume_f32": [_P] * 13 + [_I] * 8 + [_ULL, _ULL, _P],
    "dlaf_dma_ring_consume_f64": [_P] * 13 + [_I] * 8 + [_ULL, _ULL, _P],
    # (the int64 argument array named by dlaf_fused_step_fields, stream)
    "dlaf_fused_step_f32": [_P, _P],
    "dlaf_fused_step_f64": [_P, _P],
    # (dw, z2, rho, anchor, lo0, hi0, out, K, S, iters, stream)
    "dlaf_secular_bisect_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # (y, y_in, h, h_in, oy, oh, total, w, slots, stream)
    "dlaf_merge_hop": [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _P],
    # (ys, hs, out, oh, entry, done, err, total, w, slots, seg, G, P, me, epoch,
    #  timeout_ns, stream): B5, the pull; ys and hs host arrays of P device pointers
    "dlaf_pull_exchange": [_P] * 7 + [_LL, _LL, _I, _LL, _I, _I, _I, _ULL, _ULL, _P],
    # (y, h, out, oh, land, land_h, entry, rflag, aflag, err, total, w, slots, seg,
    #  G, P, me, epoch, timeout_ns, stream): B5 as the hop ring
    "dlaf_ring_exchange": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _LL,
                           _I, _I, _I, _ULL, _ULL, _P],
    # (d, xc, below, lkk, cp, nb, rows, is_root, ready, land, land_h, entry, rflag,
    #  aflag, err, P, me, G, epoch, timeout_ns, stream)
    "dlaf_fused_factor_bcast_f32": [_P, _P, _P, _P, _P, _I, _LL, _I, _P, _P, _P, _P, _P,
                                    _P, _P, _I, _I, _I, _ULL, _ULL, _P],
    "dlaf_fused_factor_bcast_f64": [_P, _P, _P, _P, _P, _I, _LL, _I, _P, _P, _P, _P, _P,
                                    _P, _P, _I, _I, _I, _ULL, _ULL, _P],
}

_lib = None
_lib_lock = threading.Lock()
#: held around every wrapper's launch-count increment: rank threads launch
#: concurrently, and ``launches += 1`` is not atomic
COUNT_LOCK = threading.Lock()
#: wall seconds of the last nvcc run in this process (0.0 when the cached
#: library was reused)
build_seconds = 0.0


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


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one library unless it exists: one
    ``nvcc -c`` per source, all started together, then one link.  Raises
    ``RuntimeError`` with nvcc's output when a step fails."""
    global build_seconds
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
        failed = []
        for cmd, proc in procs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed (rc {proc.returncode}): {' '.join(cmd)}\n"
                              f"{stdout}\n{stderr}")
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
