"""The host bulge chase: build and bind ``csrc/host/band2trid.cpp``.

The C++ source is a copy of ``dlaf_tpu/native/band2trid.cpp`` (plain C++
with threads, no framework): the Householder bulge chase that reduces a
small-band symmetric matrix to tridiagonal form on the host, keeping the
compact reflector set for the band back-transform, and the rotation sweep
that keeps no transform, for eigenvalues only.  The JAX package runs
the same chase on the host by default on CPU backends.

It is compiled at first use with ``g++ -O3 -std=c++17 -fPIC -shared
-lpthread`` into the git-ignored ``dlaf_tpu_torch/_build/``, under a name
keyed by a hash of the source and flags, and loaded with ``ctypes`` (the
role ``dlaf_tpu/native/__init__.py`` plays for the JAX package).  Nothing
is built when the module is imported.  A failed build raises: the port
has no dense host band stage to fall back to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "band2trid.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
LIBS = ["-lpthread"]

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdlaf_band2trid_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the chase unless the keyed library exists; raises
    ``RuntimeError`` with g++'s output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("the host bulge chase needs g++ (not found on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [gxx, *GXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed (rc {proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out


def lib() -> ctypes.CDLL:
    """The loaded chase library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            i64 = ctypes.c_int64
            handle.dlaf_b2t_hh_count.restype = i64
            handle.dlaf_b2t_hh_count.argtypes = [i64, i64]
            for name, scalar in (("dlaf_band2trid_hh_d", ctypes.c_double),
                                 ("dlaf_band2trid_hh_s", ctypes.c_float)):
                fn = getattr(handle, name)
                fn.restype = ctypes.c_int
                p = ctypes.POINTER(scalar)
                fn.argtypes = [i64, i64, p, p, p, p, p, ctypes.c_int]
            for name, scalar in (("dlaf_band2trid_d", ctypes.c_double),
                                 ("dlaf_band2trid_s", ctypes.c_float)):
                fn = getattr(handle, name)
                fn.restype = ctypes.c_int
                p = ctypes.POINTER(scalar)
                fn.argtypes = [i64, i64, p, p, p, p, ctypes.c_int]
            _lib = handle
    return _lib


_NAMES = {np.dtype(np.float64): "dlaf_band2trid_hh_d", np.dtype(np.float32): "dlaf_band2trid_hh_s"}


def band2trid_hh(ab: np.ndarray, band: int, nthreads: int = 0):
    """Householder-sweep band -> tridiagonal reduction of the compact
    lower-band storage ``ab[band+2, n]`` (``ab[d, j] = A[j+d, j]``, last row
    zero scratch).  Returns ``(d, e, V[R, band], tau[R])``: the reflectors
    in slot order (sweep ascending, chase step ascending; ``v[0] = 1``,
    zero-padded).  Real dtypes only; raises on a failed build or call."""
    ab = np.asfortranarray(ab)
    if ab.dtype not in _NAMES:
        raise TypeError(f"band2trid_hh: dtype {ab.dtype} not in (float32, float64)")
    if ab.shape[0] < band + 2:
        raise ValueError(f"band2trid_hh: storage has {ab.shape[0]} rows, need band + 2 = {band + 2}")
    handle = lib()
    n = ab.shape[1]
    r_total = int(handle.dlaf_b2t_hh_count(n, band))
    d = np.zeros(n, ab.dtype)
    e = np.zeros(max(n - 1, 0), ab.dtype)
    # C writes v_out[i + slot*band]: a C-contiguous [R, band] array matches
    v = np.zeros((r_total, max(band, 1)), ab.dtype)
    tau = np.zeros(max(r_total, 1), ab.dtype)
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 16)
    ptr = ctypes.POINTER(ctypes.c_double if ab.dtype == np.float64 else ctypes.c_float)
    rc = getattr(handle, _NAMES[ab.dtype])(
        n, band, ab.ctypes.data_as(ptr), d.ctypes.data_as(ptr), e.ctypes.data_as(ptr),
        v.ctypes.data_as(ptr), tau.ctypes.data_as(ptr), nthreads,
    )
    if rc != 0:
        raise RuntimeError(f"band2trid_hh: the host chase returned {rc}")
    return d, e, v, tau[:r_total]


def band2trid(ab: np.ndarray, band: int, nthreads: int = 0):
    """The eigenvalues-only chase: the rotation sweep of the same source
    (``dlaf_band2trid_d``/``_s``, the JAX package's ``band2trid_native``
    with ``want_q=False``) on the compact lower-band storage ``ab[band+2,
    n]``, with no transform kept.  Returns ``(d, e)``; real dtypes only;
    raises on a failed build or call."""
    names = {np.dtype(np.float64): "dlaf_band2trid_d", np.dtype(np.float32): "dlaf_band2trid_s"}
    if ab.dtype not in names:
        raise TypeError(f"band2trid: dtype {ab.dtype} not in (float32, float64)")
    if ab.shape[0] < band + 2:
        raise ValueError(f"band2trid: storage has {ab.shape[0]} rows, need band + 2 = {band + 2}")
    ab = np.array(ab[: band + 2], order="F", copy=True)  # the chase works in place
    n = ab.shape[1]
    d = np.zeros(n, ab.dtype)
    e = np.zeros(max(n - 1, 0), ab.dtype)
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 16)
    ptr = ctypes.POINTER(ctypes.c_double if ab.dtype == np.float64 else ctypes.c_float)
    rc = getattr(lib(), names[ab.dtype])(n, band, ab.ctypes.data_as(ptr), d.ctypes.data_as(ptr),
                                         e.ctypes.data_as(ptr), None, nthreads)
    if rc != 0:
        raise RuntimeError(f"band2trid: the host chase returned {rc}")
    return d, e
