"""Cholesky of one tile: the hand-written CUDA kernel ``csrc/potrf.cu`` and
its plain PyTorch version.

Replaces ``dlaf_tpu/ops/pallas_potrf.py`` (``potrf_tile`` /
``_potrf_kernel``): the lower Cholesky factor of an (n, n) real tile whose
lower triangle is read (the tile is hermitized from it), with the upper
triangle of the result zero.

On the H100 an n=512 f32 tile takes 44.7 MFlop and moves 2 MiB: a
single-tile factor is bound by its n sequential pivot steps, not by bytes
or FLOP/s.  The TPU kernel keeps the whole tile in VMEM; an nb=512 f32 tile
(1 MiB) does not fit a block's 227 KB of shared memory, so the CUDA kernel
is blocked: one block factors a narrow column panel (32 wide, narrower for
large tiles) held in shared memory, with one ``__syncthreads()`` per
column, then applies that panel's rank-32 update to the trailing lower
triangle, which stays in device memory (the 50 MB L2 holds it).  See
``PERF.md`` for its measured time.
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch.ops import _build

#: launches of the CUDA kernel since the last reset (plain-version calls
#: on CPU tensors do not count)
launches = 0

#: shared memory one block may use (H100: 227 KB) and the narrowest panel
#: the kernel takes; tiles whose panel does not fit are refused
_SMEM_BYTES = 232448
_MIN_PANEL = 8


def supported(a) -> bool:
    """The JAX package's static gate (``pallas_potrf.supported``): real,
    square, side a multiple of 8."""
    return (
        not a.dtype.is_complex
        and a.dtype.is_floating_point
        and a.dim() >= 2
        and a.shape[-1] == a.shape[-2]
        and a.shape[-1] % 8 == 0
    )


def potrf_tile_plain(a: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's arithmetic in PyTorch: hermitize from the lower
    triangle, then n right-looking rank-1 sweeps (``_potrf_kernel``).  The
    sweep touches only the trailing block, which is where the masked TPU
    sweep's non-zero updates land."""
    a = torch.tril(a) + torch.tril(a, -1).T
    n = a.shape[-1]
    for j in range(n):
        inv = 1.0 / torch.sqrt(a[j, j])
        col = a[j:, j] * inv
        a[j:, j] = col
        a[:j, j] = 0
        a[j + 1:, j + 1:] -= col[1:, None] * col[None, 1:]
    return a


def potrf_tile(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the (n, n) real tile ``a`` (only its lower
    triangle is read); a new tensor with the upper triangle zero.  CPU
    tensors take :func:`potrf_tile_plain`; CUDA tensors launch the kernel
    or raise."""
    global launches
    if a.device.type == "cpu":
        return potrf_tile_plain(a)
    if a.device.type != "cuda":
        raise ValueError(f"potrf_tile: unsupported device {a.device}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"potrf_tile: dtype {a.dtype} not in (float32, float64)")
    if a.dim() != 2 or a.shape[0] != a.shape[1] or a.shape[0] % 8:
        raise ValueError(f"potrf_tile: need a square tile with side % 8 == 0, got {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("potrf_tile: tile must be contiguous")
    n = a.shape[0]
    if n * (_MIN_PANEL + 1) * a.element_size() > _SMEM_BYTES:
        raise NotImplementedError(
            f"potrf_tile: a {n}x{n} {a.dtype} tile's column panel does not fit "
            "in one block's shared memory"
        )
    out = torch.empty_like(a)
    fn = _build.lib().dlaf_potrf_f32 if a.dtype == torch.float32 else _build.lib().dlaf_potrf_f64
    _build.check(fn(a.data_ptr(), out.data_ptr(), n, _build.stream_of(a)), "potrf_tile")
    with _build.COUNT_LOCK:  # rank threads launch concurrently
        launches += 1
    return out
