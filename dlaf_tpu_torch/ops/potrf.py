"""Cholesky of one tile: the hand-written CUDA kernels ``csrc/potrf.cu`` and
their plain PyTorch version.

Replaces ``dlaf_tpu/ops/pallas_potrf.py`` (``potrf_tile`` /
``_potrf_kernel``): the lower Cholesky factor of an (n, n) real tile whose
lower triangle is read (the tile is hermitized from it), with the upper
triangle of the result zero.

On the H100 an n=512 f32 tile takes 44.7 MFlop and moves 2 MiB: a
single-tile factor is bound by its n sequential pivot steps, not by bytes
or FLOP/s.  The TPU kernel keeps the whole tile in VMEM.  The kernel every
path launches holds the tile in the distributed shared memory of a
thread-block cluster (:data:`CLUSTER_BLOCKS` blocks, row i in block
i % CLUSTER_BLOCKS): per 32-wide column panel, one warp factors the
diagonal block, every block solves its rows of the panel against it and
applies the panel's rank-32 update to its own rows.  A tile whose cluster
does not fit the blocks' shared memory (f32 above n = 560, f64 above
n = 360; see :func:`cluster_fits`) goes to the one-block kernel, which
factors a 32-wide panel in shared memory at a time and keeps the trailing
triangle in device memory; that routing is static, by shape and dtype.
Both kernels give the same bits (``csrc/potrf.cu`` says why).  B7 and B8's
tail run the cluster body on the blocks of their own launch, meeting at
flag barriers in place of ``cluster.sync`` (``csrc/factor_send.cuh``), and
the one-block body where the same gate takes it, so they agree with B1
bitwise.  See ``PERF.md`` for their times.
"""
from __future__ import annotations

import torch

from dlaf_tpu_torch.ops import _build

#: launches of the CUDA kernels by :func:`potrf_tile` since the last reset,
#: and how many of them were the cluster kernel (plain-version calls on CPU
#: tensors count nothing; nor does :func:`potrf_tile_one_block`)
launches = 0
cluster_launches = 0

#: blocks of the cluster that factors a tile (8 is Hopper's portable
#: cluster size; up to 16 needs the non-portable attribute, which the
#: kernel sets); the kernel refuses a cluster the card cannot hold
CLUSTER_BLOCKS = 8

#: shared memory one block may use (H100: 227 KB) and the narrowest panel
#: the one-block kernel takes; tiles whose panel does not fit are refused
_SMEM_BYTES = 232448
_MIN_PANEL = 8
#: the cluster kernel's panel width: the one-block kernel's at every size
#: the cluster takes, so that both give the same bits
_PANEL = 32


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


def _one_block_panel(n: int, itemsize: int) -> int:
    """The one-block kernel's panel width for an n x n tile
    (``potrf.cuh: panel_width``): 32, narrower when a 32-wide panel does not
    fit in shared memory, 0 when not even 8 fits."""
    pw = 32
    while pw > _MIN_PANEL and n * (pw + 1) * itemsize > _SMEM_BYTES:
        pw //= 2
    return pw if n * (pw + 1) * itemsize <= _SMEM_BYTES else 0


def cluster_smem_bytes(n: int, itemsize: int, blocks: int) -> int:
    """Shared memory of one block of the cluster kernel (``potrf.cu:
    cluster_elems``): its rows, the gathered panel, the diagonal factor and
    its reciprocals."""
    rows = -(-n // blocks) * n
    pan = max(n - _PANEL, 0) * (_PANEL + 1)
    return (rows + pan + _PANEL * (_PANEL + 1) + _PANEL) * itemsize


def cluster_fits_shape(n: int, itemsize: int) -> bool:
    """:func:`cluster_fits` of an n x n tile of ``itemsize``-byte elements
    (``csrc/factor_send.cuh``: cluster_fits, the same gate in B7 and B8's
    tail)."""
    return (_one_block_panel(n, itemsize) == _PANEL
            and cluster_smem_bytes(n, itemsize, CLUSTER_BLOCKS) <= _SMEM_BYTES)


def cluster_fits(a) -> bool:
    """The static gate between the two kernels: the cluster kernel takes a
    tile whose rows, split over :data:`CLUSTER_BLOCKS` blocks, fit a block's
    shared memory beside a copy of the column panel (f32 up to n = 560,
    f64 up to n = 360 with 8 blocks) and whose one-block panel width is 32;
    the one-block kernel takes the others.  By shape and dtype only: no
    launch is ever retried on the other kernel."""
    return cluster_fits_shape(a.shape[-1], a.element_size())


def _check_cuda_tile(a, what: str) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {a.device}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {a.dtype} not in (float32, float64)")
    if a.dim() != 2 or a.shape[0] != a.shape[1] or a.shape[0] % 8:
        raise ValueError(f"{what}: need a square tile with side % 8 == 0, got {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError(f"{what}: tile must be contiguous")


def potrf_tile_one_block(a: torch.Tensor) -> torch.Tensor:
    """B1 on one thread block (the kernel the cluster kernel replaced): the
    "before" of B1's before/after check, and the kernel :func:`potrf_tile`
    launches where :func:`cluster_fits` fails (its body runs inside B7 and
    B8's tail where the same gate fails).  Counts nothing itself."""
    _check_cuda_tile(a, "potrf_tile_one_block")
    n = a.shape[0]
    if _one_block_panel(n, a.element_size()) == 0:
        raise NotImplementedError(
            f"potrf_tile: a {n}x{n} {a.dtype} tile's column panel does not fit "
            "in one block's shared memory"
        )
    out = torch.empty_like(a)
    fn = _build.lib().dlaf_potrf_f32 if a.dtype == torch.float32 else _build.lib().dlaf_potrf_f64
    _build.check(fn(a.data_ptr(), out.data_ptr(), n, _build.stream_of(a)), "potrf_tile")
    return out


def potrf_tile(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the (n, n) real tile ``a`` (only its lower
    triangle is read); a new tensor with the upper triangle zero.  CPU
    tensors take :func:`potrf_tile_plain`; CUDA tensors launch the cluster
    kernel where :func:`cluster_fits` (raising, never shrinking the cluster,
    where the card cannot hold it), the one-block kernel otherwise, or
    raise."""
    global launches, cluster_launches
    if a.device.type == "cpu":
        return potrf_tile_plain(a)
    _check_cuda_tile(a, "potrf_tile")
    if not cluster_fits(a):
        out = potrf_tile_one_block(a)
        with _build.COUNT_LOCK:  # rank threads launch concurrently
            launches += 1
        return out
    n = a.shape[0]
    out = torch.empty_like(a)
    lib = _build.lib()
    fn = lib.dlaf_potrf_cluster_f32 if a.dtype == torch.float32 else lib.dlaf_potrf_cluster_f64
    rc = fn(a.data_ptr(), out.data_ptr(), n, CLUSTER_BLOCKS, _build.stream_of(a))
    _build.check(rc, f"potrf_tile (a cluster of {CLUSTER_BLOCKS} blocks of "
                     f"{cluster_smem_bytes(n, a.element_size(), CLUSTER_BLOCKS)} bytes of "
                     "shared memory)")
    with _build.COUNT_LOCK:
        launches += 1
        cluster_launches += 1
    return out
