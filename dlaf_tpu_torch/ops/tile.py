"""Tile-level operations (counterpart of ``dlaf_tpu/ops/tile.py``).

A "tile stack" is a tensor ``[..., mb, nb]``; every op broadcasts over the
leading axes.  Where the JAX package leaves a tile op to XLA (``potrf`` of
complex tiles, every ``trsm`` but the Cholesky panel, the ``contract``
einsum), the port leaves it to the matching PyTorch call; the Cholesky-panel
``trsm`` goes to the hand-written kernel of ``ops/panel_trsm.py`` under
``tune.panel_trsm_pallas``, behind the JAX package's gate.

Float32 matrix products run in full float32: importing this module sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.set_float32_matmul_precision("highest")``.  The default tier of
``contract`` is a full-precision einsum in the JAX package, and TF32 (about
three decimal digits) would change it.

The split-GEMM tiers of :func:`contract` (``tune.gemm_precision``
'bf16x3' / 'bf16x6', ``dlaf_tpu/ops/tile.py:109-229``) decompose each real
operand into bf16 slices (head, then residual chain), multiply the pruned
pairs of slices with float32 accumulation, and add the products at the
operand dtype, in the JAX package's slice and term order.  Here each
product is a library einsum of the slices upcast to float32 (a bf16 x bf16
product is exact in float32, so this is a bf16 product with float32
accumulation); the trailing-update kernels run the same decomposition on
the card's bf16 tensor cores (B3 and B9: ``csrc/split_gemm.cuh``; B6 and
B8: ``csrc/consume_split.cuh``).
"""
from __future__ import annotations

import threading

import torch

from dlaf_tpu_torch import tune
from dlaf_tpu_torch.ops import panel_trsm as _ptrsm

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# blas::Side / Uplo / Op / Diag analogues
LOWER = "L"
UPPER = "U"
LEFT = "Left"
RIGHT = "Right"
NO_TRANS = "N"
TRANS = "T"
CONJ_TRANS = "C"
UNIT = "U"
NON_UNIT = "N"


def _adj(a):
    return a.transpose(-1, -2).conj()


def op_tile(a, op: str):
    """Apply blas::Op to a tile stack."""
    if op == NO_TRANS:
        return a
    if op == TRANS:
        return a.transpose(-1, -2)
    if op == CONJ_TRANS:
        return _adj(a)
    raise ValueError(f"bad op {op}")


def _cholesky_or_nan(herm):
    """``torch.linalg.cholesky``, except that a tile that is not positive
    definite gives NaN on and below its diagonal (zero above) instead of
    raising, as the JAX package's ``jnp.linalg.cholesky`` does (callers
    find the failure with a pivot scan or a NaN check).  No host
    synchronisation."""
    fac, info = torch.linalg.cholesky_ex(herm)
    ok = (info == 0).reshape(info.shape + (1, 1))
    return torch.where(ok, fac, torch.tril(torch.full_like(fac, float("nan"))))


def potrf(a, lower: bool = True):
    """Cholesky of a (batch of) Hermitian tile(s); only the ``lower`` (or
    upper) triangle is read.  Returns the factor with the other triangle
    zero; a tile that is not positive definite gives NaN in the factor's
    triangle."""
    if lower:
        herm = torch.tril(a) + _adj(torch.tril(a, -1))
        return _cholesky_or_nan(herm)
    herm = torch.triu(a) + _adj(torch.triu(a, 1))
    return _adj(_cholesky_or_nan(_adj(herm)))


def trsm(side: str, uplo: str, op: str, diag: str, alpha, a, b):
    """B := alpha * op(A)^-1 B (Left) or alpha * B op(A)^-1 (Right), A
    triangular (only its ``uplo`` triangle is read).  Batched over leading
    axes; returns a contiguous tensor.

    ``tune.panel_trsm_pallas`` routes the Cholesky-panel case through the
    hand-written panel-TRSM kernel (``ops/panel_trsm.py``), as the JAX
    package routes it through its Pallas kernel (``tile.py:73-86``)."""
    bb = b if alpha == 1 else alpha * b
    if tune.get_tune_parameters().panel_trsm_pallas and _ptrsm.supported(side, uplo, op, diag, a, b):
        flat = bb.reshape(-1, b.shape[-1]).contiguous()
        out = _ptrsm.panel_trsm_right_lower_t(a.contiguous(), flat, op == CONJ_TRANS)
        return out.reshape(b.shape)
    lower = uplo == LOWER
    tri = op_tile(torch.tril(a) if lower else torch.triu(a), op)
    out = torch.linalg.solve_triangular(
        tri, bb,
        upper=lower == (op in (TRANS, CONJ_TRANS)),
        left=side == LEFT,
        unitriangular=diag == UNIT,
    )
    return out.contiguous()


# ----------------------------------------------------------------- split-GEMM

#: contracted extent below which 'auto' keeps the default tier
AUTO_SPLIT_MIN_K = 512

#: bf16 slices per operand of each split tier
SPLIT_SLICES = {"bf16x3": 2, "bf16x6": 3}

#: the contractions :func:`contract` made, by (name of the calling thread,
#: resolved tier); rank threads are named ``dlaf-rank-<r>-<c>``.  A run
#: reads it to show at which tier each thread contracted.
contract_counts: dict = {}
_COUNT_LOCK = threading.Lock()


def _bf16_slices(x, nslices: int):
    """Head + residual bf16 slice chain of a real tensor: s0 = bf16(x),
    s_i = bf16(x - s0 - ... - s_{i-1}), the residuals taken at x's dtype."""
    slices = []
    r = x
    for i in range(nslices):
        s = r.to(torch.bfloat16)
        slices.append(s)
        if i + 1 < nslices:
            r = r - s.to(r.dtype)
    return slices


def split_terms(nslices: int):
    """The slice pairs ``(i, j)`` with ``i + j < nslices``, smallest first
    (sorted by ``i + j`` descending, stable): the order in which the
    products are added.  bf16x3: (0, 1), (1, 0), (0, 0)."""
    return sorted(((i, j) for i in range(nslices) for j in range(nslices) if i + j < nslices),
                  key=lambda ij: ij[0] + ij[1], reverse=True)


def _split_contract_real(subscripts, a, b, nslices: int, out_dtype):
    asl = [s.float() for s in _bf16_slices(a, nslices)]
    bsl = [s.float() for s in _bf16_slices(b, nslices)]
    acc = None
    for i, j in split_terms(nslices):
        p = torch.einsum(subscripts, asl[i], bsl[j]).to(out_dtype)
        acc = p if acc is None else acc + p
    return acc


def _split_contract(subscripts, a, b, nslices: int, dtype):
    if dtype.is_complex:
        # float-pair view: (ar + i ai)(br + i bi) as four real split contracts
        rdt = torch.float64 if dtype == torch.complex128 else torch.float32
        ar, ai = a.real.to(rdt), a.imag.to(rdt)
        br, bi = b.real.to(rdt), b.imag.to(rdt)
        rr = _split_contract_real(subscripts, ar, br, nslices, rdt)
        ii = _split_contract_real(subscripts, ai, bi, nslices, rdt)
        ri = _split_contract_real(subscripts, ar, bi, nslices, rdt)
        ir = _split_contract_real(subscripts, ai, br, nslices, rdt)
        return torch.complex(rr - ii, ri + ir).to(dtype)
    return _split_contract_real(subscripts, a, b, nslices, dtype)


def contracted_extent(subscripts, a, b) -> int:
    """The product of the extents of the labels summed over."""
    ins, out = subscripts.replace(" ", "").split("->")
    extents = {}
    for labels, arr in zip(ins.split(","), (a, b)):
        core = labels.replace("...", "")
        for lbl, ext in zip(core, arr.shape[arr.dim() - len(core):]):
            extents[lbl] = ext
    k = 1
    for lbl, ext in extents.items():
        if lbl not in out:
            k *= ext
    return k


def auto_tier(subscripts, a, b, dtype) -> str:
    """'auto' at one call site: 'default' for CPU tensors; on the card a
    split when the contracted extent is at least :data:`AUTO_SPLIT_MIN_K`,
    'bf16x6' for 64-bit operands and 'bf16x3' otherwise.  The JAX package
    asks the process backend (``_auto_tier``, :192); the port asks the
    operands' device (``tune.on_accelerator``), and has no autotune profile
    to override it."""
    if not tune.on_accelerator(a.device):
        return "default"
    if contracted_extent(subscripts, a, b) < AUTO_SPLIT_MIN_K:
        return "default"
    return "bf16x6" if torch.finfo(dtype).bits >= 64 else "bf16x3"


def resolve_tier(subscripts, a, b, tier: str | None = None) -> str:
    """The tier :func:`contract` computes ``subscripts`` of ``a`` and ``b``
    at: ``None`` is the thread's ``tune.resolved_gemm_precision()``, 'auto'
    resolves per call site (:func:`auto_tier`), and operands that are not
    floating point of at least 32 bits are never split."""
    if tier is None:
        tier = tune.resolved_gemm_precision()
    else:
        tune.validate_gemm_precision(tier)
    dtype = torch.promote_types(a.dtype, b.dtype)
    if not (dtype.is_floating_point or dtype.is_complex) or torch.finfo(dtype).bits < 32:
        return "default"
    if tier == "auto":
        return auto_tier(subscripts, a, b, dtype)
    return tier


def _count(tier: str) -> None:
    key = (threading.current_thread().name, tier)
    with _COUNT_LOCK:
        contract_counts[key] = contract_counts.get(key, 0) + 1


def contract(subscripts, a, b, tier: str | None = None):
    """Tier-aware two-operand contraction (``contract``, :204): 'default' is
    a plain full-precision ``torch.einsum``; 'bf16x3' / 'bf16x6' the split
    of the module docstring; ``tier=None`` resolves ``tune.gemm_precision``
    (with the ambient ``tune.gemm_precision_scope``) in the calling
    thread."""
    tier = resolve_tier(subscripts, a, b, tier)
    _count(tier)
    nslices = SPLIT_SLICES.get(tier)
    if nslices is None:
        return torch.einsum(subscripts, a, b)
    dtype = torch.promote_types(a.dtype, b.dtype)
    return _split_contract(subscripts, a.to(dtype), b.to(dtype), nslices, dtype)


def trmm(side: str, uplo: str, op: str, diag: str, alpha, a, b):
    """B := alpha * op(A) B (Left) or alpha * B op(A) (Right), A triangular."""
    tri = torch.tril(a) if uplo == LOWER else torch.triu(a)
    if diag == UNIT:
        eye = torch.eye(tri.shape[-1], dtype=tri.dtype, device=tri.device)
        tri = tri - tri * eye + eye  # replace the diagonal with ones
    tri = op_tile(tri, op)
    prod = (contract("...ab,...bc->...ac", tri, b) if side == LEFT
            else contract("...ab,...bc->...ac", b, tri))
    return alpha * prod


def gemm(opa: str, opb: str, alpha, a, b, beta, c):
    """C := alpha op(A) op(B) + beta C (tile::gemm)."""
    return alpha * contract("...ab,...bc->...ac", op_tile(a, opa), op_tile(b, opb)) + beta * c


def herk(uplo: str, op: str, alpha, a, beta, c):
    """C := alpha op(A) op(A)^H + beta C, both triangles of C computed."""
    oa = op_tile(a, op)
    return alpha * contract("...ab,...bc->...ac", oa, _adj(oa)) + beta * c


def hemm(side: str, uplo: str, alpha, a, b, beta, c):
    """C := alpha A B + beta C with A Hermitian (full storage assumed)."""
    prod = (contract("...ab,...bc->...ac", a, b) if side == LEFT
            else contract("...ab,...bc->...ac", b, a))
    return alpha * prod + beta * c


def lange_max(a):
    """Max-norm of a tile stack (tile::lange(max))."""
    if a.numel():
        return a.abs().max()
    return torch.zeros((), dtype=a.abs().dtype, device=a.device)


def laset(shape, alpha, beta, dtype, device=None):
    """Tile filled with alpha off the diagonal and beta on it (tile::laset)."""
    eye = torch.eye(shape[-2], shape[-1], dtype=dtype, device=device)
    return torch.full(tuple(shape), alpha, dtype=dtype, device=device) * (1 - eye) + beta * eye
