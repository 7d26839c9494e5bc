"""The trailing-update kernels of the 'fused' tier and their plain PyTorch
versions: ``csrc/trailing_update.cu`` (B3, B9) and ``csrc/consume.cu`` (B6,
B8).

Replaces ``dlaf_tpu/ops/pallas_trailing_update.py``.  Every contraction
here is ``tile.contract`` at a split-GEMM tier (``tune.gemm_precision``,
resolved in the calling thread when ``tier`` is None, as the JAX kernels
trace ``t.contract(..., tier=tier)`` inside their bodies):

* B3, :func:`trailing_update` (``trailing_update`` / ``_update_kernel``):
  ``x - contract(subscripts, a, b)`` written into ``x``, in two forms,
  ``iab,jcb->ijac`` (``x[i, j] -= a[i] @ b[j]^T``, the lookahead Cholesky
  bulk update and red2band's, there at K = band) and ``iab,jbc->ijac``
  (``x[i, j] -= a[i] @ b[j]``, the lookahead triangular solve's);
* B6, :func:`dma_ring_consume` (``dma_ring_consume`` /
  ``_dma_ring_consume_kernel``, ``_consume_hops``): the ring exchange of a
  row panel with each slot's trailing contribution applied as the slot
  lands, before its landing slot is acked (:func:`consume_schedule`);
* B8, :func:`fused_step` (``fused_step`` / ``_fused_step_kernel``): the
  whole lookahead Cholesky body of one step in one launch per rank;
* B9, :func:`panel_contract` (``panel_contract`` / ``_contract_kernel``):
  the one-shot contraction of the TRTRI column and row updates, whose sum
  crosses slots and so is not applied per hop.

:func:`fused_transpose_update` routes the fused tier's exchange-and-consume
as the JAX package does: B6 for a CUDA tensor of a real dtype on an axis
longer than 1, otherwise the transport (:func:`consume_exchange`) plus one
update, B3 on the card and its plain version on the CPU, so that the CPU's
'fused' tier gives the 'xla' tier's bits.

The updates write into ``x`` in place (the JAX kernels return new arrays):
``x`` is the whole local tile stack, 1 GiB at N=16384 f32, and a second
copy buys nothing.  On CPU tensors every wrapper runs its plain version;
on CUDA tensors it launches its kernel or raises.  Every kernel here is
bound by operations on the H100: at N=16384, nb=512 the Cholesky update is
275 GFlop over 2.2 GB.  At the 'default' tier B3 and B9 run the FMA body
of ``csrc/fma_gemm.cuh`` (128 x 128 output tiles, 8 x 8 a thread, a
cp.async ring of 16-deep k slices), and B6 and B8 its form for the
ring's 512-thread blocks, ``csrc/consume_gemm.cuh`` (the column panel as
one matrix in 128 x 64 tiles, one pipeline over a ring segment), with the
same bits: B6's update is bit for bit B3's applied once to the merged
panel with the slots not applied set to zero.  The first body,
``csrc/trailing_update.cuh`` (64 x 64 tiles), gives the same bits too:
:func:`trailing_update_reference` and :func:`panel_contract_reference`
launch B3 and B9 on it, for the card's before/after checks only.  Under
'bf16x3' / 'bf16x6' they run a split-tier body instead (the bf16 slices
of each operand, the products on the tensor cores with float32
accumulators, one per term): B3 and B9 as two kernels a call
(``csrc/split_gemm.cuh``: a pre-pass that cuts each operand once into
bf16 planes in a workspace the wrapper allocates, then a pipelined GEMM
over the planes; :func:`split_parts` launches each alone), B6 and B8
(whose update is spliced into a ring) as an instantiation of the same
kernel at 2 or 3 slices per operand (:func:`ring_slices`) on
``csrc/consume_split.cuh`` (each ring segment cut once into its slices,
the column panel streamed through cp.async pipelines), with B3-split's
bits: B6's split update is bit for bit B3-split's applied once to the
merged panel with the slots not applied set to zero.  B8's tail (the diagonal tile's factor, the panel solve and
its send) runs B7's factor-and-send body at every tier.  See ``PERF.md``
for the measured times.
"""
from __future__ import annotations

import ctypes

import torch

from dlaf_tpu_torch.comm import _ranks
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.ops import _build
from dlaf_tpu_torch.ops import panel_exchange as _px
from dlaf_tpu_torch.ops import panel_trsm as _ptrsm
from dlaf_tpu_torch.ops import tile as t

#: launches since the last reset (one per rank and call; the plain versions
#: count nothing): B3, B6, B8, B9
launches = 0
consume_launches = 0
step_launches = 0
contract_launches = 0
#: the shares of ``launches``, ``contract_launches``, ``consume_launches``
#: and ``step_launches`` that ran the split-tier body (B3, B9, B6 and B8
#: under 'bf16x3' / 'bf16x6')
split_launches = 0
split_contract_launches = 0
consume_split_launches = 0
fused_step_split_launches = 0

CHOLESKY_SUBSCRIPTS = "iab,jcb->ijac"
TRSM_SUBSCRIPTS = "iab,jbc->ijac"
_B_IS_NK = {CHOLESKY_SUBSCRIPTS: True, TRSM_SUBSCRIPTS: False}
#: the TRTRI column update and its upper mirror (B9's two forms)
TRTRI_LOWER_SUBSCRIPTS = "ijab,jbc->iac"
TRTRI_UPPER_SUBSCRIPTS = "iab,ijbc->jac"
_CONTRACT_FORM = {TRTRI_LOWER_SUBSCRIPTS: 0, TRTRI_UPPER_SUBSCRIPTS: 1}


def update_kernel_ok(dtype) -> bool:
    """Whether the kernels take this dtype (real only; complex payloads go
    to ``x - contract(...)``, as on the JAX package's compiled TPU path)."""
    return dtype in (torch.float32, torch.float64)


def _expand(mask, v):
    return mask.reshape(mask.shape + (1,) * (v.dim() - mask.dim()))


def _plain(*tensors) -> bool:
    """Whether a wrapper takes its plain version: every operand lies on the
    CPU."""
    return all(v.device.type == "cpu" for v in tensors)


def _check_cuda(what: str, *tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(v.device != dev for v in tensors):
        raise ValueError(f"{what}: operands on {[str(v.device) for v in tensors]}; need one "
                         f"CUDA device (CPU tensors take the plain version)")
    if not update_kernel_ok(tensors[0].dtype) or any(v.dtype != tensors[0].dtype for v in tensors):
        raise TypeError(f"{what}: dtypes {[v.dtype for v in tensors]}; need one real dtype")
    if not all(v.is_contiguous() for v in tensors):
        raise ValueError(f"{what}: operands must be contiguous")


def _count(*names: str) -> None:
    with _build.COUNT_LOCK:  # rank threads launch concurrently
        for name in names:
            globals()[name] += 1


def ring_slices(cp, y) -> int:
    """The bf16 slices per operand of B6's and B8's update: 0 at 'default',
    2 at 'bf16x3', 3 at 'bf16x6'.  The tier is the one ``tile.contract``
    takes in the calling thread for the update ``iab,jcb->ijac`` of ``cp``
    and the row panel ``y`` ('auto' splits at K >= 512 on the card), as the
    JAX kernels' bodies trace ``t.contract`` at the ambient tier."""
    return t.SPLIT_SLICES.get(t.resolve_tier(CHOLESKY_SUBSCRIPTS, cp, y), 0)


# ------------------------------------------------------------------------ B3


def trailing_update_plain(x, a, b, subscripts: str = CHOLESKY_SUBSCRIPTS,
                          tier: str | None = None):
    """``x -= tile.contract(subscripts, a, b, tier=tier)``, in place;
    returns ``x``."""
    return x.sub_(t.contract(subscripts, a, b, tier=tier))


def _update_dims(x, a, b, subscripts: str):
    """B3's (L, C, M, N, K, b_is_nk) of CUDA operands, checked."""
    _check_cuda("trailing_update", x, a, b)
    b_is_nk = _B_IS_NK[subscripts]
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 3:
        raise ValueError("trailing_update: need x [L, C, M, N], a [L, M, K], b 3-D")
    L, C, M, N = x.shape
    K = a.shape[2]
    want_b = (C, N, K) if b_is_nk else (C, K, N)
    if tuple(a.shape) != (L, M, K) or tuple(b.shape) != want_b:
        raise ValueError(
            f"trailing_update[{subscripts}]: x {tuple(x.shape)}, a {tuple(a.shape)}, "
            f"b {tuple(b.shape)} (b must be {want_b})"
        )
    return L, C, M, N, K, b_is_nk


def trailing_update(x, a, b, subscripts: str = CHOLESKY_SUBSCRIPTS, tier: str | None = None):
    """``x - contract(subscripts, a, b, tier)`` written into ``x``; returns
    ``x``.  ``tier=None`` is the calling thread's
    ``tune.resolved_gemm_precision()``.  CPU tensors take
    :func:`trailing_update_plain`; CUDA tensors launch B3 (its split-tier
    body under 'bf16x3' / 'bf16x6') or raise."""
    if subscripts not in _B_IS_NK:
        raise ValueError(f"trailing_update: subscripts {subscripts!r} not in {tuple(_B_IS_NK)}")
    tier = t.resolve_tier(subscripts, a, b, tier)
    if _plain(x, a, b):
        return trailing_update_plain(x, a, b, subscripts, tier)
    L, C, M, N, K, b_is_nk = _update_dims(x, a, b, subscripts)
    if x.numel() == 0:
        return x
    lib = _build.lib()
    f32 = x.dtype == torch.float32
    nslices = t.SPLIT_SLICES.get(tier)
    if nslices is None:
        fn = lib.dlaf_trailing_update_f32 if f32 else lib.dlaf_trailing_update_f64
        rc = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), L, C, M, N, K, int(b_is_nk),
                _build.stream_of(x))
        _build.check(rc, "trailing_update")
        _count("launches")
        return x
    _b3_split(x, a, b, (L, C, M, N, K, b_is_nk), nslices)
    _count("launches", "split_launches")
    return x


def _split_workspace(rows: int, K: int, nslices: int, device) -> torch.Tensor:
    """The workspace of one split call's bf16 planes: ``rows`` plane rows
    (a's, then b's) of K rounded up to 32, ``2 * nslices`` bytes an element,
    allocated on the caller's stream."""
    pitch = -(-K // 32) * 32 * 2 * nslices
    return torch.empty(rows * pitch, dtype=torch.uint8, device=device)


def _b3_split(x, a, b, dims, nslices: int, phases: int = 3, ws=None):
    """B3-split's pre-pass (``phases`` 1), body (2) or both (3) on CUDA
    operands checked by :func:`_update_dims`; returns the workspace."""
    L, C, M, N, K, b_is_nk = dims
    if ws is None:
        ws = _split_workspace(L * M + C * N, K, nslices, x.device)
    lib = _build.lib()
    fn = (lib.dlaf_trailing_update_split_f32 if x.dtype == torch.float32
          else lib.dlaf_trailing_update_split_f64)
    rc = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), ws.data_ptr(), ws.numel(), L, C, M, N, K,
            int(b_is_nk), nslices, phases, _build.stream_of(x))
    _build.check(rc, f"trailing_update[bf16 x {nslices} slices]")
    return ws


def _b9_split(out, a, b, dims, nslices: int, phases: int = 3, ws=None):
    """B9-split's pre-pass, body or both (``phases`` as in :func:`_b3_split`)
    on CUDA operands checked by :func:`_contract_dims`; returns the
    workspace."""
    form, L, C, M, N, K = dims
    if ws is None:
        rows = (L * C * M + C * N) if form == 0 else (L * M + L * C * N)
        ws = _split_workspace(rows, K, nslices, a.device)
    lib = _build.lib()
    fn = (lib.dlaf_panel_contract_split_f32 if a.dtype == torch.float32
          else lib.dlaf_panel_contract_split_f64)
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(), form, L, C,
            M, N, K, nslices, phases, _build.stream_of(a))
    _build.check(rc, f"panel_contract[bf16 x {nslices} slices]")
    return ws


def split_parts(a, b, subscripts: str, tier: str, x=None):
    """The two kernels of one B3-split (``x`` given: updated in place) or
    B9-split call on CUDA operands, as two callables that launch each alone
    on one workspace: the pre-pass (each operand cut into its bf16 planes)
    and the body (the products over the planes).  For timing each one's
    share on the card; the pre-pass runs once here, so the body finds its
    planes.  Counts nothing."""
    nslices = t.SPLIT_SLICES[tier]
    if x is not None:
        dims = _update_dims(x, a, b, subscripts)
        launch, target = _b3_split, x
    else:
        form, L, C, M, N, K, out_shape = _contract_dims(a, b, subscripts)
        dims = (form, L, C, M, N, K)
        launch, target = _b9_split, torch.empty(out_shape, dtype=a.dtype, device=a.device)
    ws = launch(target, a, b, dims, nslices, 1)
    return (lambda: launch(target, a, b, dims, nslices, 1, ws),
            lambda: launch(target, a, b, dims, nslices, 2, ws))


def trailing_update_reference(x, a, b, subscripts: str = CHOLESKY_SUBSCRIPTS):
    """B3 at the 'default' tier on its first tile body (``dlaf_tu::tile_gemm``,
    64 x 64 tiles), which the FMA body of :func:`trailing_update` replaced
    with the same bits: the reference of the card's before/after checks.
    CUDA tensors only; counts nothing."""
    if subscripts not in _B_IS_NK:
        raise ValueError(f"trailing_update: subscripts {subscripts!r} not in {tuple(_B_IS_NK)}")
    L, C, M, N, K, b_is_nk = _update_dims(x, a, b, subscripts)
    if x.numel():
        lib = _build.lib()
        fn = (lib.dlaf_trailing_update_ref_f32 if x.dtype == torch.float32
              else lib.dlaf_trailing_update_ref_f64)
        _build.check(fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), L, C, M, N, K, int(b_is_nk),
                        _build.stream_of(x)), "trailing_update_reference")
    return x


# ------------------------------------------------------------ the protocol


def consume_schedule(nhops: int) -> list:
    """The per-hop event order of the consume ring, as data (the JAX
    package's ``consume_schedule``): ``(event, hop, slot)`` triples, event
    one of ``cap_wait | dma_start | recv_wait | send_wait | update |
    cap_signal``.  The update of hop ``s`` precedes the ``cap_signal`` that
    lets the upstream writer reuse the landing slot at hop ``s + 2``.  The
    plain twin of B6 runs its hop loop from this list; the kernel follows
    the same order (``csrc/ring.cuh``, ``csrc/consume.cu``)."""
    events = []
    for s in range(nhops):
        slot = s % 2
        if s >= 2:
            events.append(("cap_wait", s, slot))
        events.append(("dma_start", s, slot))
        events.append(("recv_wait", s, slot))
        events.append(("send_wait", s, slot))
        events.append(("update", s, slot))
        if s + 2 < nhops:
            events.append(("cap_signal", s, slot))
    return events


def consume_exchange(taken, have, axis: str):
    """The consume ring's transport alone: the one-contributor exchange of
    ``(taken, have)`` along ``axis``, zero where no rank contributes
    (``consume_exchange``, :238).  It is ``coll._panel_exchange`` under the
    active tier, with the ring of the 'pallas' tier in its own class
    (``kind='consume'``); callers whose contraction sums across slots
    (TRTRI) pair it with :func:`panel_contract`."""
    return coll._panel_exchange(taken, have, axis, kind="consume")


# ------------------------------------------------------------------------ B6


def dma_ring_consume_plain(x, yf, h, cp, z, axis: str, *, events: list | None = None):
    """B6's twin: the ring protocol of B5's twin (CPU landing slots, recv
    and ack counters, every wait bounded) run from :func:`consume_schedule`,
    with the update spliced in.  After the entry barrier the rank applies
    its own slots (``h`` set, ``z`` clear), and at each hop's ``update``
    event it merges the landing slot (B4's twin) and applies the slots that
    were fresh in it, straight out of the landing slot, before the
    ``cap_signal`` acks it.  Each application is the masked full-panel
    contraction of the TPU kernel (slots not applied are exact zeros), so
    summed over the hops it is the one-shot update's arithmetic.  ``x`` is
    updated in place; returns ``(x, yf', h')``, the merged panel and have
    unmasked.  ``events``, when given, receives the schedule's events in
    the order they ran."""
    ctx = _ranks.current()
    slots = yf.shape[0]
    apply_ok = z.reshape(slots) == 0
    zero = torch.zeros((), dtype=yf.dtype)

    def apply(y, mask):
        x.sub_(t.contract(CHOLESKY_SUBSCRIPTS, cp, torch.where(_expand(mask, y), y, zero)))

    pos, n, ring = ctx.axis(axis)
    if n == 1:  # no ring: the local contribution is the whole update
        apply(yf, (h.reshape(slots) != 0) & apply_ok)
        return x, yf.clone(), h.clone()
    world, rt = ctx.world, ctx.world.rt
    yw = yf.reshape(slots, -1)
    st = rt.ring((_px.collective_id_for("consume", axis), ring, tuple(yw.shape), yw.dtype,
                  "host-consume"), lambda: _px._HostRing(rt, n, yw, h))
    st.epoch[pos] += 1
    e = st.epoch[pos] << 16
    dst = (pos + 1) % n
    label = f"consume ring on {axis!r}"
    acc_y, acc_h = yw.clone(), h.clone()
    _px._skew(ctx)
    with rt.lock:
        st.entry[pos] = e
        st.cond.notify_all()
        world.wait(st.cond, lambda: st.entry[dst] >= e and st.entry[(pos - 1) % n] >= e,
                   f"{label}: entry barrier")
    apply(yf, (h.reshape(slots) != 0) & apply_ok)
    for event, s, j in consume_schedule(n - 1):
        if event == "cap_wait":
            with rt.lock:
                world.wait(st.cond, lambda j=j, s=s: st.ack[dst][j] >= e | (s - 1),
                           f"{label}: ack of slot {j}")
        elif event == "dma_start":
            st.land_y[dst][j].copy_(acc_y)
            st.land_h[dst][j].copy_(acc_h)
            with rt.lock:
                st.recv[dst][j] = e | (s + 1)
                st.cond.notify_all()
        elif event == "recv_wait":
            with rt.lock:
                world.wait(st.cond, lambda j=j, s=s: st.recv[pos][j] >= e | (s + 1),
                           f"{label}: recv of slot {j}")
        elif event == "update":  # send_wait: the copy above is complete already
            land_y, land_h = st.land_y[pos][j], st.land_h[pos][j]
            fresh = ((acc_h == 0) & (land_h != 0)).reshape(slots)
            acc_y, acc_h = _px.merge_hop(acc_y, land_y, acc_h, land_h)
            apply(land_y.reshape(yf.shape), fresh & apply_ok)
        elif event == "cap_signal":
            with rt.lock:
                st.ack[pos][j] = e | (s + 1)
                st.cond.notify_all()
        if events is not None:
            events.append((event, s, j))
    return x, acc_y.reshape(yf.shape), acc_h


def dma_ring_consume(x, yf, h, cp, z, axis: str):
    """The consume ring inside a rank of ``spmd``: exchange the
    one-contributor row panel ``(yf[slots, N, K], h[slots, 1])`` along
    ``axis`` and apply each slot's contribution ``x[:, j] -= cp @ slot^T``
    (``iab,jcb->ijac``) as the slot lands; ``z[slots, 1]`` suppresses slots
    whose update the caller applies elsewhere (the lookahead's narrow
    column).  ``x [ltr, slots, M, N]`` is updated in place; returns ``(x,
    yf', h')`` with the merged panel and have unmasked, as the JAX kernel
    does.  CPU tensors take :func:`dma_ring_consume_plain`; CUDA tensors
    launch B6 (real dtypes, on an axis longer than 1; its split body under
    'bf16x3' / 'bf16x6', :func:`ring_slices`) or raise."""
    if _plain(x, yf, h, cp, z):
        return dma_ring_consume_plain(x, yf, h, cp, z, axis)
    _check_cuda("dma_ring_consume", x, yf, cp)
    nslices = ring_slices(cp, yf)
    ctx = _ranks.current()
    pos, n, ring = ctx.axis(axis)
    if ctx.world is None or n == 1:
        raise ValueError("dma_ring_consume: needs a rank of spmd on an axis longer than 1 "
                         "(fused_transpose_update takes the one-shot update otherwise)")
    if x.dim() != 4 or yf.dim() != 3 or cp.dim() != 3:
        raise ValueError("dma_ring_consume: need x [ltr, slots, M, N], yf [slots, N, K], cp [ltr, M, K]")
    ltr, slots, M, N = x.shape
    K = yf.shape[2]
    if tuple(yf.shape) != (slots, N, K) or tuple(cp.shape) != (ltr, M, K):
        raise ValueError(f"dma_ring_consume: x {tuple(x.shape)}, yf {tuple(yf.shape)}, "
                         f"cp {tuple(cp.shape)}")
    for name, m in (("h", h), ("z", z)):
        if m.dtype != torch.int32 or tuple(m.shape) != (slots, 1) or m.device != x.device:
            raise ValueError(f"dma_ring_consume: {name} must be int32 ({slots}, 1) on {x.device}")
    if N % 8 or K % 8:
        raise ValueError(f"dma_ring_consume: slots of {N} x {K}; need multiples of 8")
    rt = ctx.world.rt
    G = _px._max_blocks(rt)
    total = yf.numel() * yf.element_size() // 4
    st = rt.ring((_px.collective_id_for("consume", axis), ring, total, slots, "card-consume"),
                 lambda: _px._DeviceRing(rt, n, total, slots, G))
    st.epoch[pos] += 1
    out, oh = torch.empty_like(yf), torch.empty_like(h)
    hc, zc = h.contiguous(), z.contiguous()
    _px._before_launch(ctx, axis, "consume")
    lib = _build.lib()
    fn = lib.dlaf_dma_ring_consume_f32 if x.dtype == torch.float32 \
        else lib.dlaf_dma_ring_consume_f64
    rc = fn(yf.data_ptr(), hc.data_ptr(), zc.data_ptr(), out.data_ptr(), oh.data_ptr(),
            x.data_ptr(), cp.data_ptr(), st.land.data_ptr(), st.land_h.data_ptr(), st.entry,
            st.rflag, st.aflag, rt.error_word().data_ptr(), ltr, slots, M, N, K, st.blocks, n,
            pos, nslices, st.epoch[pos] << 16, int(_px.RING_TIMEOUT_S * 1e9),
            _build.stream_of(x))
    _build.check(rc, f"dma_ring_consume[nslices={nslices}]")
    ctx.world.ring_launched = True
    _count("consume_launches", *(("consume_split_launches",) if nslices else ()))
    return x, out, oh


def fused_transpose_update(x, cp, taken, have, suppress, axis: str = "r"):
    """The fused tier's exchange-and-consume of one panel step
    (``fused_transpose_update``, :425).  ``(taken, have)`` are the
    ``_parts`` of a ``transpose_panel*`` call of the column panel ``cp``;
    ``suppress`` masks the slots whose update the caller applies narrowly.
    Applies ``x -= contract('iab,jcb->ijac', cp, rp_bulk.conj())`` in place
    and returns ``(x, rp)``, ``rp`` the exchanged row panel (zero where no
    rank contributes), as ``transpose_panel`` gives it.

    A CUDA tensor of a real dtype on an axis longer than 1 goes to B6
    (:func:`dma_ring_consume`); everything else to :func:`consume_exchange`
    and one update, B3 on the card and its plain version on the CPU (the
    JAX package's path off the TPU)."""
    _, n, _ = _ranks.current().axis(axis)
    real = update_kernel_ok(x.dtype)
    if x.device.type == "cuda" and n > 1 and real:
        slots = taken.shape[0]
        h = have.to(torch.int32).reshape(slots, 1)
        z = suppress.to(torch.int32).reshape(slots, 1)
        x, y, hh = dma_ring_consume(x, taken.contiguous(), h, cp.contiguous(), z, axis)
        return x, torch.where(_expand(hh.reshape(slots) != 0, y), y, torch.zeros((), dtype=y.dtype,
                                                                                   device=y.device))
    rp = consume_exchange(taken, have, axis)
    zero = torch.zeros((), dtype=rp.dtype, device=rp.device)
    rp_bulk = torch.where(_expand(suppress.reshape(suppress.shape[:1]), rp), zero, rp)
    b = rp_bulk.conj().contiguous()
    if real:
        trailing_update(x, cp.contiguous(), b, CHOLESKY_SUBSCRIPTS)
    else:
        x.sub_(t.contract(CHOLESKY_SUBSCRIPTS, cp, b))
    return x, rp


# ------------------------------------------------------------------------ B8


def fused_step_supported(x, cp) -> bool:
    """The JAX package's gate of the one-launch lookahead step
    (``fused_step_supported``, :477), kept as it is so that the same inputs
    take the same route: a real floating dtype, square tiles, a side that
    is a multiple of 128 and at most ``panel_trsm.MAX_NB``; on the card
    also at most ``panel_exchange.FUSED_MAX_NB`` (B8's tail is B7's body),
    wider tiles taking the two-piece step, the same math."""
    mb = x.shape[-1]
    return (
        x.dtype.is_floating_point
        and not x.dtype.is_complex
        and x.dim() == 4
        and x.shape[-2] == mb
        and cp.dim() == 3
        and tuple(cp.shape[-2:]) == (mb, mb)
        and mb % 128 == 0
        and mb <= _ptrsm.MAX_NB
        and (x.device.type != "cuda" or mb <= _px.FUSED_MAX_NB)
    )


def fused_step_plain(x, taken, have, suppress, cp, below1, params):
    """B8's twin, the composition the JAX kernel's docstring lists: B6's
    twin over 'r', the narrow update of column k+1, the diagonal tile of
    step k+1 over 'c' then 'r' (the ring twin), and B7's twin (B1's and B2's
    plain versions, the mask to ``below1`` on the root column, the ring over
    'c').  ``x`` is updated in place; returns ``(x, rp, lkk1, cp1, d1)``."""
    kc1, kr1, l_next, lkr1, lkc1 = (int(v) for v in params[:5])
    ctx = _ranks.current()
    ltc = x.shape[1]
    h = have.to(torch.int32).reshape(ltc, 1)
    z = suppress.to(torch.int32).reshape(ltc, 1)
    x, y, hh = dma_ring_consume_plain(x, taken, h, cp, z, "r")
    zero = torch.zeros((), dtype=y.dtype)
    rp = torch.where(_expand(hh.reshape(ltc) != 0, y), y, zero)
    if ctx.myc == kc1:
        xc1 = x[:, l_next]
        xc1 -= t.contract("iab,cb->iac", cp, rp[l_next])
    own = ctx.myr == kr1 and ctx.myc == kc1
    d = x[lkr1, lkc1].clone() if own else torch.zeros_like(x[0, 0])
    d1, h1 = _px.ring_exchange(d, own, "c", kind="fused_step_diag")
    d1, _ = _px.ring_exchange(d1, h1, "r", kind="fused_step_diag")
    lkk1, cp1 = _px.fused_factor_bcast_plain(d1, x[:, l_next], below1, kc1, "c")
    return x, rp, lkk1, cp1, d1


class _StepFlags:
    """The fused step's flags on the card, 64-bit, never reset (valued
    ``epoch << 16``): per rank [G] consume-done, the rank's column k+1
    complete [ranks], per rank [G] the tail's barriers, the exit barrier
    [ranks][G], per grid row the chunk flags of the shared panel solve
    (:func:`panel_exchange.fused_flag_words`' sizing: a flag per 16 rows),
    and per rank the factor's diagonal-block scratch [32][32] (room for
    f64).  The stacked layout gives every rank the same ``ltr``."""

    def __init__(self, rt, blocks: int, pr: int, ltr: int, mb: int):
        n = rt.size
        self.blocks = blocks
        self.epoch = [0] * n
        self.chunks = ltr * -(-mb // 16)
        self.flags = rt.zeros(3 * n * blocks + n + pr * self.chunks, torch.int64)
        self.scratch = rt.zeros(n * 32 * 32 * 2, torch.int32)

    def of(self, rank: int, row: int) -> dict:
        """The flag addresses of ``rank`` (row-major) in grid row ``row``."""
        n, g, base, w = len(self.epoch), self.blocks, self.flags.data_ptr(), 8
        return {"p1done": base + w * rank * g, "p1all": base + w * n * g,
                "fflags": base + w * (n * g + n + rank * g),
                "done": base + w * (2 * n * g + n),
                "chunk": base + w * (3 * n * g + n + row * self.chunks),
                "dscr": self.scratch.data_ptr() + 8 * 32 * 32 * rank}


def fused_step(x, taken, have, suppress, cp, below1, params):
    """One lookahead Cholesky step in one launch per rank (B8), inside a
    rank of ``spmd``: the consume of row panel ``(taken, have)`` of the
    column panel ``cp`` into ``x`` (column k+1's narrow update included),
    the diagonal tile of step k+1 to every rank, its factor, and the panel
    solve of column k+1 masked by ``below1`` and its send over 'c' (the
    tail, on B7's factor-and-send body: every rank of the ring solves a
    share of the root's rows and pulls the others).  ``suppress`` is the
    narrow column's slot mask, ``params`` the ints ``(kc1, kr1, l_next,
    lkr1, lkc1)`` of step k+1.  ``x`` is updated in place; returns ``(x,
    rp, lkk1, cp1, d1)``, ``d1`` the broadcast diagonal tile for the
    owner's pivot scan.  CPU tensors take :func:`fused_step_plain`; CUDA
    tensors launch B8 (its consume phase at :func:`ring_slices`) or
    raise."""
    if _plain(x, taken, cp):
        return fused_step_plain(x, taken, have, suppress, cp, below1, params)
    _check_cuda("fused_step", x, taken, cp)
    nslices = ring_slices(cp, taken)
    if not fused_step_supported(x, cp):
        raise ValueError(f"fused_step: x {tuple(x.shape)} {x.dtype}, cp {tuple(cp.shape)} fail "
                         "fused_step_supported")
    ctx = _ranks.current()
    if ctx.world is None:
        raise ValueError("fused_step: runs inside a rank of spmd on a grid larger than 1x1")
    ltr, ltc, mb = x.shape[0], x.shape[1], x.shape[-1]
    if tuple(taken.shape) != (ltc, mb, mb) or tuple(cp.shape) != (ltr, mb, mb):
        raise ValueError(f"fused_step: x {tuple(x.shape)}, taken {tuple(taken.shape)}, "
                         f"cp {tuple(cp.shape)}")
    kc1, kr1, l_next, lkr1, lkc1 = (int(v) for v in params[:5])
    rt = ctx.world.rt
    G = _px._max_blocks(rt)
    tile = mb * mb * x.element_size() // 4
    pos, n, ring = ctx.axis("r")
    st = rt.ring((_px.collective_id_for("fused_step", "r"), ring, ltc * tile, ltc, "card"),
                 lambda: _px._DeviceRing(rt, n, ltc * tile, ltc, G))
    st.epoch[pos] += 1
    flags = rt.ring(("fused_step_flags", G, ltr, mb),
                    lambda: _StepFlags(rt, G, ctx.pr, ltr, mb))
    me = ctx.myr * ctx.pc + ctx.myc
    flags.epoch[me] += 1
    rp, oh = torch.empty_like(taken), torch.empty((ltc, 1), dtype=torch.int32, device=x.device)
    od, lkk1 = torch.empty_like(x[0, 0]), torch.empty_like(x[0, 0])
    cp1 = torch.empty_like(cp)
    h = have.to(torch.int32).reshape(ltc, 1).contiguous()
    z = suppress.to(torch.int32).reshape(ltc, 1).contiguous()
    below = below1.to(torch.int32).reshape(ltr).contiguous()
    # the launch spans both axes: meet every rank of the grid first, and
    # learn where the tiles the tail reads lie: every rank's stack and cp1
    peers = _ranks.rendezvous(None, "fused step: launch", (x.data_ptr(), ltc, cp1.data_ptr()))
    esz = x.element_size()
    x_own, ltc_own, _ = peers[kr1 * ctx.pc + kc1]     # the diagonal tile's owner
    x_root, ltc_root, _ = peers[ctx.myr * ctx.pc + kc1]  # this row's root of column k+1
    cp1_peers = (ctypes.c_longlong * ctx.pc)(*[peers[ctx.myr * ctx.pc + q][2]
                                               for q in range(ctx.pc)])
    vals = {"err": rt.error_word().data_ptr(),
            "timeout": int(_px.RING_TIMEOUT_S * 1e9), "G": G,
            "x": x.data_ptr(), "cp": cp.data_ptr(), "y": taken.data_ptr(), "h": h.data_ptr(),
            "z": z.data_ptr(), "rp": rp.data_ptr(), "oh": oh.data_ptr(),
            "below": below.data_ptr(), "od": od.data_ptr(), "lkk": lkk1.data_ptr(),
            "cp1_peers": ctypes.addressof(cp1_peers),
            "xroot": x_root + l_next * mb * mb * esz, "xstride": ltc_root * mb * mb,
            "dtile": x_own + (lkr1 * ltc_own + lkc1) * mb * mb * esz,
            **flags.of(me, ctx.myr),
            "epoch": flags.epoch[me] << 16, "ltr": ltr, "ltc": ltc, "mb": mb, "kc1": kc1,
            "kr1": kr1, "l_next": l_next, "me_r": ctx.myr, "me_c": ctx.myc, "pr": ctx.pr,
            "pc": ctx.pc,
            "ring0_land": st.land.data_ptr(), "ring0_land_h": st.land_h.data_ptr(),
            "ring0_entry": st.entry, "ring0_rflag": st.rflag, "ring0_aflag": st.aflag,
            "ring0_P": n, "ring0_me": pos, "ring0_epoch": st.epoch[pos] << 16}
    # the int64 argument array, filled by name in the order the library
    # states (csrc/consume.cu's DLAF_STEP_* lists)
    lib = _build.lib()
    fields = lib.dlaf_fused_step_fields().decode().split(",")
    vals["count"] = len(fields)
    if set(fields) != set(vals):
        raise RuntimeError("fused_step: the library's argument names and the wrapper's differ: "
                           f"{sorted(set(fields) ^ set(vals))}")
    desc = (ctypes.c_longlong * len(fields))(*(vals[f] for f in fields))
    _px._skew(ctx)
    fn = lib.dlaf_fused_step_f32 if x.dtype == torch.float32 else lib.dlaf_fused_step_f64
    rc = fn(ctypes.addressof(desc), nslices, _build.stream_of(x))
    _build.check(rc, f"fused_step[nslices={nslices}]")
    ctx.world.ring_launched = True
    _count("step_launches", *(("fused_step_split_launches",) if nslices else ()))
    rp = torch.where(_expand(oh.reshape(ltc) != 0, rp), rp, torch.zeros((), dtype=rp.dtype,
                                                                         device=rp.device))
    return x, rp, lkk1, cp1, od


# ------------------------------------------------------------------------ B9


def panel_contract_plain(a, b, subscripts: str, tier: str | None = None):
    """``tile.contract(subscripts, a, b, tier=tier)``."""
    return t.contract(subscripts, a, b, tier=tier)


def _contract_dims(a, b, subscripts: str):
    """B9's (form, L, C, M, N, K, output shape) of CUDA operands, checked."""
    _check_cuda("panel_contract", a, b)
    form = _CONTRACT_FORM[subscripts]
    if form == 0:
        if a.dim() != 4 or b.dim() != 3:
            raise ValueError("panel_contract[ijab,jbc->iac]: need a [L, C, M, K], b [C, K, N]")
        L, C, M, K = a.shape
        N = b.shape[2]
        ok, out_shape = tuple(b.shape) == (C, K, N), (L, M, N)
    else:
        if a.dim() != 3 or b.dim() != 4:
            raise ValueError("panel_contract[iab,ijbc->jac]: need a [L, M, K], b [L, C, K, N]")
        L, M, K = a.shape
        C, N = b.shape[1], b.shape[3]
        ok, out_shape = tuple(b.shape) == (L, C, K, N), (C, M, N)
    if not ok:
        raise ValueError(f"panel_contract[{subscripts}]: a {tuple(a.shape)}, b {tuple(b.shape)}")
    return form, L, C, M, N, K, out_shape


def panel_contract(a, b, subscripts: str, tier: str | None = None):
    """The one-shot TRTRI contraction (``panel_contract``, :198), returning
    ``contract``, not ``0 - contract`` (the caller negates: the two differ
    at signed zeros).  Two forms: ``ijab,jbc->iac`` (a [L, C, M, K], b
    [C, K, N]) and ``iab,ijbc->jac`` (a [L, M, K], b [L, C, K, N]); the sum
    over the slot axis runs in one fixed order.  ``tier`` as in
    :func:`trailing_update`.  CPU tensors take :func:`panel_contract_plain`;
    CUDA tensors launch B9 (its split-tier body under 'bf16x3' / 'bf16x6')
    or raise."""
    if subscripts not in _CONTRACT_FORM:
        raise ValueError(f"panel_contract: subscripts {subscripts!r} not in {tuple(_CONTRACT_FORM)}")
    tier = t.resolve_tier(subscripts, a, b, tier)
    if _plain(a, b):
        return panel_contract_plain(a, b, subscripts, tier)
    form, L, C, M, N, K, out_shape = _contract_dims(a, b, subscripts)
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = _build.lib()
    f32 = a.dtype == torch.float32
    nslices = t.SPLIT_SLICES.get(tier)
    if nslices is None:
        fn = lib.dlaf_panel_contract_f32 if f32 else lib.dlaf_panel_contract_f64
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), form, L, C, M, N, K,
                _build.stream_of(a))
        _build.check(rc, "panel_contract")
        _count("contract_launches")
        return out
    _b9_split(out, a, b, (form, L, C, M, N, K), nslices)
    _count("contract_launches", "split_contract_launches")
    return out


def panel_contract_reference(a, b, subscripts: str):
    """B9 at the 'default' tier on its first tile body (``dlaf_tu::tile_gemm``),
    which the FMA body of :func:`panel_contract` replaced with the same
    bits: the reference of the card's before/after checks.  CUDA tensors
    only; counts nothing."""
    if subscripts not in _CONTRACT_FORM:
        raise ValueError(
            f"panel_contract: subscripts {subscripts!r} not in {tuple(_CONTRACT_FORM)}")
    form, L, C, M, N, K, out_shape = _contract_dims(a, b, subscripts)
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    lib = _build.lib()
    fn = (lib.dlaf_panel_contract_ref_f32 if a.dtype == torch.float32
          else lib.dlaf_panel_contract_ref_f64)
    _build.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), form, L, C, M, N, K,
                    _build.stream_of(a)), "panel_contract_reference")
    return out
