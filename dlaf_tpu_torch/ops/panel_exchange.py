"""The ring collectives of the 'pallas' tier: the hand-written CUDA kernels
``csrc/panel_exchange.cu`` and their plain twins.

Replaces ``dlaf_tpu/ops/pallas_panel_exchange.py``:

- B4, :func:`merge_hop` (``merge_hop`` / ``_merge_kernel``): one hop merge on
  the wire layout, ``take = ~have & have_in; y = take ? y_in : y;
  have |= have_in``.  A pure select.  As in the JAX package, B4's own
  launch is the merge of the ring that has no remote copy: here the CPU
  twin of the exchange; on the card B4's select picks every slot's source
  in each B5 pull and merges every hop of B6, B7 and B8.
- B5, :func:`ring_exchange` / :func:`ring_bcast` (``dma_ring_exchange`` /
  ``_dma_ring_kernel``, ``_ring_hops``): a one-contributor ``(payload,
  have)`` exchange along a grid axis, with the result of the TPU's ring:
  per slot this rank's bytes where it has the slot, else those of its
  nearest upstream rank that has it.  On the card it is a pull: the ranks
  are threads of one process on one card, so each rank copies the chosen
  bytes straight out of its peers' inputs (their device pointers are
  exchanged at the host rendezvous before the launch), between an entry
  and an exit barrier over every rank of the ring.  One launch per rank,
  on its stream.  The hop ring it replaced (P - 1 hops through landing
  slots) stays as :func:`ring_exchange_hops`, the reference of the pull's
  before/after check; no path calls it.
- B7, :func:`fused_factor_bcast` (``fused_factor_bcast`` / ``_fused_kernel``):
  potrf of the broadcast diagonal tile, the panel solve of the root's
  column, the mask to the rows below the diagonal, and the send over 'c',
  in one launch per rank, on the factor-and-send body of
  ``csrc/factor_send.cuh`` that B8's tail runs too: every rank factors the
  tile with B1's cluster body on the blocks of its launch (flag barriers
  in place of a cluster), solves a share of the root's rows with B2's
  body, and pulls the other shares from the ranks that solved them
  (:func:`fused_geometry`, :func:`solve_shares`).

The ranks of a grid are threads of one process on one card
(``comm/_ranks.py``); the ring state a collective needs (landing slots or
flags, epoch counters) is made once per collective class, axis, ring and
payload size, under the runtime's lock, and kept for the grid's lifetime.
Distinct classes (the ``collective_id`` table of the JAX package) get
distinct states, so a B7 ring on 'c' and a B5 ring on 'r' may be in flight
together.  Calls of one state follow each other on every rank's stream in
the same SPMD order, so the epochs agree without a reset.

On CPU tensors every wrapper runs its plain twin, which is the same
protocol, not a shortcut: the exchange's twin posts its input and meets
every rank of the ring at an entry barrier (counters under the runtime's
lock, one condition per ring), folds B4's twin over the upstream ranks'
inputs in ring order (me - 1, me - 2, ...), and meets them again at an
exit barrier.  On CUDA tensors the wrappers launch the kernels or raise;
no path falls back.

Every wait is bounded: the twin's by ``_ranks.WAIT_S``, the kernels' spins
by :data:`RING_TIMEOUT_S`, after which a kernel sets the grid's sticky
error word and exits; ``_ranks.spmd`` reads the word when the call ends
and raises ``DeadlineExceededError``.  See ``csrc/panel_exchange.cu`` for
the kernels' design and ``PERF.md`` for their times.
"""
from __future__ import annotations

import ctypes
import math
import time

import torch

from dlaf_tpu_torch.comm import _ranks
from dlaf_tpu_torch.ops import _build
from dlaf_tpu_torch.ops import panel_trsm as _ptrsm
from dlaf_tpu_torch.ops import potrf as _potrf

#: launches of B4, B5 (the pull) and B7 since the last reset (one per rank
#: and call; the plain twins count nothing), and of the hop ring that B5's
#: before/after check launches
merge_launches = 0
ring_launches = 0
fused_launches = 0
hop_launches = 0

#: bytes of payload per block of a pull launch (at most SMs / ranks blocks)
PULL_BYTES_PER_BLOCK = 64 * 1024

#: bound of every spin in the ring kernels, seconds
RING_TIMEOUT_S = 5.0

#: fault injection for the skew tests: rank (row, col) -> seconds it
#: sleeps before it enters each ring
launch_delay_s: dict = {}

# ------------------------------------------------------- collective classes
#
# The JAX package gives every (entry point, axis) class its own
# ``collective_id`` so that kernels of two classes may be live together;
# the port gives every class its own ring state.

FUSED_COLLECTIVE_ID = 1
_RESERVED_COLLECTIVE_IDS = {
    ("bcast", "r"): 2,
    ("bcast", "c"): 3,
    ("exchange", "r"): 4,
    ("exchange", "c"): 5,
}
_dynamic_collective_ids: dict = {}


def collective_id_for(kind: str, axis: str) -> int:
    """Stable id of a (kind, axis) call-site class: the reserved table,
    then first-use allocation from 8 (the JAX package's table)."""
    key = (kind, axis)
    cid = _RESERVED_COLLECTIVE_IDS.get(key)
    if cid is None:
        with _build.COUNT_LOCK:
            cid = _dynamic_collective_ids.setdefault(key, 8 + len(_dynamic_collective_ids))
    return cid


def _class_id(kind: str, axis: str) -> int:
    """The ring-state class of an entry point: the fused kernel's id, or
    the (kind, axis) table's."""
    return FUSED_COLLECTIVE_ID if kind == "fused" else collective_id_for(kind, axis)


def describe_error(code: int) -> str:
    """What the ring kernels' error word says."""
    return {
        -1: "ring kernels released because a rank thread failed",
        1: "ring kernel: entry barrier (a partner's launch never came)",
        2: "ring kernel: capacity ack of a landing slot",
        3: "ring kernel: recv flag of a landing slot",
        4: "fused kernel: a barrier of the diagonal factor",
        5: "fused step kernel: a phase flag (a rank's consume phase never ended)",
        6: "ring kernel (pull, fused): exit barrier (a reader's done flag never came)",
        7: "fused kernel: a chunk flag of the shared panel solve",
    }.get(code, f"ring kernel error {code}")


# --------------------------------------------------------------- wire layout


def _to_wire(y, have):
    """Any (slots, ...) payload, or a whole payload with a scalar ``have``,
    as the canonical (slots, w) real payload and (slots, 1) int32 have.
    Complex payloads travel as their real views (bit-preserving)."""
    if not isinstance(have, torch.Tensor):  # a fill, not a host-to-device copy
        have = torch.full((), bool(have), dtype=torch.bool, device=y.device)
    slots = have.numel() if have.dim() else 1
    yf = y.reshape(slots, -1)
    if yf.is_complex():
        yf = torch.view_as_real(yf).reshape(slots, -1)
    return yf.contiguous(), have.to(torch.int32).reshape(slots, 1).contiguous()


def _from_wire(yf, h, y_template, have_template):
    if y_template.is_complex():
        yf = torch.view_as_complex(yf.reshape(yf.shape[0], -1, 2))
    have_shape = tuple(have_template.shape) if isinstance(have_template, torch.Tensor) else ()
    return yf.reshape(y_template.shape), (h != 0).reshape(have_shape)


# ------------------------------------------------------------------------ B4


def merge_hop_plain(yf, y_in, h, h_in):
    """The hop merge in PyTorch (``_merge_kernel``): new tensors."""
    take = (h == 0) & (h_in != 0)
    return torch.where(take, y_in, yf), h | h_in


def _words(t):
    """A contiguous real tensor as 32-bit words (bit-preserving)."""
    return t.contiguous().view(torch.int32)


def merge_hop(yf, y_in, h, h_in):
    """One hop merge on the wire layout: ``yf``/``y_in`` (slots, w) of one
    real dtype, ``h``/``h_in`` (slots, 1) int32.  CPU tensors take
    :func:`merge_hop_plain`; CUDA tensors launch B4 or raise.  B4 (its
    ``merge_select_kernel``) runs a block per slot and chunk, decides the
    slot's take once and reads only the payload it keeps, 16 bytes a
    thread where the slot's words allow it."""
    global merge_launches
    if all(t.device.type == "cpu" for t in (yf, y_in, h, h_in)):
        return merge_hop_plain(yf, y_in, h, h_in)
    dev = yf.device
    if dev.type != "cuda" or any(t.device != dev for t in (y_in, h, h_in)):
        raise ValueError("merge_hop: operands on different devices or not on a CUDA device")
    if yf.dim() != 2 or y_in.shape != yf.shape or y_in.dtype != yf.dtype or yf.is_complex():
        raise ValueError(f"merge_hop: need two real (slots, w) payloads, got "
                         f"{tuple(yf.shape)} {yf.dtype}, {tuple(y_in.shape)} {y_in.dtype}")
    slots = yf.shape[0]
    if h.dtype != torch.int32 or h_in.dtype != torch.int32 or tuple(h.shape) != (slots, 1) \
            or tuple(h_in.shape) != (slots, 1):
        raise ValueError(f"merge_hop: have masks must be int32 ({slots}, 1)")
    if (yf.shape[1] * yf.element_size()) % 4:
        raise ValueError("merge_hop: a slot must be a whole number of 32-bit words")
    y, yi, hh, hi = _words(yf), _words(y_in), h.contiguous(), h_in.contiguous()
    oy, oh = torch.empty_like(y), torch.empty_like(hh)
    rc = _build.lib().dlaf_merge_hop(y.data_ptr(), yi.data_ptr(), hh.data_ptr(), hi.data_ptr(),
                                     oy.data_ptr(), oh.data_ptr(), y.numel(), y.shape[1], slots,
                                     _build.stream_of(y))
    _build.check(rc, "merge_hop")
    with _build.COUNT_LOCK:
        merge_launches += 1
    return oy.view(yf.dtype), oh


# ------------------------------------------------------------------ ring states


class _HostRing:
    """The plain ring's state: CPU landing slots and flag counters."""

    def __init__(self, rt, n: int, yf, h):
        self.cond = rt.condition()  # on rt.lock; wakes this ring's ranks only
        self.epoch = [0] * n
        self.land_y = [[torch.zeros_like(yf) for _ in range(2)] for _ in range(n)]
        self.land_h = [[torch.zeros_like(h) for _ in range(2)] for _ in range(n)]
        self.entry = [0] * n
        self.recv = [[0, 0] for _ in range(n)]
        self.ack = [[0, 0] for _ in range(n)]


class _DeviceRing:
    """The hop rings' state on the card (B5's reference kernel, B6, B8's
    consume phase): landing slots [P][2][total] words, their have
    [P][2][G][slots], and the flags (entry [P][G], recv and ack [P][2][G])
    as 64-bit words, all zero at first and never reset."""

    def __init__(self, rt, n: int, total: int, slots: int, blocks: int):
        self.epoch = [0] * n
        self.blocks = blocks
        self.land = rt.zeros(n * 2 * total, torch.int32)
        self.land_h = rt.zeros(n * 2 * blocks * slots, torch.int32)
        self.flags = rt.zeros(n * blocks + 2 * (n * 2 * blocks), torch.int64)
        base, w = self.flags.data_ptr(), 8
        self.entry = base
        self.rflag = base + w * n * blocks
        self.aflag = self.rflag + w * n * 2 * blocks


class _FusedRing:
    """B7's state on the card: its flags (:func:`fused_flag_words`: the
    root's entry flag, the exit barrier [P][G], each rank's factor barrier
    [P][G], the chunk flags) as 64-bit words and each rank's scratch for
    the factor's diagonal block [P][32][32] (room for f64), zero at first
    and never reset.  No landing slots: the ranks read each other's panels."""

    def __init__(self, rt, n: int, blocks: int, ltr: int, nb: int):
        self.epoch = [0] * n
        self.blocks = blocks
        self.flags = rt.zeros(fused_flag_words(n, blocks, ltr, nb), torch.int64)
        self.scratch = rt.zeros(n * 32 * 32 * 2, torch.int32)


class _PullRing:
    """The pull exchange's state on the card: its entry and done flags
    [2][P][G] as 64-bit words, zero at first and never reset.  No landing
    slots: the ranks read each other's inputs."""

    def __init__(self, rt, n: int, blocks: int):
        self.epoch = [0] * n
        self.blocks = blocks
        self.flags = rt.zeros(2 * n * blocks, torch.int64)
        self.entry = self.flags.data_ptr()
        self.done = self.entry + 8 * n * blocks


class _HostPull:
    """The pull twin's state: every rank's posted input and its entry and
    done counters."""

    def __init__(self, rt, n: int):
        self.cond = rt.condition()  # on rt.lock; wakes this ring's ranks only
        self.epoch = [0] * n
        self.posted = [None] * n
        self.entry = [0] * n
        self.done = [0] * n


def _max_blocks(rt) -> int:
    """Blocks per ring launch: every rank of the grid may have one launch
    live at once, and all of them must fit the card's SMs together."""
    sms = torch.cuda.get_device_properties(rt.device).multi_processor_count
    return max(1, sms // rt.size)


def _skew(ctx) -> None:
    delay = launch_delay_s.get((ctx.myr, ctx.myc))
    if delay:
        time.sleep(delay)


def _before_launch(ctx, axis: str, kind: str, value=None) -> list:
    """Meet the ring's other ranks on the host (``_ranks.rendezvous``), so
    that a ring kernel never waits on the card for a partner whose thread
    is far behind; the skew tests' delay comes after, so that the kernels
    of the punctual ranks do spin for the late one.  Returns the ``value``
    of every rank of the ring, by position."""
    vals = _ranks.rendezvous(axis, f"{kind} ring on {axis!r}: launch", value)
    _skew(ctx)
    return vals


# ------------------------------------------------------------------ B5 twin


def _ring_plain(yf, h, axis: str, kind: str):
    """The pull protocol with CPU state: post this rank's input, an entry
    barrier over every rank of the ring, B4's twin folded over the upstream
    ranks' inputs in ring order (me - 1, me - 2, ...: the nearest
    contributor wins, as in the ring), an exit barrier.  Every wait is
    bounded by ``_ranks.WAIT_S``."""
    ctx = _ranks.current()
    world, rt = ctx.world, ctx.world.rt
    pos, n, ring = ctx.axis(axis)
    st = rt.ring((_class_id(kind, axis), ring, tuple(yf.shape), yf.dtype, "host-pull"),
                 lambda: _HostPull(rt, n))
    st.epoch[pos] += 1
    e = st.epoch[pos] << 16
    label = f"{kind} ring on {axis!r}"
    _skew(ctx)
    with rt.lock:
        st.posted[pos] = (yf, h)
        st.entry[pos] = e | 1
        st.cond.notify_all()
        world.wait(st.cond, lambda: all(v >= e | 1 for v in st.entry), f"{label}: entry barrier")
        upstream = [st.posted[(pos - q) % n] for q in range(1, n)]
    acc_y, acc_h = yf, h
    for y_in, h_in in upstream:
        acc_y, acc_h = merge_hop(acc_y, y_in, acc_h, h_in)
    with rt.lock:
        st.done[pos] = e | 2
        st.cond.notify_all()
        world.wait(st.cond, lambda: all(v >= e | 2 for v in st.done), f"{label}: exit barrier")
        st.posted[pos] = None
    return acc_y, acc_h


# ----------------------------------------------------------------------- B5


def _ring_cuda(yf, h, axis: str, kind: str):
    """This rank's launch of B5, the pull, on its stream.  ``words`` and
    ``h`` stay referenced until the launch is queued; the kernel's exit
    barrier keeps every peer's reads ahead of this rank's next use of
    them."""
    global ring_launches
    ctx = _ranks.current()
    world, rt = ctx.world, ctx.world.rt
    pos, n, ring = ctx.axis(axis)
    words = _words(yf)
    total, slots = words.numel(), h.shape[0]
    if total % slots:
        raise ValueError("ring_exchange: the payload does not split into its have-slots")
    blocks = min(_max_blocks(rt), max(1, math.ceil(total * 4 / PULL_BYTES_PER_BLOCK)))
    seg = math.ceil(total / blocks / 4) * 4
    st = rt.ring((_class_id(kind, axis), ring, total, slots, "pull"),
                 lambda: _PullRing(rt, n, blocks))
    st.epoch[pos] += 1
    out, oh = torch.empty_like(words), torch.empty_like(h)
    hc = h.contiguous()
    ptrs = _before_launch(ctx, axis, kind, (words.data_ptr(), hc.data_ptr()))
    ys = (ctypes.c_void_p * n)(*[p[0] for p in ptrs])
    hs = (ctypes.c_void_p * n)(*[p[1] for p in ptrs])
    rc = _build.lib().dlaf_pull_exchange(
        ctypes.addressof(ys), ctypes.addressof(hs), out.data_ptr(), oh.data_ptr(), st.entry,
        st.done, rt.error_word().data_ptr(), total, total // slots, slots, seg, st.blocks, n, pos,
        st.epoch[pos] << 16, int(RING_TIMEOUT_S * 1e9), _build.stream_of(words))
    _build.check(rc, "ring_exchange")
    world.ring_launched = True
    with _build.COUNT_LOCK:
        ring_launches += 1
    return out.view(yf.dtype), oh


def _ring_hops_cuda(yf, h, axis: str, kind: str):
    """This rank's launch of the hop ring on its stream (its landing slots
    in a ring state of their own)."""
    global hop_launches
    ctx = _ranks.current()
    world, rt = ctx.world, ctx.world.rt
    pos, n, ring = ctx.axis(axis)
    words = _words(yf)
    total, slots = words.numel(), h.shape[0]
    if total % slots:
        raise ValueError("ring_exchange_hops: the payload does not split into its have-slots")
    blocks = min(_max_blocks(rt), max(1, math.ceil(total * 4 / (256 * 1024))))
    seg = math.ceil(total / blocks / 4) * 4
    st = rt.ring((_class_id(kind, axis), ring, total, slots, "card-hops"),
                 lambda: _DeviceRing(rt, n, total, slots, blocks))
    st.epoch[pos] += 1
    out, oh = torch.empty_like(words), torch.empty_like(h)
    _before_launch(ctx, axis, kind)
    rc = _build.lib().dlaf_ring_exchange(
        words.data_ptr(), h.data_ptr(), out.data_ptr(), oh.data_ptr(), st.land.data_ptr(),
        st.land_h.data_ptr(), st.entry, st.rflag, st.aflag, rt.error_word().data_ptr(),
        total, total // slots, slots, seg, st.blocks, n, pos, st.epoch[pos] << 16,
        int(RING_TIMEOUT_S * 1e9), _build.stream_of(words))
    _build.check(rc, "ring_exchange_hops")
    world.ring_launched = True
    with _build.COUNT_LOCK:
        hop_launches += 1
    return out.view(yf.dtype), oh


def ring_exchange_hops(y, have, axis: str, *, kind: str = "exchange"):
    """:func:`ring_exchange` through the hop ring that the pull replaced (P -
    1 hops through double-buffered landing slots, ``csrc/ring.cuh``): the
    "before" of B5's before/after check and a second bitwise reference of
    the pull.  No path calls it.  CPU tensors take the twin of
    :func:`ring_exchange` (the same result)."""
    _, n, _ = _ranks.current().axis(axis)
    if n == 1:
        return y, have
    yf, h = _to_wire(y, have)
    if yf.device.type == "cpu":
        yf, h = _ring_plain(yf, h, axis, kind)
    elif yf.device.type == "cuda":
        yf, h = _ring_hops_cuda(yf, h, axis, kind)
    else:
        raise ValueError(f"ring_exchange_hops: unsupported device {yf.device}")
    return _from_wire(yf, h, y, have)


def ring_exchange(y, have, axis: str, *, kind: str = "exchange"):
    """Forward-ring exchange of a one-contributor slotted payload along
    ``axis``, inside a rank of ``spmd``.  ``have``'s shape is a leading
    prefix of ``y``'s (a scalar for a whole-payload broadcast); returns
    ``(y, have)`` with every slot that has a contributor on the axis
    holding that contributor's bytes, the others this rank's input.
    ``kind`` names the collective class (its own ring state)."""
    _, n, _ = _ranks.current().axis(axis)
    if n == 1:
        return y, have
    yf, h = _to_wire(y, have)
    if yf.device.type == "cpu":
        yf, h = _ring_plain(yf, h, axis, kind)
    elif yf.device.type == "cuda":
        yf, h = _ring_cuda(yf, h, axis, kind)
    else:
        raise ValueError(f"ring_exchange: unsupported device {yf.device}")
    return _from_wire(yf, h, y, have)


def ring_bcast(x, is_root: bool, axis: str):
    """Whole-payload broadcast on the ring: the rank with ``is_root`` set
    contributes, every rank ends with its bytes."""
    y, _ = ring_exchange(x, bool(is_root), axis, kind="bcast")
    return y


# ----------------------------------------------------------------------- B7


def fusion_supported(d, xc) -> bool:
    """The fused factor-and-send covers the lookahead Cholesky panel: real
    f32/f64 tiles, a square tile ``d`` whose side passes B1's gate, and a
    panel ``xc`` that is a stack of such tiles.  The JAX gate's multiple of
    128 is Mosaic's; the card's kernel needs B2's column blocks of 32 and
    at most :data:`FUSED_MAX_NB`, so CUDA tiles need a side that is a
    multiple of 32 up to 512 (the CPU twin takes any multiple of 8)."""
    if d.dtype not in (torch.float32, torch.float64) or xc.dtype != d.dtype:
        return False
    if d.dim() != 2 or xc.dim() != 3 or tuple(xc.shape[1:]) != tuple(d.shape):
        return False
    nb = d.shape[0]
    if not _potrf.supported(d) or nb > _ptrsm.MAX_NB:
        return False
    return d.device.type == "cpu" or (nb % _ptrsm.W == 0 and nb <= FUSED_MAX_NB)


def fused_factor_bcast_plain(d, xc, below, root: int, axis: str = "c"):
    """B7's twin: ``potrf_tile_plain(d)``, the panel solve of ``xc``
    against it (``panel_trsm_plain``), the mask to the ``below`` tiles on
    the root, and the ring twin with a scalar have."""
    pos, _, _ = _ranks.current().axis(axis)
    is_root = pos == root
    lkk = _potrf.potrf_tile_plain(d)
    nb = d.shape[0]
    if is_root:
        pan = _ptrsm.panel_trsm_plain(lkk, xc.reshape(-1, nb)).reshape(xc.shape)
        cp = torch.where(below.reshape(-1, 1, 1), pan, torch.zeros_like(pan))
    else:
        cp = torch.zeros_like(xc)
    y, _ = ring_exchange(cp, is_root, axis, kind="fused")
    return lkk, y


#: the factor's team: at most this many blocks of a launch (B7 and B8's
#: tail, ``csrc/factor_send.cuh``: kFactorBlocks)
FACTOR_BLOCKS = 16
#: the widest tile B7 and B8 take on the card: their solve is B2's body at
#: 16 column blocks, the most whose sums leave a 512-thread block's 128
#: registers a thread room for the rest (``csrc/factor_send.cuh``: kMaxNb);
#: wider tiles take the unfused path, the same math
FUSED_MAX_NB = 512
#: a warp's 32 lanes; B7's and B8's blocks have 16 warps
_WARPS = 512 // 32


def fused_geometry(sms: int, ranks: int, nb: int, itemsize: int) -> tuple:
    """B7's launch (and B8's tail's): ``(G, FB)``, G blocks per rank, as
    every ring kernel (``sms // ranks``, :func:`_max_blocks`, so that every
    rank's blocks fit the card at once, one block an SM), and the factor's
    team of FB blocks (``min(G, FACTOR_BLOCKS)``) where B1's gate
    (:func:`potrf.cluster_fits <dlaf_tpu_torch.ops.potrf.cluster_fits>`)
    takes the cluster body, 0 where it takes the one-block body, as the
    launchers compute it (``csrc/factor_send.cuh``: factor_blocks).  Raises
    where the card cannot give the cluster body B1's 8 blocks a rank (the
    launchers refuse it)."""
    g = max(1, sms // ranks)
    if not _potrf.cluster_fits_shape(nb, itemsize):
        return g, 0
    fb = min(g, FACTOR_BLOCKS)
    if fb < _potrf.CLUSTER_BLOCKS:
        raise ValueError(f"fused_factor_bcast: {ranks} ranks on {sms} SMs leave {g} blocks a "
                         f"rank, fewer than B1's cluster of {_potrf.CLUSTER_BLOCKS}")
    return g, fb


def chunk_rows(itemsize: int) -> int:
    """Rows of one chunk of the shared panel solve: 16 warps of B2's body,
    each 2 (f32) or 1 (f64) rows (``csrc/factor_send.cuh``:
    rows_per_warp)."""
    return _WARPS * (2 if itemsize == 4 else 1)


def share_lo(nc: int, q: int, p: int) -> int:
    """The first chunk of ring position q's share of nc chunks."""
    return nc * q // p


def solve_shares(below, nb: int, p: int, rows: int) -> tuple:
    """The shared panel solve of B7 and B8's tail: ``(chunks, shares)``.
    ``chunks`` lists, in order, the (tile, first row) of every run of
    ``rows`` rows of the tiles with ``below`` set (the others are zeros,
    not solved); ring position q solves ``chunks[lo:hi]`` for ``(lo, hi) =
    shares[q]`` and publishes a flag for each, which every other position
    waits for before it copies the chunk from q's output.  The kernel
    computes the same in ``csrc/factor_send.cuh`` (solve_send)."""
    runs = -(-nb // rows)
    chunks = [(i, r * rows) for i, b in enumerate(below) if b for r in range(runs)]
    nc = len(chunks)
    return chunks, [(share_lo(nc, q, p), share_lo(nc, q + 1, p)) for q in range(p)]


def fused_flag_words(p: int, blocks: int, ltr: int, nb: int) -> int:
    """64-bit flag words of B7's ring state (``dlaf_fused_flag_words``):
    the root's entry flag, the exit barrier and the factor's barriers
    ([P][G] each), a chunk flag per run of 16 rows (the narrowest chunk)."""
    return 1 + 2 * p * blocks + ltr * -(-nb // 16)


def fused_occupancy(dtype, nb: int, ltr: int, blocks: int) -> dict:
    """B7's residency at a shape on this card: blocks per SM of its kernel,
    its factor's team and shared memory, and, for the cluster design it
    did not take, ``cudaOccupancyMaxActiveClusters`` of B1's cluster of 8
    at this tile (``dlaf_potrf_cluster_occupancy``)."""
    lib = _build.lib()
    out = (ctypes.c_int * 3)()
    f64 = int(dtype == torch.float64)
    _build.check(lib.dlaf_fused_occupancy(f64, nb, ltr, blocks, out), "fused_occupancy")
    clusters = lib.dlaf_potrf_cluster_occupancy(f64, nb, _potrf.CLUSTER_BLOCKS)
    return {"blocks_per_sm": out[0], "factor_blocks": out[1], "smem_bytes": out[2],
            "clusters_of_8_on_an_empty_card": clusters}


def fused_factor_bcast(d, xc, below, root: int, axis: str = "c"):
    """Fused lookahead panel step inside a rank of ``spmd``: ``(lkk, cp)``
    from the broadcast diagonal tile ``d`` (lower triangle read) and this
    rank's panel column ``xc[ltr, nb, nb]``; ``below[ltr]`` (bool) masks the
    tiles strictly below the diagonal and ``root`` is the owning position
    on ``axis``.  The same as ``potrf_tile(d)``, the panel solve, the mask
    and ``ring_bcast``, bit for bit.  CPU tensors take
    :func:`fused_factor_bcast_plain`; CUDA tensors launch B7 or raise.  The
    ranks exchange their ``xc`` and output pointers at the host rendezvous:
    each solves a share of the root's ``xc`` and pulls the others' shares."""
    global fused_launches
    if d.device.type == "cpu" and xc.device.type == "cpu":
        return fused_factor_bcast_plain(d, xc, below, root, axis)
    if d.device.type != "cuda" or xc.device != d.device or below.device != d.device:
        raise ValueError(f"fused_factor_bcast: operands on {d.device}, {xc.device}, {below.device}")
    if not fusion_supported(d, xc):
        raise ValueError(f"fused_factor_bcast: unsupported tile {tuple(d.shape)} {d.dtype} / "
                         f"panel {tuple(xc.shape)} {xc.dtype}")
    if not (d.is_contiguous() and xc.is_contiguous()) or tuple(below.shape) != (xc.shape[0],):
        raise ValueError("fused_factor_bcast: need contiguous d, xc and below[ltr]")
    ctx = _ranks.current()
    world, rt = ctx.world, ctx.world.rt
    pos, n, ring = ctx.axis(axis)
    nb, ltr = d.shape[0], xc.shape[0]
    st = rt.ring((_class_id("fused", axis), ring, ltr, nb, "card-pull"),
                 lambda: _FusedRing(rt, n, _max_blocks(rt), ltr, nb))
    st.epoch[pos] += 1
    lkk, cp = torch.empty_like(d), torch.empty_like(xc)
    below_i = below.to(torch.int32)
    ptrs = _before_launch(ctx, axis, "fused", (xc.data_ptr(), cp.data_ptr()))
    cps = (ctypes.c_void_p * n)(*[p_[1] for p_ in ptrs])
    lib = _build.lib()
    fn = lib.dlaf_fused_factor_bcast_f32 if d.dtype == torch.float32 \
        else lib.dlaf_fused_factor_bcast_f64
    rc = fn(d.data_ptr(), ptrs[root][0], ctypes.addressof(cps), below_i.data_ptr(),
            lkk.data_ptr(), nb, ltr, root, st.flags.data_ptr(), st.scratch.data_ptr(),
            rt.error_word().data_ptr(), n, pos, st.blocks, st.epoch[pos] << 16,
            int(RING_TIMEOUT_S * 1e9), _build.stream_of(d))
    _build.check(rc, f"fused_factor_bcast ({st.blocks} blocks a rank: B1's cluster body takes "
                     f"{_potrf.CLUSTER_BLOCKS} or more)")
    world.ring_launched = True
    with _build.COUNT_LOCK:
        fused_launches += 1
    return lkk, cp
