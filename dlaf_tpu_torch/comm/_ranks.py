"""The rank runtime: every rank of a ``Pr x Pc`` grid as a thread of one
process (the counterpart of ``collectives.spmd``,
``dlaf_tpu/comm/collectives.py:405``).

The JAX package runs all ranks of a grid in one process: ``jit(shard_map(
fn))`` over a mesh, one program per device.  The port does the same with
threads.  :func:`spmd` starts one thread per rank; each thread

- sets a thread-local :class:`RankContext` that ``collectives.my_rank`` and
  ``axis_size`` read (threads do not inherit it: it is set explicitly);
- on the card, makes its own ``torch.cuda.Stream`` current (never the legacy
  default stream, which would serialise against every other rank).  The
  rank streams wait on the caller's stream at entry (an event), and the
  caller's stream waits on every rank's stream at exit;
- runs the per-rank body on its views ``data[r, c]`` of the stacked tensors.

Kernels from different streams of one context run at the same time, so the
ring kernels of one collective (``ops/panel_exchange.py``) run together on
one card and hand data to each other through device memory, as the TPU
kernels hand it over ICI.

Every host-side wait here is bounded (:data:`WAIT_S`) and raises
:class:`~dlaf_tpu_torch.health.DeadlineExceededError` when the bound runs
out.  An exception in one rank body releases the others at once: the
entry barrier is aborted, every waiter wakes and leaves, and on the card
the ring kernels' shared error word is set so that their spins end too.
:func:`spmd` then re-raises the first exception.

What the ranks share for the grid's lifetime lives in :class:`Runtime`
(``grid.runtime``): the rank streams, the ring states (landing slots,
flags and epoch counters, made once per collective class and ring under
the runtime's lock) and the ring kernels' error word.
"""
from __future__ import annotations

import contextvars
import os
import threading
import time
import weakref
from dataclasses import dataclass, field

import torch

from dlaf_tpu_torch.health import ConfigurationError, DeadlineExceededError

#: bound, in seconds, of every host-side wait of the rank runtime (a peer's
#: publish, a landing slot of the plain ring, the entry barrier)
WAIT_S = 120.0

#: what the ring kernels of one collective need from CUDA to run at the
#: same time: eager module loading (under lazy loading a kernel's first
#: launch may wait for the kernels already running, which may be its
#: spinning partners) and a hardware queue per stream (streams beyond
#: CUDA_DEVICE_MAX_CONNECTIONS, 8 by default, share queues, so a spinning
#: kernel can sit in front of its partner).  CUDA reads both when it is
#: initialised in the process.
CUDA_ENV = {"CUDA_MODULE_LOADING": "EAGER", "CUDA_DEVICE_MAX_CONNECTIONS": "32"}
_DEFAULT_CONNECTIONS = 8

#: the values of CUDA_ENV's variables that CUDA reads, when they are known
#: already (CUDA was initialised before :func:`request_cuda_env`)
_cuda_env_read = None


def request_cuda_env() -> None:
    """Set :data:`CUDA_ENV` where the environment does not set its variables
    (the package does it at import).  If CUDA was initialised before, the
    request comes too late: note the values CUDA did read, which
    :class:`Runtime` then checks."""
    global _cuda_env_read
    before = {k: os.environ.get(k) for k in CUDA_ENV}
    for k, v in CUDA_ENV.items():
        os.environ.setdefault(k, v)
    _cuda_env_read = before if torch.cuda.is_initialized() else None


def _check_cuda_settings(n_ranks: int, streams) -> None:
    """Raise ``ConfigurationError`` where the ranks' ring kernels could not
    all run at once: lazy module loading, fewer hardware queues than the
    rank streams, the side stream and the caller's stream, or rank streams
    that are not distinct (PyTorch's pool holds 32 per device)."""
    env = _cuda_env_read if _cuda_env_read is not None else \
        {k: os.environ.get(k) for k in CUDA_ENV}
    when = ("CUDA was initialised before dlaf_tpu_torch was imported; import it first or set "
            "the variable in the environment") if _cuda_env_read is not None else \
        "set it before CUDA is initialised"
    loading = env["CUDA_MODULE_LOADING"]
    if (loading or "").upper() != "EAGER":
        raise ConfigurationError(
            f"a {n_ranks}-rank grid on the card needs CUDA_MODULE_LOADING=EAGER, CUDA read "
            f"{loading!r}: under lazy loading a ring kernel's first launch may wait for its "
            f"spinning partners; {when}")
    try:
        queues = int(env["CUDA_DEVICE_MAX_CONNECTIONS"] or _DEFAULT_CONNECTIONS)
    except ValueError:
        queues = _DEFAULT_CONNECTIONS
    if n_ranks + 2 > queues:
        raise ConfigurationError(
            f"a {n_ranks}-rank grid on the card needs {n_ranks + 2} hardware queues (one per "
            f"rank stream, the side stream and the caller's), CUDA has {queues} "
            f"(CUDA_DEVICE_MAX_CONNECTIONS, at most 32); a smaller grid is required")
    if len({s.cuda_stream for s in streams}) != len(streams):
        raise ConfigurationError(
            f"a {n_ranks}-rank grid on the card needs a distinct stream per rank; PyTorch's "
            f"stream pool gave shared ones")


class Released(Exception):
    """Raised inside a rank that is released because another rank failed;
    :func:`spmd` reports the first rank's exception instead."""


@dataclass
class RankContext:
    """What a rank thread knows about itself (thread-local)."""

    myr: int = 0
    myc: int = 0
    pr: int = 1
    pc: int = 1
    device: torch.device | None = None
    world: "World | None" = None
    #: exchange sequence numbers, one per axis (all ranks of an axis ring
    #: call the exchanges in the same SPMD order, so their numbers agree)
    seq: dict = field(default_factory=dict)

    def axis(self, axis):
        """(position on ``axis``, its size, ring index): the ranks of one
        ring along 'c' share their row, along 'r' their column; the axis
        pair ``('r', 'c')`` is the whole grid, one ring in flat rank order
        ``r * Pc + c`` (the JAX package's order of a tuple of mesh axes)."""
        if axis == "c":
            return self.myc, self.pc, self.myr
        if axis == "r":
            return self.myr, self.pr, self.myc
        if axis == ("r", "c"):
            return self.myr * self.pc + self.myc, self.pr * self.pc, 0
        raise ValueError(f"unknown grid axis {axis!r}")


_tls = threading.local()
_ONE_RANK = RankContext()


def current() -> RankContext:
    """The calling thread's rank context; outside :func:`spmd` the one rank
    of a 1x1 grid."""
    return getattr(_tls, "ctx", None) or _ONE_RANK


class Runtime:
    """Per-grid state shared by the rank threads (``grid.runtime``)."""

    def __init__(self, grid):
        self.device = grid.device
        self.size = grid.size
        #: guards every shared host object of the ranks (the exchange board,
        #: the rings' states); each wait has a condition of its own on it
        self.lock = threading.Lock()
        self.conds = weakref.WeakSet()
        self.rings: dict = {}
        self.streams = None
        self.side = None
        self._err = None
        if grid.device.type == "cuda":
            with torch.cuda.device(grid.device):
                self.streams = [torch.cuda.Stream(grid.device) for _ in range(grid.size)]
                self.side = torch.cuda.Stream(grid.device)
            if grid.size > 1:
                _check_cuda_settings(grid.size, self.streams + [self.side])
                # PyTorch loads its CUDA linear-algebra library at the first
                # linalg call, and two threads making that call at once fail
                # ("lazy wrapper should be called at most once", seen on an
                # H100 with eight rank threads' first solve_triangular): load
                # it here, before any rank thread exists
                with torch.cuda.stream(self.side):
                    one = torch.ones(1, 1, device=grid.device)
                    torch.linalg.solve_triangular(one, one, upper=False)
                self.side.synchronize()

    def error_word(self) -> torch.Tensor:
        """The ring kernels' sticky error word (int32 on the card, zero until
        a bounded spin runs out)."""
        if self._err is None:
            self._err = self.zeros(1, torch.int32)
        return self._err

    def zeros(self, numel: int, dtype) -> torch.Tensor:
        """A zeroed device buffer for the ring kernels, made on a side stream
        and complete before it is returned, so that every rank stream may
        use it at once; marked as used by every rank stream, so that the
        allocator never recycles it under their work."""
        with torch.cuda.stream(self.side):
            t = torch.zeros(numel, dtype=dtype, device=self.device)
        self.side.synchronize()
        for s in self.streams:
            t.record_stream(s)
        return t

    def condition(self) -> threading.Condition:
        """A condition on :attr:`lock` for the waiters of one key (an
        exchange, a rendezvous, a plain ring): an arrival wakes only the
        ranks that wait for it."""
        c = threading.Condition(self.lock)
        self.conds.add(c)
        return c

    def ring(self, key, make):
        """The ring state of ``key``, made by ``make()`` under the lock by
        the first rank that asks for it."""
        with self.lock:
            st = self.rings.get(key)
            if st is None:
                st = self.rings[key] = make()
            return st

    def reset_after_failure(self) -> None:
        """Forget every ring state (epochs and flags no longer agree after a
        failed call) and clear the error word; the card is synchronised
        first, so no kernel still uses the old buffers."""
        if self.streams is not None:
            torch.cuda.synchronize(self.device)
            if self._err is not None:
                self._err.zero_()
                torch.cuda.synchronize(self.device)
        with self.lock:
            self.rings.clear()


def runtime(grid) -> Runtime:
    if grid.runtime is None:
        grid.runtime = Runtime(grid)
    return grid.runtime


class World:
    """The rank threads of one :func:`spmd` call."""

    def __init__(self, rt: Runtime, n: int, wait_s: float):
        self.rt = rt
        self.wait_s = wait_s
        self.error: BaseException | None = None
        self.board: dict = {}
        self.barrier = threading.Barrier(n)
        #: set once a ring kernel was launched in this call: its error word
        #: is read when the call ends
        self.ring_launched = False

    def fail(self, exc: BaseException) -> None:
        with self.rt.lock:
            if self.error is None:
                self.error = exc
            for c in list(self.rt.conds):
                c.notify_all()
        self.barrier.abort()
        if self.rt.streams is not None and self.rt._err is not None:
            # release ring kernels that spin on a rank that will never come
            with torch.cuda.stream(self.rt.side):
                self.rt._err.fill_(-1)

    def wait(self, cond: threading.Condition, pred, label: str) -> None:
        """Wait on ``cond`` (its lock, ``rt.lock``, held by the caller) until
        ``pred()``; raises :class:`Released` when another rank failed and
        ``DeadlineExceededError`` after :attr:`wait_s`."""
        end = time.monotonic() + self.wait_s
        while not pred():
            if self.error is not None:
                raise Released()
            left = end - time.monotonic()
            if left <= 0:
                raise DeadlineExceededError(self.wait_s, label)
            cond.wait(left)


def exchange(axis: str, value: torch.Tensor, sources) -> dict:
    """The in-process transport of the psum and v2 tiers: this rank
    publishes ``value`` (a copy, with an event on the card) on ``axis``,
    and gets the values published by the ring positions in ``sources``.

    On the card this rank's stream waits on each source's event and marks
    the tensor as used on it (``record_stream``), so the allocator does not
    recycle it under the read.  These are library copies, as the JAX
    package's psum/ppermute are XLA collectives."""
    ctx = current()
    world, rt = ctx.world, ctx.world.rt
    pos, n, ring = ctx.axis(axis)
    seq = ctx.seq.get(axis, 0)
    ctx.seq[axis] = seq + 1
    key = (axis, ring, seq)
    mine = value.clone()
    event = None
    if mine.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(mine.device))
    with rt.lock:
        slot = world.board.get(key)
        if slot is None:
            slot = world.board[key] = {"vals": [None] * n, "done": 0, "cond": rt.condition()}
        slot["vals"][pos] = (mine, event)
        slot["cond"].notify_all()
        world.wait(slot["cond"], lambda: all(slot["vals"][s] is not None for s in sources),
                   f"exchange on axis {axis!r}, ring {ring}, call {seq}")
        got = {s: slot["vals"][s] for s in sources}
        slot["done"] += 1
        if slot["done"] == n:
            del world.board[key]
    out = {}
    for s, (t, ev) in got.items():
        if ev is not None:
            stream = torch.cuda.current_stream(t.device)
            stream.wait_event(ev)
            t.record_stream(stream)
        out[s] = t
    return out


def rendezvous(axis: str | None, label: str, value=None) -> list:
    """Wait until every rank of this rank's ring on ``axis`` (of the whole
    grid when ``axis`` is None) has reached the same ring call on the host.
    The ring kernels call it before they are launched: rank threads launch
    asynchronously, and without it a thread could run a whole factorization
    ahead of a slower one, leaving its ring kernels spinning on the card
    past their bound for a partner that has not been launched yet.  It
    bounds the host skew within a ring to one call.  Returns the ``value``
    each rank brought, by ring position (row-major rank on the whole grid):
    the pull exchange hands its ranks the device pointers of their inputs
    this way."""
    ctx = current()
    world, rt = ctx.world, ctx.world.rt
    pos, n, ring = ctx.axis(axis) if axis is not None else \
        (ctx.myr * ctx.pc + ctx.myc, ctx.pr * ctx.pc, 0)
    counter = ("rendezvous", axis)
    seq = ctx.seq.get(counter, 0)
    ctx.seq[counter] = seq + 1
    key = ("rendezvous", axis, ring, seq)
    with rt.lock:
        slot = world.board.get(key)
        if slot is None:
            slot = world.board[key] = {"arrived": 0, "done": 0, "vals": [None] * n,
                                       "cond": rt.condition()}
        slot["vals"][pos] = value
        slot["arrived"] += 1
        slot["cond"].notify_all()
        world.wait(slot["cond"], lambda: slot["arrived"] == n, label)
        vals = list(slot["vals"])
        slot["done"] += 1
        if slot["done"] == n:
            del world.board[key]
    return vals


def _as_caller_result(res, stream):
    """Mark the tensors of a rank's result as used on the caller's stream."""
    if isinstance(res, torch.Tensor):
        if res.is_cuda:
            res.record_stream(stream)
    elif isinstance(res, (tuple, list)):
        for r in res:
            _as_caller_result(r, stream)
    return res


def spmd(grid, fn, *stacked):
    """Run ``fn(*views)`` once per rank, ``views`` being each rank's
    ``x[r, c]`` of the stacked tensors ``[Pr, Pc, ...]``; returns rank
    (0, 0)'s result, in place of the JAX package's rank-replicated ``P()``
    output.

    A 1x1 grid runs ``fn`` in the calling thread.  Otherwise one thread per
    rank; the first exception of any rank is re-raised after the others
    were released, and a ring kernel whose bounded spin ran out raises
    ``DeadlineExceededError`` here."""
    pr, pc = grid.grid_size
    if pr * pc == 1:
        return fn(*[x[0, 0] for x in stacked])
    wait_s = WAIT_S
    rt = runtime(grid)
    n = pr * pc
    world = World(rt, n, wait_s)
    cuda = grid.device.type == "cuda"
    caller = torch.cuda.current_stream(grid.device) if cuda else None
    entry = None
    if cuda:
        rt.error_word()  # made before any rank could need it
        entry = torch.cuda.Event()
        entry.record(caller)
    results = [None] * n
    done = [None] * n

    def rank(r: int, c: int) -> None:
        i = r * pc + c
        _tls.ctx = RankContext(r, c, pr, pc, grid.device, world)
        try:
            world.barrier.wait(wait_s)
            views = [x[r, c] for x in stacked]
            if cuda:
                s = rt.streams[i]
                with torch.cuda.device(grid.device), torch.cuda.stream(s):
                    s.wait_event(entry)
                    results[i] = fn(*views)
                    ev = torch.cuda.Event()
                    ev.record(s)
                    done[i] = ev
            else:
                results[i] = fn(*views)
        except Released:
            pass
        except threading.BrokenBarrierError:
            if world.error is None:
                world.fail(DeadlineExceededError(wait_s, "entry barrier of the rank threads"))
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            world.fail(e)
        finally:
            _tls.ctx = None

    # each rank body runs in a copy of the caller's context: a new thread
    # starts in an empty one, and the ambient gemm_precision_scope
    # (tune.py) must reach the ranks
    threads = [threading.Thread(target=contextvars.copy_context().run, args=(rank, r, c),
                                daemon=True, name=f"dlaf-rank-{r}-{c}")
               for r in range(pr) for c in range(pc)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(wait_s + 60.0)
        if t.is_alive():
            world.fail(DeadlineExceededError(wait_s, f"rank thread {t.name}"))
            t.join(wait_s)
    if world.error is None and any(t.is_alive() for t in threads):
        world.error = DeadlineExceededError(wait_s, "rank threads")
    if world.error is not None:
        rt.reset_after_failure()
        raise world.error
    if cuda:
        for ev in done:
            caller.wait_event(ev)
        if world.ring_launched:
            check_ring_errors(rt)
        _as_caller_result(results[0], caller)
    return results[0]


def check_ring_errors(rt: Runtime) -> None:
    """Raise ``DeadlineExceededError`` if a ring kernel's bounded spin ran
    out since the last check (the error word is read once the caller's
    stream has passed the rank streams), then reset the grid's rings."""
    from dlaf_tpu_torch.ops import panel_exchange as _px

    code = int(rt.error_word().item())
    if code != 0:
        rt.reset_after_failure()
        raise DeadlineExceededError(_px.RING_TIMEOUT_S, _px.describe_error(code))
