"""The ring consumers of the fused trailing-update tier
(``dlaf_tpu_torch/ops/trailing_update.py``): the consume schedule, B6
(``dma_ring_consume``) and B8 (``fused_step``), and lookahead Cholesky and
POSV under ``trailing_update_impl='fused'`` on multi-rank grids.

On the CPU: the schedule against the JAX package's and its backpressure
invariants; B6's plain twin against the JAX kernel in Pallas interpret mode
on a one-axis ring (the merged panel and have bitwise, the trailing matrix
within ``tol_for``), and its events in the schedule's order; B8's twin
bitwise against the two-piece composition the CPU runs (transport plus
one-shot update, the narrow update, ``bcast_diag_tile``, B7's twin), its
diagonal tile feeding the owner's pivot scan; whole factorizations,
'fused' against 'xla' bitwise in the port and against the JAX package
within ``tol_for``, the non-SPD info included, at the 'default' tier and
under bf16x3 and bf16x6; and the slice count B6's and B8's CUDA wrappers
hand their launch at every tier, with the library handle replaced.

On a card only (``-m cuda``, skipped here): B6 and B8 against their twins
at every tier (under the split tiers also on the split probe, one product
per output, bit for bit), B6's and B8's split bodies bit for bit B3-split
on the merged panel masked to the applied slots at ragged shapes and both
split tiers, a skewed B6 run, and the fused tier's factorization against
'xla'.  On the CPU the same identity holds for the twin at every tier
(``test_consume_twin_equals_one_shot_update``).  The JAX side is imported
inside the tests that use it:
``python -m pytest tests/test_torch_consume.py --noconftest -m cuda``
runs the CUDA tests on a machine with no JAX.
"""
import contextlib
import re

import numpy as np
import pytest
import torch

import dlaf_tpu_torch as dtt
from dlaf_tpu_torch import ops, tune
from dlaf_tpu_torch.algorithms import _spmd
from dlaf_tpu_torch.algorithms import cholesky as chol
from dlaf_tpu_torch.comm import _ranks
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm.grid import Grid
from dlaf_tpu_torch.ops import _build
from dlaf_tpu_torch.ops import panel_exchange as px
from dlaf_tpu_torch.ops import tile
from dlaf_tpu_torch.ops import trailing_update as tu
from dlaf_tpu_torch.testing import random_hermitian_pd, random_matrix, tol_for

SHAPES = [(2, 2), (2, 4), (4, 2)]


@contextlib.contextmanager
def knobs(jax_too: bool = True, **kw):
    """Set the same knobs in the port (and the JAX package); restore both."""
    params = [tune.get_tune_parameters()]
    if jax_too:
        from dlaf_tpu import tune as jtune

        params.append(jtune.get_tune_parameters())
    old = [{k: getattr(p, k) for k in kw} for p in params]
    for p in params:
        p.update(**kw)
    try:
        yield
    finally:
        for p, o in zip(params, old):
            p.update(**o)


def _rel_err(got, ref) -> float:
    wide = np.result_type(np.asarray(got).dtype, np.float64)  # complex stays complex
    got, ref = np.asarray(got, wide), np.asarray(ref, wide)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


# ------------------------------------------------------------- the schedule


@pytest.mark.parametrize("nhops", [1, 2, 3, 5, 8])
def test_consume_schedule_matches_jax_and_backpressure(nhops):
    """The JAX package's event list, and its invariants: hop s's update
    precedes the cap_signal licensing the writer's reuse of slot s % 2 at
    hop s + 2, every cap_wait pairs with that signal, and they balance."""
    pytest.importorskip("jax")
    from dlaf_tpu.ops import pallas_trailing_update as ptu

    ev = tu.consume_schedule(nhops)
    assert ev == ptu.consume_schedule(nhops)
    for s in range(nhops):
        idx = {e: i for i, (e, h, _) in enumerate(ev) if h == s}
        assert idx["dma_start"] < idx["recv_wait"] < idx["update"]
        if "cap_signal" in idx:
            assert idx["update"] < idx["cap_signal"]
    waits = [(h, sl) for e, h, sl in ev if e == "cap_wait"]
    signals = [(h, sl) for e, h, sl in ev if e == "cap_signal"]
    assert waits == [(h + 2, sl) for h, sl in signals]
    assert len(waits) == len(signals) == max(nhops - 2, 0)
    order = {(h, sl): i for i, (e, h, sl) in enumerate(ev) if e == "cap_signal"}
    for i, (e, h, sl) in enumerate(ev):
        if e == "cap_wait":
            assert sl == h % 2 and order[(h - 2, sl)] < i


# ----------------------------------------------------------------- B6 twin


def _consume_case(n, slots, contributors, suppress, seed, ltr=3, mb=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, ltr, slots, mb, mb)).astype(np.float32)
    cp = rng.standard_normal((n, ltr, mb, mb)).astype(np.float32)
    y = rng.standard_normal((n, slots, mb, mb)).astype(np.float32)
    h = np.zeros((n, slots, 1), np.int32)
    for slot, rank in contributors.items():
        h[rank, slot, 0] = 1
    z = np.zeros((n, slots, 1), np.int32)
    for rank, slot in suppress:
        z[rank, slot, 0] = 1
    return x, cp, y, h, z


def _consume_on_ranks(grid, x, cp, y, h, z, axis, consume=tu.dma_ring_consume_plain):
    """Run the consume ring on every rank of ``grid`` (stacked [Pr, Pc, ...]
    inputs); returns the stacked (x', yf', h')."""
    ox, oy, oh = x.clone(), torch.empty_like(y), torch.empty_like(h)

    def body(xl, cpl, yl, hl, zl, oyl, ohl):
        _, yy, hh = consume(xl, yl, hl, cpl, zl, axis)
        oyl.copy_(yy)
        ohl.copy_(hh)

    coll.spmd(grid, body, ox, cp, y, h, z, oy, oh)
    return ox, oy, oh


CONSUME_CASES = {
    # slot 1 unowned; owners so that payloads cross the ring; rank 0
    # suppresses its slot 0 (the narrow column)
    "ring2": (2, 3, {0: 1, 2: 0}, [(0, 0)]),
    "ring4": (4, 3, {0: 3, 2: 0}, [(0, 0)]),
    # every slot owned by a distinct rank: every hop applies fresh slots
    # under backpressure
    "ring4_all_owned": (4, 4, {0: 2, 1: 0, 2: 3, 3: 1}, [(1, 2), (3, 0)]),
    # rank 2 applies every slot (its own at entry, the rest as they land);
    # its upstream neighbour, rank 1, suppresses all of its own and applies
    # nothing
    "ring4_one_applies_all": (4, 4, {0: 1, 1: 3, 2: 0, 3: 2},
                              [(1, 0), (1, 1), (1, 2), (1, 3)]),
    # a wider tile than mb = 8, and two row tiles
    "ring2_mb24": (2, 3, {0: 0, 1: 1}, [(1, 2)], {"ltr": 2, "mb": 24}),
    # one rank: no ring, the masked one-shot update
    "single_rank": (1, 2, {0: 0}, []),
}


def _consume_case_of(name: str, seed: int):
    """The inputs of CONSUME_CASES[name], and its tile size."""
    n, slots, contributors, suppress, *kw = CONSUME_CASES[name]
    kw = kw[0] if kw else {}
    return n, _consume_case(n, slots, contributors, suppress, seed, **kw), kw.get("mb", 8)


@pytest.mark.parametrize("case", list(CONSUME_CASES))
def test_consume_twin_matches_pallas_interpret(case):
    """B6's twin on a (1, n) grid of rank threads against the JAX package's
    ``dma_ring_consume`` in interpret mode on an n-device ring: the merged
    panel and have bitwise, the trailing matrix within tol_for(f32, mb)."""
    pytest.importorskip("jax")
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from dlaf_tpu.comm import collectives as jcoll
    from dlaf_tpu.ops import pallas_panel_exchange as ppe
    from dlaf_tpu.ops import pallas_trailing_update as ptu

    n, slots = CONSUME_CASES[case][:2]
    n, (x, cp, y, h, z), mb = _consume_case_of(case, seed=211 + n + slots)
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))

    def fn(xl, cpl, yl, hl, zl):
        sq = lambda v: v.reshape(v.shape[1:])  # noqa: E731
        ox, oy, oh = ptu.dma_ring_consume(sq(xl), sq(yl), sq(hl), sq(cpl), sq(zl), "x", ("x",),
                                          True, ppe.collective_id_for("consume", "x"))
        return ox[None], oy[None], oh[None]

    f = jax.jit(jcoll.shard_map_compat(fn, mesh=mesh, in_specs=(P("x"),) * 5,
                                       out_specs=(P("x"),) * 3))
    rx, ry, rh = (np.asarray(v) for v in f(x, cp, y, h, z))
    grid = Grid.create((1, n), device="cpu")
    ox, oy, oh = _consume_on_ranks(grid, *(torch.from_numpy(v)[None] for v in (x, cp, y, h, z)),
                                   axis="c")
    np.testing.assert_array_equal(oy[0].numpy(), ry)
    np.testing.assert_array_equal(oh[0].numpy(), rh)
    assert _rel_err(ox[0].numpy(), rx) <= tol_for(np.float32, mb)


@pytest.mark.parametrize("tier", ["default", "bf16x3", "bf16x6"])
@pytest.mark.parametrize("case", list(CONSUME_CASES))
def test_consume_twin_equals_one_shot_update(case, tier):
    """B6's twin on every rank, under ``gemm_precision_scope(tier)``, gives
    bit for bit x minus the one-shot update at the tier of its merged panel
    masked to the slots it applies (held on the ring and not suppressed),
    every other slot zero: each output takes one slot, and the hops' zero
    contributions leave x as it was.  This is the identity the card's
    kernel is held to against B3 (B3-split at a split tier)."""
    n, slots = CONSUME_CASES[case][:2]
    n, arrays, _ = _consume_case_of(case, seed=97 + n + slots)
    x, cp, y, h, z = (torch.from_numpy(v)[None] for v in arrays)
    with tune.gemm_precision_scope(tier):
        ox, oy, oh = _consume_on_ranks(Grid.create((1, n), device="cpu"), x, cp, y, h, z, "c")
    zero = torch.zeros((), dtype=oy.dtype)
    for r in range(n):
        applied = (oh[0, r, :, 0] != 0) & (z[0, r, :, 0] == 0)
        want = x[0, r] - tile.contract(tu.CHOLESKY_SUBSCRIPTS, cp[0, r],
                                       torch.where(applied[:, None, None], oy[0, r], zero), tier)
        np.testing.assert_array_equal(ox[0, r].numpy(), want.numpy())


@pytest.mark.parametrize("n", [2, 3, 5])
def test_consume_twin_runs_the_schedule(n):
    """The twin's events on every rank are consume_schedule(n - 1), in that
    order, and what it returns is the one-shot update of the merged panel
    with the suppressed slots left out."""
    slots = n + 1
    contributors = {s: s % n for s in range(slots - 1)}  # the last slot unowned
    x, cp, y, h, z = (torch.from_numpy(v)[None] for v in
                      _consume_case(n, slots, contributors, [(0, 1)], seed=5, ltr=2))
    grid = Grid.create((1, n), device="cpu")
    events = {}

    def consume(xl, yl, hl, cpl, zl, axis):
        mine = events.setdefault(coll.my_rank(), [])
        return tu.dma_ring_consume_plain(xl, yl, hl, cpl, zl, axis, events=mine)

    ox, oy, oh = _consume_on_ranks(grid, x, cp, y, h, z, "c", consume)
    assert len(events) == n
    for ev in events.values():
        assert ev == tu.consume_schedule(n - 1)
    merged = y[0, 0].clone()
    for s, r in contributors.items():
        merged[s] = y[0, r, s]
    for r in range(n):
        assert torch.equal(oy[0, r][:-1], merged[:-1]) and torch.equal(oh[0, r, :, 0] != 0,
                                                                       torch.arange(slots) < slots - 1)
        mask = (torch.arange(slots) < slots - 1) & (z[0, r, :, 0] == 0)
        want = x[0, r] - torch.einsum(tu.CHOLESKY_SUBSCRIPTS, cp[0, r],
                                      torch.where(mask[:, None, None], merged, 0))
        assert _rel_err(ox[0, r].numpy(), want.numpy()) <= tol_for(np.float32, 8)


# ----------------------------------------------------------------- B8 twin


def _step_inputs(shape, n=64, mb=8, k=2, seed=7, bad_pivot=None):
    a = random_hermitian_pd(n, np.float64, seed)
    if bad_pivot is not None:
        a[bad_pivot, bad_pivot] = -30.0
    return Grid.create(shape, device="cpu"), np.tril(a), mb, k


def _two_piece(x, cp, k, g, gi, gj):
    """The CPU's lookahead body of step k under the fused tier: transport
    plus one-shot update, the narrow update, then panel k+1."""
    myr, myc = coll.my_rank()
    k1 = k + 1
    taken, have = coll.transpose_panel_parts(cp, g.mt, g.ltc)
    _, rp = tu.fused_transpose_update(x, cp, taken, have, gj == k1, "r")
    l_next = k1 // g.pc
    if myc == k1 % g.pc:
        xc1 = x[:, l_next]
        xc1 -= torch.einsum("iab,cb->iac", cp, rp[l_next])
    d1 = _spmd.bcast_diag_tile(x, k1, g, myr, myc)
    lkk1, cp1 = chol._fused_panel_bcast(d1, x[:, l_next], gi > k1, k1 % g.pc)
    return rp, lkk1, cp1, d1


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_fused_step_twin_equals_two_piece(shape):
    """B8's twin and the two-piece composition give the same bits for every
    output of a lookahead step on every rank (B7's twin produces panel k
    first); the twin's diagonal tile is the one the owner's pivot scan
    reads, and finds a non-positive pivot planted in it."""
    grid, a, mb, k = _step_inputs(shape, bad_pivot=3 * 8 + 5)  # in diagonal tile k + 1 = 3
    mat = dtt.DistributedMatrix.from_global(grid, a, (mb, mb))
    g = _spmd.Geometry.of(mat.dist)
    outs = {}
    with knobs(jax_too=False, collectives_impl="pallas", panel_trsm_pallas=True):
        for mode in ("twin", "two_piece"):
            x_all = mat.data.clone()

            def body(x):
                myr, myc = coll.my_rank()
                gi = _spmd.local_row_tiles(g, myr, x.device)
                gj = _spmd.local_col_tiles(g, myc, x.device)
                d = _spmd.bcast_diag_tile(x, k, g, myr, myc)
                _, cp = chol._fused_panel_bcast(d, x[:, k // g.pc], gi > k, k % g.pc)
                if mode == "twin":
                    k1 = k + 1
                    params = (k1 % g.pc, k1 % g.pr, k1 // g.pc, k1 // g.pr, k1 // g.pc)
                    got = tu.fused_step(x, *coll.transpose_panel_parts(cp, g.mt, g.ltc),
                                        gj == k1, cp, gi > k1, params)[1:]
                else:
                    got = _two_piece(x, cp, k, g, gi, gj)
                owner = (myr, myc) == ((k + 1) % g.pr, (k + 1) % g.pc)
                outs[(mode, myr, myc)] = [t.clone() for t in (x, *got)] + [
                    chol._pivot_scan(got[-1]) if owner else None]

            coll.spmd(grid, body, x_all)
    for r in range(shape[0]):
        for c in range(shape[1]):
            twin, two = outs[("twin", r, c)], outs[("two_piece", r, c)]
            for p, q in zip(twin[:-1], two[:-1]):  # NaN where the planted pivot fails, in both
                np.testing.assert_array_equal(p.numpy(), q.numpy())
            if twin[-1] is not None:
                assert int(twin[-1]) == int(two[-1]) == 6  # pivot 5 of the tile, 1-based


def test_fused_step_gate_is_the_jax_packages():
    assert tu.fused_step_supported(torch.zeros(2, 2, 128, 128), torch.zeros(2, 128, 128))
    assert tu.fused_step_supported(torch.zeros(1, 1, 1024, 1024, dtype=torch.float64),
                                   torch.zeros(1, 1024, 1024, dtype=torch.float64))
    for x, cp in ((torch.zeros(2, 2, 192, 192), torch.zeros(2, 192, 192)),   # not % 128
                  (torch.zeros(1, 1, 2048, 2048), torch.zeros(1, 2048, 2048)),  # > MAX_NB
                  (torch.zeros(2, 2, 128, 128, dtype=torch.complex64),
                   torch.zeros(2, 128, 128, dtype=torch.complex64)),
                  (torch.zeros(2, 2, 128, 64), torch.zeros(2, 128, 64))):
        assert not tu.fused_step_supported(x, cp)


# --------------------------------------------------- whole factorizations

_JAX_REF: dict = {}


def _jax_factor(comm_grids, shape, a, mb, **kw):
    import dlaf_tpu as dt

    key = (shape, a.dtype.str, mb, tuple(sorted(kw.items())))
    if key not in _JAX_REF:
        jgrid = next(g for g in comm_grids if tuple(g.grid_size) == shape)
        jm = dt.DistributedMatrix.from_global(jgrid, a, (mb, mb))
        with knobs(**kw):
            fac, info = dt.cholesky_factorization("L", jm, return_info=True)
            _JAX_REF[key] = (np.tril(fac.to_global()), int(info))
    return _JAX_REF[key]


def _port_factor(shape, a, mb, **kw):
    mat = dtt.DistributedMatrix.from_global(Grid.create(shape, device="cpu"), a, (mb, mb))
    with knobs(jax_too=False, **kw):
        fac, info = dtt.cholesky_factorization("L", mat, return_info=True)
    return fac.to_stacked(), np.tril(fac.to_global()), int(info)


@pytest.mark.parametrize("tier", ["psum", "v2", "pallas"])
@pytest.mark.parametrize("shape,dtype,gemm", [pytest.param(s, np.float32, "default", id=f"shape{i}")
                                              for i, s in enumerate(SHAPES)]
                         + [pytest.param((2, 4), np.complex64, "default", id="shape1-complex64"),
                            pytest.param((2, 4), np.float32, "bf16x3", id="shape1-bf16x3"),
                            pytest.param((2, 4), np.float32, "bf16x6", id="shape1-bf16x6")])
def test_lookahead_fused_matches_xla_and_jax(comm_grids, shape, dtype, gemm, tier):
    """Lookahead Cholesky under 'fused' on rank threads: bitwise the 'xla'
    tier's factor in the port, and within tol_for of the JAX package's
    fused tier; f32 on every shape, c64 on 2x4, and f32 on 2x4 under the
    bf16x3 and bf16x6 split-GEMM tiers (B6's and B8's twins, the narrow
    update of column k+1 and the 'xla' update all split in
    ``tile.contract``)."""
    pytest.importorskip("jax")
    n, mb = 60, 8
    a = np.tril(random_hermitian_pd(n, dtype, 41)) + np.triu(random_matrix(n, n, dtype, 42), 1)
    ref, jinfo = _jax_factor(comm_grids, shape, a, mb, cholesky_lookahead=True,
                             trailing_update_impl="fused", gemm_precision=gemm)
    out = {}
    for impl in ("xla", "fused"):
        out[impl] = _port_factor(shape, a, mb, collectives_impl=tier, cholesky_lookahead=True,
                                 trailing_update_impl=impl, gemm_precision=gemm)
    np.testing.assert_array_equal(out["fused"][0], out["xla"][0])
    assert out["fused"][2] == out["xla"][2] == jinfo == 0
    assert np.isfinite(out["fused"][1]).all()
    assert _rel_err(out["fused"][1], ref) <= tol_for(dtype, n)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_fused_info_on_non_spd_matches_xla_and_jax(comm_grids, shape):
    """A first failure in tile 3 (owned off rank (0, 0)) and a later one in
    tile 5: the fused tier's info is the 'xla' tier's and the JAX
    package's."""
    pytest.importorskip("jax")
    n, mb = 56, 8
    a = random_hermitian_pd(n, np.float64, 25)
    a[27, 27] = a[45, 45] = -40.0  # the leading minors of order 28 and 46 fail
    _, jinfo = _jax_factor(comm_grids, shape, a, mb, cholesky_lookahead=True,
                           trailing_update_impl="fused", collectives_impl="pallas")
    infos = [_port_factor(shape, a, mb, collectives_impl="pallas", cholesky_lookahead=True,
                          trailing_update_impl=impl)[2] for impl in ("xla", "fused")]
    assert infos == [jinfo, jinfo] and jinfo == 28


def test_posv_fused_matches_xla_and_jax(comm_grids):
    """POSV with both lookahead kernels under 'fused' on 2x4: bitwise the
    'xla' tier's solution, within tol_for of the JAX package's."""
    pytest.importorskip("jax")
    import dlaf_tpu as dt

    n, mb = 48, 8
    a = random_hermitian_pd(n, np.float64, 43)
    b = random_matrix(n, 16, np.float64, 47)
    kw = dict(cholesky_lookahead=True, trsm_lookahead=True, collectives_impl="pallas")
    jgrid = next(g for g in comm_grids if tuple(g.grid_size) == (2, 4))
    with knobs(trailing_update_impl="fused", **kw):
        ref = dt.positive_definite_solver("L", dt.DistributedMatrix.from_global(jgrid, np.tril(a), (mb, mb)),
                                          dt.DistributedMatrix.from_global(jgrid, b, (mb, mb))).to_global()
    out = {}
    for impl in ("xla", "fused"):
        grid = Grid.create((2, 4), device="cpu")
        with knobs(jax_too=False, trailing_update_impl=impl, **kw):
            out[impl] = dtt.positive_definite_solver(
                "L", dtt.DistributedMatrix.from_global(grid, np.tril(a), (mb, mb)),
                dtt.DistributedMatrix.from_global(grid, b, (mb, mb))).to_global()
    np.testing.assert_array_equal(out["fused"], out["xla"])
    assert _rel_err(out["fused"], ref) <= tol_for(np.float64, n)


def test_cpu_fused_tier_launches_nothing():
    ops.reset_launch_counts()
    _port_factor((2, 2), np.tril(random_hermitian_pd(32, np.float64, 3)), 8,
                 collectives_impl="pallas", cholesky_lookahead=True, trailing_update_impl="fused")
    assert set(ops.launch_counts().values()) == {0}


# -------------------------------------- the slice count the wrappers launch


def _step_fields() -> list:
    """B8's argument names in the library's order, read from the X-macro
    lists of ``csrc/consume.cu`` as ``dlaf_fused_step_fields`` joins them."""
    src = (_build.SRC_DIR / "consume.cu").read_text()

    def names(macro):
        body = re.search(rf"#define {macro}\(X\)((?:[^\n]*\\\n)*[^\n]*)", src).group(1)
        return re.findall(r"X\(\w+, (\w+)\)", body)

    rings = int(re.search(r"constexpr int kRingCount = (\d+);", src).group(1))
    return (names("DLAF_STEP_HEAD")
            + [f"ring{q}_{f}" for q in range(rings) for f in names("DLAF_RING_FIELDS")]
            + names("DLAF_STEP_TAIL"))


class _FakeLib:
    """Stands in for the kernel library: records every call, launches
    nothing, returns success."""

    def __init__(self):
        self.calls = []

    def dlaf_fused_step_fields(self):
        return ",".join(_step_fields()).encode()

    def __getattr__(self, name):
        if not name.startswith("dlaf_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("tier", ["default", "bf16x3", "bf16x6", "auto"])
def test_ring_wrappers_launch_the_resolved_slices(tier, monkeypatch):
    """B6's and B8's CUDA wrappers, driven on a CPU grid with the library
    handle replaced (and the device checks, the card's SM count and its
    ring buffers stood in for), hand their launch the slice count of the
    tier ``tile.contract`` resolves for their update: 0 at 'default', 2 at
    'bf16x3', 3 at 'bf16x6'; 'auto', with the operands taken for the
    card's, splits at K >= 512 only (bf16x3 for f32, bf16x6 for f64), as
    the JAX rule has it, so that red2band's K = 128 and M5's K = 192 stay
    at 'default'.  The split launches are counted apart."""
    lib = _FakeLib()
    monkeypatch.setattr(tu, "_plain", lambda *ts: False)
    monkeypatch.setattr(tu, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(px, "_max_blocks", lambda rt: 4)
    monkeypatch.setattr(_ranks.Runtime, "zeros",
                        lambda self, numel, dtype: torch.zeros(numel, dtype=dtype))
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    if tier == "auto":
        monkeypatch.setattr(tune, "on_accelerator", lambda device: True)
    grid = Grid.create((2, 2), device="cpu")

    def want(dtype, k):
        if tier == "auto":
            return 0 if k < tile.AUTO_SPLIT_MIN_K else (3 if dtype == torch.float64 else 2)
        return {"default": 0, "bf16x3": 2, "bf16x6": 3}[tier]

    def b6(x, y, cp):
        h = torch.ones(y.shape[0], 1, dtype=torch.int32)
        tu.dma_ring_consume(x, y, h, cp, torch.zeros_like(h), "r")

    def b8(x, cp):
        ltc = x.shape[1]
        tu.fused_step(x, cp.clone(), torch.ones(ltc, dtype=torch.bool),
                      torch.zeros(ltc, dtype=torch.bool), cp,
                      torch.ones(x.shape[0], dtype=torch.bool), (0, 0, 0, 0, 0))

    with knobs(jax_too=False, gemm_precision=tier, collectives_impl="pallas"):
        for dtype in (torch.float32, torch.float64):
            for k in (128, 512):
                before = {**ops.launch_counts(), **ops.sub_counts()}
                lib.calls.clear()
                coll.spmd(grid, b6, torch.zeros(2, 2, 1, 2, 8, 8, dtype=dtype),
                          torch.zeros(2, 2, 2, 8, k, dtype=dtype),
                          torch.zeros(2, 2, 1, 8, k, dtype=dtype))
                coll.spmd(grid, b8, torch.zeros(2, 2, 1, 1, k, k, dtype=dtype),
                          torch.zeros(2, 2, 1, k, k, dtype=dtype))
                suffix = "f64" if dtype == torch.float64 else "f32"
                ns = want(dtype, k)
                # the slice count: B6's 22nd argument, B8's 2nd
                got = sorted((name, args[21] if "consume" in name else args[1])
                             for name, args in lib.calls)
                assert got == ([(f"dlaf_dma_ring_consume_{suffix}", ns)] * 4
                               + [(f"dlaf_fused_step_{suffix}", ns)] * 4)
                after = {**ops.launch_counts(), **ops.sub_counts()}
                assert {k_: after[k_] - before[k_] for k_ in after if after[k_] != before[k_]} \
                    == {"dma_ring_consume": 4, "fused_step": 4,
                        **({"dma_ring_consume_split": 4, "fused_step_split": 4} if ns else {})}


# ------------------------------------------------------------ card only


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _assert_b3_bitwise(got_x, x0, cp, panel, applied, tier="default"):
    """x after B6 or B8 (stacked [Pr, Pc, ...] on the card) bit for bit B3
    at ``tier`` (B3-split at a split tier) applied once on every rank to
    ``x0`` with the merged ``panel`` masked to the ``applied`` slots, every
    other slot zero; the same check rejects B3 with the last k16 slice of
    one applied slot dropped."""
    dev = got_x.device
    x0, cp, panel, applied = (t.to(dev) for t in (x0, cp, panel, applied))
    masked = torch.where(applied[..., None, None], panel, torch.zeros((), dtype=panel.dtype,
                                                                      device=dev))
    want = x0.clone()
    for r in range(x0.shape[0]):
        for c in range(x0.shape[1]):
            tu.trailing_update(want[r, c], cp[r, c].contiguous(), masked[r, c].contiguous(),
                               tu.CHOLESKY_SUBSCRIPTS, tier)
    # the first applied slot whose last k slice meets a non-zero one of cp
    kd = (panel.shape[-1] - 1) // 16 * 16
    live = (masked[..., kd:] != 0).flatten(-2).any(-1) & (cp[..., kd:] != 0).flatten(2).any(-1)[
        ..., None]
    r, c, s = (int(v) for v in (applied & live).nonzero()[0])
    dropped = masked[r, c].clone()
    dropped[s, :, kd:] = 0
    wrong = tu.trailing_update(x0[r, c].clone(), cp[r, c].contiguous(), dropped,
                               tu.CHOLESKY_SUBSCRIPTS, tier)
    torch.cuda.synchronize()
    words = torch.int32 if got_x.dtype == torch.float32 else torch.int64
    assert not torch.equal(wrong.view(words), want[r, c].view(words))
    assert torch.equal(got_x.view(words), want.view(words))


@pytest.mark.cuda
@pytest.mark.parametrize("mb", [96, 128, 192])
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("axis,dtype", [("r", torch.float32), ("c", torch.float32),
                                        ("c", torch.float64)])
def test_cuda_consume_matches_twin(axis, dtype, skew, mb, monkeypatch):
    """B6 on a 2x4 grid against its twin on a CPU grid of the same shape:
    the merged panel and have bitwise, the trailing matrix within
    tol_for(dtype, K) and bit for bit B3 on the merged panel masked to the
    applied slots; the ring over 'c' has 3 hops (acks in use); with
    ``skew`` rank (0, 1) sleeps 50 ms before each launch."""
    dev = _cuda()
    pr, pc, ltr, slots = 2, 4, 3, 6
    n = pr if axis == "r" else pc
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(pr, pc, ltr, slots, mb, mb, generator=gen, dtype=dtype)
    cp = torch.randn(pr, pc, ltr, mb, mb, generator=gen, dtype=dtype)
    y = torch.randn(pr, pc, slots, mb, mb, generator=gen, dtype=dtype)
    h = torch.zeros(pr, pc, slots, 1, dtype=torch.int32)
    z = torch.zeros(pr, pc, slots, 1, dtype=torch.int32)
    for s in range(slots - 1):  # one contributor per slot on each ring, the last slot none
        if axis == "r":
            h[s % n, :, s] = 1
        else:
            h[:, s % n, s] = 1
    z[:, :, 1] = 1
    ref = _consume_on_ranks(Grid.create((pr, pc), device="cpu"), x, cp, y, h, z, axis)
    if skew:
        monkeypatch.setitem(px.launch_delay_s, (0, 1), 0.05)
    before = tu.consume_launches
    got = _consume_on_ranks(Grid.create((pr, pc), device=dev),
                            *(t.to(dev) for t in (x, cp, y, h, z)), axis=axis,
                            consume=tu.dma_ring_consume)
    torch.cuda.synchronize()
    assert tu.consume_launches == before + pr * pc
    assert torch.equal(got[1].cpu(), ref[1]) and torch.equal(got[2].cpu(), ref[2])
    err = _rel_err((got[0].cpu() - x).numpy(), (ref[0] - x).numpy())
    assert err <= tol_for(np.float32 if dtype == torch.float32 else np.float64, mb)
    _assert_b3_bitwise(got[0], x, cp, got[1], (ref[2][..., 0] != 0) & (z[..., 0] == 0))


@pytest.mark.cuda
@pytest.mark.parametrize("mb", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_fused_step_matches_twin(dtype, mb):
    """B8 on a 2x4 grid (mb a multiple of 128, as its gate asks) against
    its twin on a CPU grid, on the same inputs (panel k made by B7's twin),
    every output within tol_for(dtype, mb), and x bit for bit B3 on the
    merged panel masked to the slots B8 applies (held on the ring over 'r'
    and not suppressed, and the narrow slot on column k+1's ranks)."""
    dev = _cuda()
    n, k = 12 * mb, 3
    a = torch.from_numpy(np.tril(random_hermitian_pd(n, np.float64, 17))).to(dtype)
    cpu = Grid.create((2, 4), device="cpu")
    mat = dtt.DistributedMatrix.from_global(cpu, a, (mb, mb))
    g = _spmd.Geometry.of(mat.dist)
    cps = torch.empty(2, 4, g.ltr, mb, mb, dtype=dtype)

    def panel(x, cpo):
        myr, myc = coll.my_rank()
        gi = _spmd.local_row_tiles(g, myr, x.device)
        d = _spmd.bcast_diag_tile(x, k, g, myr, myc)
        cpo.copy_(px.fused_factor_bcast(d, x[:, k // g.pc].contiguous(), gi > k, k % g.pc)[1])

    def step(x, cp, rp, lkk, cp1, d1):
        myr, myc = coll.my_rank()
        gi = _spmd.local_row_tiles(g, myr, x.device)
        gj = _spmd.local_col_tiles(g, myc, x.device)
        k1 = k + 1
        params = (k1 % g.pc, k1 % g.pr, k1 // g.pc, k1 // g.pr, k1 // g.pc)
        got = tu.fused_step(x, *coll.transpose_panel_parts(cp, g.mt, g.ltc), gj == k1, cp,
                            gi > k1, params)
        for o, t in zip((rp, lkk, cp1, d1), got[1:]):
            o.copy_(t)

    with knobs(jax_too=False, collectives_impl="pallas"):
        coll.spmd(cpu, panel, mat.data, cps)
        outs = {}
        for grid in (cpu, Grid.create((2, 4), device=dev)):
            w = grid.device
            args = [mat.data.clone().to(w), cps.to(w), torch.empty(2, 4, g.ltc, mb, mb, dtype=dtype),
                    torch.empty(2, 4, mb, mb, dtype=dtype), torch.empty_like(cps),
                    torch.empty(2, 4, mb, mb, dtype=dtype)]
            args = args[:2] + [t.to(w) for t in args[2:]]
            before = tu.step_launches
            coll.spmd(grid, step, *args)
            if w.type == "cuda":
                torch.cuda.synchronize()
                assert tu.step_launches == before + 8
            outs[w.type] = [args[0]] + args[2:]
    tol = tol_for(np.float32 if dtype == torch.float32 else np.float64, mb)
    for got, want in zip(outs["cuda"], outs["cpu"]):
        err = torch.linalg.vector_norm((got.cpu() - want).double()) / torch.linalg.vector_norm(
            want.double())
        assert err <= tol
    haves = torch.empty(2, 4, g.ltc, dtype=torch.bool)
    supps = torch.empty_like(haves)

    def masks(cp, hv, sp):
        gj = _spmd.local_col_tiles(g, coll.my_rank()[1], cp.device)
        hv.copy_(coll.transpose_panel_parts(cp, g.mt, g.ltc)[1])
        sp.copy_(gj == k + 1)

    coll.spmd(cpu, masks, cps, haves, supps)
    narrow = torch.zeros_like(supps)
    narrow[:, (k + 1) % g.pc, (k + 1) // g.pc] = True
    held = haves.any(dim=0, keepdim=True).expand_as(haves)
    _assert_b3_bitwise(outs["cuda"][0], mat.data, cps, outs["cuda"][1],
                       held & (~supps | narrow))


@pytest.mark.cuda
@pytest.mark.parametrize("mb,kernel", [(128, "fused_step"), (96, "dma_ring_consume")])
def test_cuda_cholesky_fused_matches_xla(mb, kernel):
    """Lookahead Cholesky on a 2x4 grid of the card: 'fused' launches B8
    (mb % 128 == 0) or B6 once per step and rank, and its factor is the
    'xla' tier's within tol_for(f32, n); the info of a non-SPD input is
    the 'xla' tier's."""
    dev = _cuda()
    n = 20 * mb
    a = torch.from_numpy(np.tril(random_hermitian_pd(n, np.float32, 19))).to(dev)
    bad = a.clone()
    bad[7 * mb + 3, 7 * mb + 3] = -50.0  # tile 7: owned by rank (1, 3)
    out = {}
    for impl in ("xla", "fused"):
        with knobs(jax_too=False, collectives_impl="pallas", cholesky_lookahead=True,
                   trailing_update_impl=impl, panel_trsm_pallas=True):
            grid = Grid.create((2, 4), device=dev)
            ops.reset_launch_counts()
            fac, info = dtt.cholesky_factorization(
                "L", dtt.DistributedMatrix.from_global(grid, a.clone(), (mb, mb)), return_info=True)
            counts = ops.launch_counts()
            _, bad_info = dtt.cholesky_factorization(
                "L", dtt.DistributedMatrix.from_global(grid, bad.clone(), (mb, mb)),
                return_info=True)
            out[impl] = (np.tril(fac.to_global()), int(info), int(bad_info), counts)
    assert out["fused"][1] == out["xla"][1] == 0
    assert out["fused"][2] == out["xla"][2] == 7 * mb + 4
    assert _rel_err(out["fused"][0], out["xla"][0]) <= tol_for(np.float32, n)
    assert out["fused"][3][kernel] == 8 * (n // mb - 1)
    assert out["xla"][3][kernel] == 0


@pytest.mark.cuda
def test_cuda_consume_skips_the_slots_it_does_not_apply():
    """B6 applies only the slots it takes (held on the ring and not
    suppressed); the twin multiplies the masked full panel, as the JAX
    kernel does, so a NaN in ``cp`` reaches the columns of a slot that no
    rank holds in the twin's result and not in the kernel's.  Elsewhere
    both agree."""
    dev = _cuda()
    ltr, slots, mb = 2, 3, 64
    gen = torch.Generator().manual_seed(29)
    x = torch.randn(1, 2, ltr, slots, mb, mb, generator=gen)
    cp = torch.randn(1, 2, ltr, mb, mb, generator=gen)
    cp[:, :, 0, 5, 7] = float("nan")
    y = torch.randn(1, 2, slots, mb, mb, generator=gen)
    h = torch.zeros(1, 2, slots, 1, dtype=torch.int32)
    h[0, 0, 0] = h[0, 1, 1] = 1  # slot 2: held by no rank
    z = torch.zeros_like(h)
    ref = _consume_on_ranks(Grid.create((1, 2), device="cpu"), x, cp, y, h, z, "c")
    got = _consume_on_ranks(Grid.create((1, 2), device=dev),
                            *(t.to(dev) for t in (x, cp, y, h, z)), axis="c",
                            consume=tu.dma_ring_consume)
    gx = got[0].cpu()
    assert torch.isnan(ref[0][..., 2, :, :]).any() and torch.equal(gx[..., 2, :, :],
                                                                    x[..., 2, :, :])
    both = torch.isfinite(ref[0][..., :2, :, :]) & torch.isfinite(gx[..., :2, :, :])
    assert torch.equal(torch.isnan(gx[..., :2, :, :]), torch.isnan(ref[0][..., :2, :, :]))
    assert _rel_err((gx[..., :2, :, :] - x[..., :2, :, :])[both].numpy(),
                    (ref[0][..., :2, :, :] - x[..., :2, :, :])[both].numpy()) <= tol_for(np.float32, mb)


def _one_per_row(t, seed):
    """``t[..., rows, K]`` with one non-zero left in each row, so that every
    output of the update ``x -= cp @ t^T`` is a single product: float32
    accumulation then adds no rounding, and a split body must give the
    plain split's bits."""
    g = torch.Generator().manual_seed(seed)
    k = torch.randint(0, t.shape[-1], t.shape[:-1] + (1,), generator=g)
    keep = torch.zeros(t.shape, dtype=torch.bool).scatter_(-1, k, True)
    return torch.where(keep, t, torch.zeros((), dtype=t.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("axis,dtype,tier", [("r", torch.float32, "bf16x3"),
                                             ("c", torch.float32, "bf16x3"),
                                             ("c", torch.float64, "bf16x6")])
def test_cuda_consume_split_matches_twin(axis, dtype, tier):
    """B6's split body (``gemm_precision`` bf16x3 / bf16x6) on a 2x4 grid
    against its twin at the tier on a CPU grid: the merged panel and have
    bitwise; the applied update within tol_for(f32, K) on normal operands
    (a split tier is float32 class); on the split probe bit for bit, and
    more than 1e-10 from the 'default' twin's (a body that ran the default
    tier fails).  Over 'c' the ring has 3 hops, so landing slots are
    reused (the split body reads them through L2).  Every launch runs the
    split instantiation."""
    dev = _cuda()
    pr, pc, ltr, slots, mb = 2, 4, 3, 6, 96
    n = pr if axis == "r" else pc
    gen = torch.Generator().manual_seed(31)
    x = torch.randn(pr, pc, ltr, slots, mb, mb, generator=gen, dtype=dtype)
    cp = torch.randn(pr, pc, ltr, mb, mb, generator=gen, dtype=dtype)
    y = torch.randn(pr, pc, slots, mb, mb, generator=gen, dtype=dtype)
    h = torch.zeros(pr, pc, slots, 1, dtype=torch.int32)
    z = torch.zeros(pr, pc, slots, 1, dtype=torch.int32)
    for s in range(slots - 1):
        if axis == "r":
            h[s % n, :, s] = 1
        else:
            h[:, s % n, s] = 1
    z[:, :, 1] = 1
    cpu, gpu = Grid.create((pr, pc), device="cpu"), Grid.create((pr, pc), device=dev)
    for probe in (False, True):
        yy = _one_per_row(y, 5) if probe else y
        with knobs(jax_too=False, gemm_precision=tier):
            ref = _consume_on_ranks(cpu, x, cp, yy, h, z, axis)
            before = (tu.consume_launches, tu.consume_split_launches)
            got = _consume_on_ranks(gpu, *(t.to(dev) for t in (x, cp, yy, h, z)), axis=axis,
                                    consume=tu.dma_ring_consume)
            torch.cuda.synchronize()
        assert (tu.consume_launches, tu.consume_split_launches) == (before[0] + pr * pc,
                                                                    before[1] + pr * pc)
        assert torch.equal(got[1].cpu(), ref[1]) and torch.equal(got[2].cpu(), ref[2])
        gx = got[0].cpu()
        if probe:
            with knobs(jax_too=False, gemm_precision="default"):
                default = _consume_on_ranks(cpu, x, cp, yy, h, z, axis)[0]
            assert torch.equal(gx, ref[0])
            assert _rel_err((gx - x).numpy(), (default - x).numpy()) > 1e-10
        else:
            assert _rel_err((gx - x).numpy(), (ref[0] - x).numpy()) <= tol_for(np.float32, mb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tier", [(torch.float32, "bf16x3"), (torch.float64, "bf16x6")])
def test_cuda_fused_step_split_matches_twin(dtype, tier):
    """B8 with its consume phase split, on a 2x4 grid (mb = 128), against
    its twin at the tier on a CPU grid.  The column panel is the split
    probe (one non-zero per row, so every output of the consume update,
    column k+1's narrow update included, is one product): x and the merged
    row panel bit for bit the twin's, x more than 1e-10 from the 'default'
    twin's; the factor, the new panel and the diagonal tile within
    tol_for(dtype, mb)."""
    dev = _cuda()
    n, mb, k = 1536, 128, 3
    a = torch.from_numpy(np.tril(random_hermitian_pd(n, np.float64, 23))).to(dtype)
    cpu = Grid.create((2, 4), device="cpu")
    mat = dtt.DistributedMatrix.from_global(cpu, a, (mb, mb))
    g = _spmd.Geometry.of(mat.dist)
    cps = _one_per_row(torch.randn(2, 4, g.ltr, mb, mb, generator=torch.Generator().manual_seed(3),
                                   dtype=dtype) * 0.1, 7)

    def step(x, cp, rp, lkk, cp1, d1):
        myr, myc = coll.my_rank()
        gi = _spmd.local_row_tiles(g, myr, x.device)
        gj = _spmd.local_col_tiles(g, myc, x.device)
        k1 = k + 1
        params = (k1 % g.pc, k1 % g.pr, k1 // g.pc, k1 // g.pr, k1 // g.pc)
        got = tu.fused_step(x, *coll.transpose_panel_parts(cp, g.mt, g.ltc), gj == k1, cp,
                            gi > k1, params)
        for o, t in zip((rp, lkk, cp1, d1), got[1:]):
            o.copy_(t)

    outs = {}
    for label, grid, gemm in (("cpu", cpu, tier), ("cuda", Grid.create((2, 4), device=dev), tier),
                              ("default", cpu, "default")):
        w = grid.device
        args = [mat.data.clone().to(w), cps.to(w)] + [
            torch.empty(s, dtype=dtype).to(w) for s in ((2, 4, g.ltc, mb, mb), (2, 4, mb, mb),
                                                       tuple(cps.shape), (2, 4, mb, mb))]
        before = (tu.step_launches, tu.fused_step_split_launches)
        with knobs(jax_too=False, collectives_impl="pallas", gemm_precision=gemm):
            coll.spmd(grid, step, *args)
        if w.type == "cuda":
            torch.cuda.synchronize()
            assert (tu.step_launches, tu.fused_step_split_launches) == (before[0] + 8,
                                                                        before[1] + 8)
        outs[label] = [t.cpu() for t in [args[0]] + args[2:]]
    got, want = outs["cuda"], outs["cpu"]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _rel_err((got[0] - mat.data).numpy(), (outs["default"][0] - mat.data).numpy()) > 1e-10
    tol = tol_for(np.float32 if dtype == torch.float32 else np.float64, mb)
    for gv, wv in zip(got[2:], want[2:]):
        err = torch.linalg.vector_norm((gv - wv).double()) / torch.linalg.vector_norm(wv.double())
        assert err <= tol


#: B6's split body at ragged shapes, (mb, K): segments of 32 rows and
#: ltr * M not a multiple of the body's tile rows (96); segments of 16 rows
#: and a last 32-deep slice half zero-filled (80); red2band's band-deep row
#: panel (K = 128); deep updates whose segment runs in passes of fewer than
#: 16 columns (K = 1536 and 2048: passes of 8 in f64, and in f32 at bf16x6
#: at 2048; K = 4096: passes of 4 in f64 and in f32 at bf16x6, of 8 in f32
#: at bf16x3; K = 8192: passes of 2 in f64 and in f32 at bf16x6, of 4 in
#: f32 at bf16x3)
SPLIT_RAGGED = {"mb96": (96, 96), "mb80": (80, 80), "red2band_K128": (192, 128),
                "deep_K1536": (64, 1536), "deep_K2048": (64, 2048), "deep_K4096": (32, 4096),
                "deep_K8192": (16, 8192)}
SPLIT_TIERS = [(torch.float32, "bf16x3"), (torch.float32, "bf16x6"), (torch.float64, "bf16x6"),
               (torch.float64, "bf16x3")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tier", SPLIT_TIERS)
@pytest.mark.parametrize("shape", list(SPLIT_RAGGED))
def test_cuda_consume_split_is_b3_split_on_the_merged_panel(shape, dtype, tier):
    """B6's split body on a 2x4 grid (the ring over 'c': 3 hops, landing
    slots reused): x bit for bit B3-split at the tier applied once on every
    rank to the merged panel masked to the applied slots (held on the ring
    and not suppressed), every other slot zero; the check rejects B3-split
    with the last k16 slice of one applied slot dropped.  Every launch runs
    the split instantiation."""
    dev = _cuda()
    mb, K = SPLIT_RAGGED[shape]
    pr, pc, ltr, slots = 2, 4, 3, 6
    gen = torch.Generator().manual_seed(37)
    x = torch.randn(pr, pc, ltr, slots, mb, mb, generator=gen, dtype=dtype)
    cp = torch.randn(pr, pc, ltr, mb, K, generator=gen, dtype=dtype)
    y = torch.randn(pr, pc, slots, mb, K, generator=gen, dtype=dtype)
    h = torch.zeros(pr, pc, slots, 1, dtype=torch.int32)
    z = torch.zeros(pr, pc, slots, 1, dtype=torch.int32)
    for s in range(slots - 1):
        h[:, s % pc, s] = 1
    z[:, :, 1] = 1
    with knobs(jax_too=False, gemm_precision=tier):
        before = tu.consume_split_launches
        got = _consume_on_ranks(Grid.create((pr, pc), device=dev),
                                *(t.to(dev) for t in (x, cp, y, h, z)), axis="c",
                                consume=tu.dma_ring_consume)
        torch.cuda.synchronize()
    assert tu.consume_split_launches == before + pr * pc
    applied = (got[2][..., 0] != 0) & (z[..., 0].to(dev) == 0)
    _assert_b3_bitwise(got[0], x, cp, got[1], applied, tier)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tier", SPLIT_TIERS)
@pytest.mark.parametrize("mb", [128, 384])
def test_cuda_fused_step_split_is_b3_split_on_the_merged_panel(mb, dtype, tier):
    """B8 with its consume phase split, on a 2x4 grid (mb a multiple of
    128, as its gate asks; at 384 the f64 tiers run the segment in passes
    of fewer columns): x bit for bit B3-split at the tier applied once on
    every rank to the merged panel masked to the slots B8 applies (held on
    the ring over 'r' and not suppressed, and the narrow slot on column
    k+1's ranks); the check rejects B3-split with the last k16 slice of one
    applied slot dropped."""
    dev = _cuda()
    n, k = 8 * mb, 3
    a = torch.from_numpy(np.tril(random_hermitian_pd(n, np.float64, 41))).to(dtype)
    cpu, gpu = Grid.create((2, 4), device="cpu"), Grid.create((2, 4), device=dev)
    mat = dtt.DistributedMatrix.from_global(cpu, a, (mb, mb))
    g = _spmd.Geometry.of(mat.dist)
    cps = torch.empty(2, 4, g.ltr, mb, mb, dtype=dtype)
    haves = torch.empty(2, 4, g.ltc, dtype=torch.bool)
    supps = torch.empty_like(haves)

    def panel(x, cpo, hv, sp):
        myr, myc = coll.my_rank()
        gi = _spmd.local_row_tiles(g, myr, x.device)
        gj = _spmd.local_col_tiles(g, myc, x.device)
        d = _spmd.bcast_diag_tile(x, k, g, myr, myc)
        cpo.copy_(px.fused_factor_bcast(d, x[:, k // g.pc].contiguous(), gi > k, k % g.pc)[1])
        hv.copy_(coll.transpose_panel_parts(cpo, g.mt, g.ltc)[1])
        sp.copy_(gj == k + 1)

    def step(x, cp, rp):
        myr, myc = coll.my_rank()
        gi = _spmd.local_row_tiles(g, myr, x.device)
        gj = _spmd.local_col_tiles(g, myc, x.device)
        k1 = k + 1
        params = (k1 % g.pc, k1 % g.pr, k1 // g.pc, k1 // g.pr, k1 // g.pc)
        got = tu.fused_step(x, *coll.transpose_panel_parts(cp, g.mt, g.ltc), gj == k1, cp,
                            gi > k1, params)
        rp.copy_(got[1])

    with knobs(jax_too=False, collectives_impl="pallas"):
        coll.spmd(cpu, panel, mat.data, cps, haves, supps)
        xg, cpg = mat.data.clone().to(dev), cps.to(dev)
        rpg = torch.empty(2, 4, g.ltc, mb, mb, dtype=dtype, device=dev)
        with tune.gemm_precision_scope(tier):
            before = tu.fused_step_split_launches
            coll.spmd(gpu, step, xg, cpg, rpg)
            torch.cuda.synchronize()
    assert tu.fused_step_split_launches == before + 8
    narrow = torch.zeros_like(supps)
    narrow[:, (k + 1) % g.pc, (k + 1) // g.pc] = True
    held = haves.any(dim=0, keepdim=True).expand_as(haves)
    _assert_b3_bitwise(xg, mat.data, cps, rpg, held & (~supps | narrow), tier)


@pytest.mark.cuda
@pytest.mark.parametrize("mb,kernel", [(128, "fused_step"), (96, "dma_ring_consume")])
def test_cuda_cholesky_fused_split_matches_xla(mb, kernel):
    """Lookahead Cholesky on a 2x4 grid of the card under bf16x3: 'fused'
    launches B8 (mb % 128 == 0) or B6 once per step and rank, every launch
    its split body, and its factor is within tol_for(f32, n) of the 'xla'
    tier's (whose products split in ``tile.contract``)."""
    dev = _cuda()
    n = 20 * mb
    a = torch.from_numpy(np.tril(random_hermitian_pd(n, np.float32, 19))).to(dev)
    out = {}
    for impl in ("xla", "fused"):
        with knobs(jax_too=False, collectives_impl="pallas", cholesky_lookahead=True,
                   trailing_update_impl=impl, panel_trsm_pallas=True, gemm_precision="bf16x3"):
            grid = Grid.create((2, 4), device=dev)
            ops.reset_launch_counts()
            fac, info = dtt.cholesky_factorization(
                "L", dtt.DistributedMatrix.from_global(grid, a.clone(), (mb, mb)), return_info=True)
            out[impl] = (np.tril(fac.to_global()), int(info), ops.launch_counts(), ops.sub_counts())
    assert out["fused"][1] == out["xla"][1] == 0
    assert _rel_err(out["fused"][0], out["xla"][0]) <= tol_for(np.float32, n)
    assert out["fused"][2][kernel] == out["fused"][3][f"{kernel}_split"] == 8 * (n // mb - 1)
    assert out["xla"][2][kernel] == 0
