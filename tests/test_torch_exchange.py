"""The ring kernels of the 'pallas' tier (``dlaf_tpu_torch/ops/panel_exchange.py``):
B4 (hop merge), B5 (ring exchange) and B7 (fused factor-and-send).

On the CPU: B4's plain version against the JAX package's merge kernel in
Pallas interpret mode (bitwise: a pure select), the wire layout, the
collective-class table, B5's protocol twin on a 2x4 grid of rank threads
(bitwise against the v2 tier, with a rank that sleeps at every ring entry),
and B7's twin against the JAX package's unfused composition (its potrf and
panel-TRSM kernels in interpret mode, the mask, the broadcast), within
``tol_for(dtype, nb)``.

On a card only (``-m cuda``, skipped here): each kernel against its twin
on the same inputs, bitwise, B5 with a skewed rank too, a ring whose
partner launches past the kernels' bound raising ``DeadlineExceededError``,
and a whole factorization under the 'pallas' tier against 'v2', bitwise.

The JAX side is imported inside the tests that use it, so that on a
machine with a card and no JAX the CUDA tests still run:
``python -m pytest tests/test_torch_exchange.py --noconftest -m cuda``.
"""
import time

import numpy as np
import pytest
import torch

from dlaf_tpu_torch import tune
from dlaf_tpu_torch.comm import _ranks
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.comm.grid import Grid
from dlaf_tpu_torch.health import DeadlineExceededError
from dlaf_tpu_torch.ops import panel_exchange as px
from dlaf_tpu_torch.ops import panel_trsm, potrf
from dlaf_tpu_torch.testing import random_hermitian_pd, random_matrix, tol_for


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


def _wire_case(slots, w, dtype, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((slots, w)).astype(dtype)
    y_in = rng.standard_normal((slots, w)).astype(dtype)
    h = rng.integers(0, 2, (slots, 1)).astype(np.int32)
    h_in = rng.integers(0, 3, (slots, 1)).astype(np.int32)  # any non-zero counts as held
    return y, y_in, h, h_in


class _Knobs:
    def __init__(self, **kw):
        self.kw = kw

    def __enter__(self):
        tp = tune.get_tune_parameters()
        self.old = {k: getattr(tp, k) for k in self.kw}
        tp.update(**self.kw)

    def __exit__(self, *exc):
        tune.get_tune_parameters().update(**self.old)


# ------------------------------------------------------------------ CPU: B4


#: B4's wire cases beyond the first (slots, w, have masks): an odd w (B4's
#: select gives its slots a head or a tail of single words), and the
#: masks' extremes
MERGE_CASES = [(5, 7, "mixed"), (4, 9, "all held"), (4, 9, "none held"), (4, 9, "all incoming")]


def _merge_params():
    dts = (np.float32, np.float64)
    return ([pytest.param(d, None, id=d.__name__) for d in dts]
            + [pytest.param(d, c, id=f"{d.__name__}-{c[0]}x{c[1]}-{c[2].replace(' ', '-')}")
               for c in MERGE_CASES for d in dts])


def _merge_case(case, dtype, seed):
    """``_wire_case`` of ``case`` (slots, w, masks), the masks set: "all
    held" (h = 1), "none held" (h = h_in = 0), "all incoming" (h = 0, h_in
    = 2), or "mixed" (random)."""
    slots, w, masks = case
    y, y_in, h, h_in = _wire_case(slots, w, dtype, seed)
    if masks == "all held":
        h[:] = 1
    elif masks == "none held":
        h[:], h_in[:] = 0, 0
    elif masks == "all incoming":
        h[:], h_in[:] = 0, 2
    return y, y_in, h, h_in


@pytest.mark.parametrize("dtype,case", _merge_params())
def test_merge_plain_matches_pallas_bitwise(dtype, case):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from dlaf_tpu.ops import pallas_panel_exchange as ppe

    y, y_in, h, h_in = _merge_case(case or (6, 10, "mixed"), dtype, seed=1)
    ry, rh = ppe.merge_hop(jnp.asarray(y), jnp.asarray(y_in), jnp.asarray(h), jnp.asarray(h_in),
                           True)
    gy, gh = px.merge_hop(*map(torch.from_numpy, (y, y_in, h, h_in)))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(rh))


@pytest.mark.parametrize("have_shape", [(), (3,), (3, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64, torch.float64])
def test_wire_layout_round_trip(dtype, have_shape):
    g = torch.Generator().manual_seed(2)
    y = torch.randn(3, 2, 4, 5, generator=g, dtype=dtype)
    have = torch.rand(have_shape, generator=g) > 0.5 if have_shape else True
    yf, h = px._to_wire(y, have)
    assert not yf.is_complex() and yf.dim() == 2 and h.dtype == torch.int32
    assert h.shape == (yf.shape[0], 1)
    back, hb = px._from_wire(yf, h, y, have)
    assert back.dtype == y.dtype and torch.equal(back, y)
    assert torch.equal(hb, torch.as_tensor(have))


def test_collective_ids_distinct_and_stable():
    classes = [(k, a) for k in ("bcast", "exchange") for a in ("r", "c")]
    ids = [px.collective_id_for(k, a) for k, a in classes] + [px.FUSED_COLLECTIVE_ID]
    assert len(set(ids)) == len(ids)
    assert px.collective_id_for("other", "c") == px.collective_id_for("other", "c") >= 8


def test_cpu_wrappers_count_nothing():
    before = (px.merge_launches, px.ring_launches, px.fused_launches)
    px.merge_hop(*map(torch.from_numpy, _wire_case(2, 4, np.float32, 3)))
    grid = Grid.create((1, 2), device="cpu")
    x = torch.arange(16.0).reshape(1, 2, 8)
    with _Knobs(collectives_impl="pallas"):
        coll.spmd(grid, lambda v: coll.bcast(v, 1, "c"), x)
    assert (px.merge_launches, px.ring_launches, px.fused_launches) == before


# ------------------------------------------------------------- CPU: B5 twin


def _ring_case(pr, pc, slots, w, seed):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.standard_normal((pr, pc, slots, w)).astype(np.float32))
    # one contributor per slot on each ring along 'c': position slot % pc
    have = torch.zeros(pr, pc, slots, dtype=torch.bool)
    for s in range(slots - 1):  # the last slot has no contributor
        have[:, s % pc, s] = True
    return y, have


def _exchange_all(grid, y, have, axis):
    out = torch.empty_like(y)
    got_h = torch.zeros_like(have)

    def body(yl, hl, ol, ohl):
        yy, hh = px.ring_exchange(yl, hl, axis)
        ol.copy_(yy)
        ohl.copy_(hh)

    coll.spmd(grid, body, y, have, out, got_h)
    return out, got_h


@pytest.mark.parametrize("skew", [False, True])
def test_ring_twin_matches_v2_bitwise(skew, monkeypatch):
    """B5's twin on each ring of 'c' of a 2x4 grid against the v2 forward
    chain; with ``skew`` rank (0, 2) sleeps 20 ms before every ring entry
    (a delayed rank stalls its neighbours, never a cycle)."""
    grid = Grid.create((2, 4), device="cpu")
    y, have = _ring_case(2, 4, 7, 6, seed=4)
    if skew:
        monkeypatch.setitem(px.launch_delay_s, (0, 2), 0.02)
    out, got_h = _exchange_all(grid, y, have, "c")
    ref, ref_h = torch.empty_like(y), torch.zeros_like(have)

    def v2(yl, hl, ol, ohl):
        yy, hh = coll._forward_chain(yl, hl, "c")
        ol.copy_(yy)
        ohl.copy_(hh)

    coll.spmd(grid, v2, y, have, ref, ref_h)
    assert torch.equal(out, ref) and torch.equal(got_h, ref_h)
    for s in range(6):  # every contributed slot holds its contributor's bytes
        assert torch.equal(out[:, :, s], y[:, s % 4, s][:, None].expand(2, 4, 6))
    assert not got_h[:, :, 6].any()


def test_ring_twin_reuses_its_state_across_calls():
    """Epoch counters, not resets: many calls on one ring state keep giving
    the right bits (slots are double-buffered and the flags only grow)."""
    grid = Grid.create((1, 4), device="cpu")
    for i in range(5):
        y, have = _ring_case(1, 4, 5, 3, seed=10 + i)
        out, _ = _exchange_all(grid, y, have, "c")
        for s in range(4):
            assert torch.equal(out[0, :, s], y[0, s % 4, s][None].expand(4, 3))
    states = [k for k in grid.runtime.rings if k[0] == px.collective_id_for("exchange", "c")]
    assert len(states) == 1


def test_ring_twin_wait_is_bounded(monkeypatch):
    """A ring whose partner never comes raises DeadlineExceededError within
    the runtime's bound instead of hanging."""
    grid = Grid.create((1, 2), device="cpu")
    monkeypatch.setattr(_ranks, "WAIT_S", 0.5)

    def body(yl):
        if coll.my_rank()[1] == 1:
            return None
        return px.ring_bcast(yl, True, "c")

    with pytest.raises(DeadlineExceededError):
        coll.spmd(grid, body, torch.zeros(1, 2, 4))


FIXTURE_SHAPES = [(2, 4), (4, 2), (2, 2), (1, 2), (2, 1), (1, 1)]


def _nearest_upstream(y, have, axis):
    """What every rank must end with, from numpy-free loops: per slot its own
    bytes where it has the slot, else those of the nearest upstream rank of
    its ring that has it, else its own; have is the OR over the ring."""
    pr, pc = have.shape[:2]
    out, out_h = y.clone(), have.clone()
    for r in range(pr):
        for c in range(pc):
            pos, n = (c, pc) if axis == "c" else (r, pr)
            at = (lambda p: (r, p)) if axis == "c" else (lambda p: (p, c))
            for s in range(have.shape[2]):
                for q in range(n):
                    src = at((pos - q) % n)
                    if have[src][s]:
                        out[r, c, s] = y[src][s]
                        break
                out_h[r, c, s] = any(have[at(p)][s] for p in range(n))
    return out, out_h


def _v2_all(grid, y, have, axis):
    ref, ref_h = torch.empty_like(y), torch.zeros_like(have)

    def v2(yl, hl, ol, ohl):
        yy, hh = coll._forward_chain(yl, hl, axis)
        ol.copy_(yy)
        ohl.copy_(hh)

    coll.spmd(grid, v2, y, have, ref, ref_h)
    return ref, ref_h


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("axis", ["c", "r"])
@pytest.mark.parametrize("shape", FIXTURE_SHAPES)
def test_pull_twin_matches_v2_bitwise_on_fixture_shapes(shape, axis, skew, monkeypatch):
    """B5's twin (the pull protocol with CPU state) against the v2 doubling
    chain on each fixture grid shape and axis, one contributor per slot and
    a slot with none; with ``skew`` the last rank sleeps 20 ms before every
    ring entry, so the others wait for it at the entry barrier."""
    pr, pc = shape
    n = pc if axis == "c" else pr
    rng = np.random.default_rng(40 + pr * 8 + pc)
    y = torch.from_numpy(rng.standard_normal((pr, pc, 5, 3)).astype(np.float32))
    have = torch.zeros(pr, pc, 5, dtype=torch.bool)
    for s in range(4):  # the last slot has no contributor
        if axis == "c":
            have[:, s % n, s] = True
        else:
            have[s % n, :, s] = True
    if skew:
        monkeypatch.setitem(px.launch_delay_s, (pr - 1, pc - 1), 0.02)
    grid = Grid.create(shape, device="cpu")
    out, got_h = _exchange_all(grid, y, have, axis)
    ref, ref_h = _v2_all(grid, y, have, axis)
    assert torch.equal(out, ref) and torch.equal(got_h, ref_h)
    want, want_h = _nearest_upstream(y, have, axis)
    assert torch.equal(out, want) and torch.equal(got_h, want_h)


@pytest.mark.parametrize("axis", ["c", "r"])
def test_pull_twin_takes_the_nearest_upstream_contributor(axis):
    """Several contributors per slot, and slots with none: every rank ends
    with its own bytes where it has the slot, else the nearest upstream
    contributor's (the select of every hop of the ring), bitwise the v2
    chain's; have is the OR over the ring."""
    shape = (2, 4) if axis == "c" else (4, 2)
    rng = np.random.default_rng(44)
    y = torch.from_numpy(rng.standard_normal((*shape, 12, 4)).astype(np.float32))
    have = torch.from_numpy(rng.random((*shape, 12)) < 0.4)
    have[..., 0] = False  # a slot that nobody has
    have[..., 1] = True   # a slot that everybody has
    grid = Grid.create(shape, device="cpu")
    out, got_h = _exchange_all(grid, y, have, axis)
    want, want_h = _nearest_upstream(y, have, axis)
    assert torch.equal(out, want) and torch.equal(got_h, want_h)
    ref, ref_h = _v2_all(grid, y, have, axis)
    assert torch.equal(out, ref) and torch.equal(got_h, ref_h)
    assert torch.equal(out[..., 0, :], y[..., 0, :]) and torch.equal(out[..., 1, :], y[..., 1, :])


def test_pull_twin_exit_barrier_is_bounded(monkeypatch):
    """A rank that stalls between its entry and its done flag holds its
    readers at the exit barrier for at most the runtime's bound, which
    raises DeadlineExceededError naming that barrier."""
    grid = Grid.create((1, 2), device="cpu")
    monkeypatch.setattr(_ranks, "WAIT_S", 0.3)
    merge = px.merge_hop

    def slow_merge(*args):
        if coll.my_rank()[1] == 1:
            time.sleep(1.0)
        return merge(*args)

    monkeypatch.setattr(px, "merge_hop", slow_merge)
    with pytest.raises(DeadlineExceededError, match="exit barrier"):
        coll.spmd(grid, lambda yl: px.ring_bcast(yl, coll.my_rank()[1] == 0, "c"),
                  torch.zeros(1, 2, 4))


def test_pull_twin_state_is_reused_and_holds_no_inputs():
    """One pull state per ring and payload, reused call after call: its
    epochs count the calls, and no rank's input stays posted once a call is
    over."""
    grid = Grid.create((2, 2), device="cpu")
    for i in range(3):
        y, have = _ring_case(2, 2, 3, 4, seed=50 + i)
        _exchange_all(grid, y, have, "c")
    states = [st for k, st in grid.runtime.rings.items()
              if k[0] == px.collective_id_for("exchange", "c") and k[-1] == "host-pull"]
    assert len(states) == 2  # one per ring of 'c'
    for st in states:
        assert st.epoch == [3, 3] and st.posted == [None, None]
        assert st.entry == [(3 << 16) | 1] * 2 and st.done == [(3 << 16) | 2] * 2


# ------------------------------------------------------------- CPU: B7 twin


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_twin_matches_jax_composition(dtype):
    """B7's twin on every rank of a 2x4 grid against the JAX package's
    unfused composition (its potrf and panel-TRSM kernels in interpret
    mode, the mask); every rank of each column ring ends with the root's
    masked panel."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from dlaf_tpu.ops import pallas_potrf
    from dlaf_tpu.ops.pallas_panel_trsm import panel_trsm_right_lower_t

    nb, ltr, root = 32, 3, 2
    d = random_hermitian_pd(nb, dtype, seed=5)
    d_low = np.tril(d) + np.triu(random_matrix(nb, nb, dtype, seed=6), 1)  # upper not read
    xc = random_matrix(2 * 4 * ltr * nb, nb, dtype, seed=7).reshape(2, 4, ltr, nb, nb)
    below = np.array([False, True, True])
    herm = jnp.tril(d_low) + jnp.tril(d_low, -1).T
    lkk_ref = pl.pallas_call(pallas_potrf._potrf_kernel,
                             out_shape=jax.ShapeDtypeStruct(herm.shape, herm.dtype),
                             interpret=True)(herm)
    grid = Grid.create((2, 4), device="cpu")
    dt = torch.from_numpy(np.broadcast_to(d_low, (2, 4, nb, nb)).copy())
    lkk = torch.empty_like(dt)
    cp = torch.empty(2, 4, ltr, nb, nb, dtype=dt.dtype)

    def body(dl, xl, lo, co):
        a, b = px.fused_factor_bcast(dl, xl, torch.from_numpy(below), root, "c")
        lo.copy_(a)
        co.copy_(b)

    coll.spmd(grid, body, dt, torch.from_numpy(xc), lkk, cp)
    tol = tol_for(dtype, nb)
    for r in range(2):
        pan = panel_trsm_right_lower_t(lkk_ref, jnp.asarray(xc[r, root].reshape(-1, nb)), False,
                                       True)
        want = np.where(below[:, None, None], np.asarray(pan).reshape(ltr, nb, nb), 0)
        for c in range(4):
            assert _rel_err(lkk[r, c].numpy(), np.asarray(lkk_ref)) <= tol
            assert _rel_err(cp[r, c].numpy(), want) <= tol
            assert torch.equal(cp[r, c], cp[r, root])
        assert not cp[r, :, 0].any()


def test_fusion_gate():
    f32 = torch.zeros(32, 32)
    assert px.fusion_supported(f32, torch.zeros(3, 32, 32))
    assert px.fusion_supported(torch.zeros(8, 8), torch.zeros(2, 8, 8))  # the CPU twin: % 8
    assert not px.fusion_supported(torch.zeros(12, 12), torch.zeros(2, 12, 12))
    assert not px.fusion_supported(f32.to(torch.complex64), torch.zeros(3, 32, 32,
                                                                        dtype=torch.complex64))
    assert not px.fusion_supported(f32, torch.zeros(3, 32, 16))


@pytest.mark.parametrize("sms,ranks,nb,itemsize,want", [
    (132, 8, 512, 4, (16, 16)),   # path M on the H100: 16 blocks a rank, all factor
    (132, 2, 512, 4, (66, 16)),   # a 1x2 grid: the factor's team stays at 16
    (132, 8, 192, 8, (16, 16)),   # S7's f64 at nb = 192: the cluster body fits
    (132, 8, 512, 8, (16, 0)),    # S7's f64 at nb = 512: B1's gate takes one block
    (132, 16, 560, 4, (8, 8)),    # B1's cluster of 8, exactly
    (132, 8, 1024, 4, (16, 0)),   # f32 past n = 560: one block
])
def test_fused_geometry(sms, ranks, nb, itemsize, want):
    """B7's launch and factor team from the card's SMs and the grid's ranks
    (B1's gate decides between the cluster body and the one-block body)."""
    assert px.fused_geometry(sms, ranks, nb, itemsize) == want
    assert (want[1] > 0) == potrf.cluster_fits(
        torch.zeros(nb, nb, dtype=torch.float32 if itemsize == 4 else torch.float64))


def test_fused_geometry_refuses_too_few_blocks():
    """17 ranks on 132 SMs leave 7 blocks a rank: fewer than B1's cluster of
    8 for a tile the cluster body takes, so the launch raises; a tile the
    one-block body takes still launches."""
    with pytest.raises(ValueError, match="fewer than B1's cluster"):
        px.fused_geometry(132, 17, 512, 4)
    assert px.fused_geometry(132, 17, 512, 8) == (7, 0)


@pytest.mark.parametrize("itemsize,rows", [(4, 32), (8, 16)])
def test_chunk_rows(itemsize, rows):
    """A chunk is 16 warps of B2's rows, 2 a warp in f32 and 1 in f64."""
    assert px.chunk_rows(itemsize) == rows


def test_fused_gate_on_the_card_stops_at_512():
    """B7 and B8 take tiles up to 512 on the card (their solve's sums fill
    the registers past that); wider ones take the unfused path.  The CPU
    twins take them all."""
    meta = torch.device("meta")
    assert px.fusion_supported(torch.zeros(512, 512, device=meta),
                               torch.zeros(2, 512, 512, device=meta))
    assert not px.fusion_supported(torch.zeros(640, 640, device=meta),
                                   torch.zeros(2, 640, 640, device=meta))
    assert px.fusion_supported(torch.zeros(640, 640), torch.zeros(2, 640, 640))


@pytest.mark.parametrize("below,nb,p,rows", [
    ([0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], 512, 4, 32),  # path M, ring of 4
    ([0] + [1] * 42, 192, 4, 32),                                     # M5
    ([0, 0, 0] + [1] * 8, 192, 4, 16),                                # S7's f64
    ([1] * 5, 192, 4, 32),                                            # every tile
    ([0] * 5, 192, 4, 32),                                            # no tile
    ([0, 1, 0, 1], 96, 3, 64),                                        # a ragged last run
    ([1, 1], 192, 1, 16),                                             # a ring of one
    ([1], 32, 8, 32),                                                 # fewer chunks than ranks
])
def test_solve_shares(below, nb, p, rows):
    """The shared panel solve's chunks and shares: every row of every tile
    below the diagonal is in exactly one chunk, every chunk in exactly one
    share, the shares in ring order and within one chunk of each other; a
    tile not below the diagonal has no chunk; the chunk flags fit the ring
    state's (a flag per 16 rows)."""
    chunks, shares = px.solve_shares(below, nb, p, rows)
    covered = {(i, r) for i, r0 in chunks for r in range(r0, min(r0 + rows, nb))}
    assert covered == {(i, r) for i, b in enumerate(below) if b for r in range(nb)}
    assert len(covered) == sum(min(rows, nb - r0) for _, r0 in chunks)
    assert [lo for lo, _ in shares] == [0] + [hi for _, hi in shares[:-1]]
    assert shares[-1][1] == len(chunks)
    sizes = [hi - lo for lo, hi in shares]
    assert max(sizes) - min(sizes) <= 1
    assert len(chunks) <= len(below) * -(-nb // 16)
    assert px.fused_flag_words(p, 16, len(below), nb) == 1 + 2 * p * 16 + len(below) * -(-nb // 16)


# ------------------------------------------------------ card only: B4, B5, B7


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_merge_matches_twin_bitwise(dtype):
    dev = _cuda()
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    case = [torch.from_numpy(a) for a in _wire_case(37, 129, np_dtype, seed=8)]
    ref = px.merge_hop_plain(*case)
    before = px.merge_launches
    got = px.merge_hop(*[t.to(dev) for t in case])
    torch.cuda.synchronize()
    assert px.merge_launches == before + 1
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", [(37, 129, "mixed"), (7, 1023, "mixed"), (9, 3, "mixed"),
                                  (16, 4096, "mixed"), (6, 256, "all held"),
                                  (6, 256, "none held"), (6, 256, "all incoming")])
def test_cuda_merge_matches_reference_bitwise(case, dtype, off):
    """B4's select (``merge_select_kernel``) gives its plain version's bits
    (the reference: a pure select has no other): 16-byte vectors with a
    head and a tail of words on a ragged w, element accesses at an offset
    of one element."""
    dev = _cuda()
    y, y_in, h, h_in = (torch.from_numpy(a) for a in _merge_case(case, dtype, seed=9))
    ref = px.merge_hop_plain(y, y_in, h, h_in)
    yo = []
    for t in (y, y_in):
        buf = torch.empty(t.numel() + off, dtype=t.dtype, device=dev)
        yo.append(buf[off:].view(t.shape))
        yo[-1].copy_(t)
    args = (*yo, h.to(dev), h_in.to(dev))
    before = px.merge_launches
    got = px.merge_hop(*args)
    torch.cuda.synchronize()
    assert px.merge_launches == before + 1
    words = torch.int32 if dtype == np.float32 else torch.int64
    assert torch.equal(got[0].cpu().view(words), ref[0].view(words))
    assert torch.equal(got[1].cpu(), ref[1])


def _on(grid_dev, tensors, fn):
    out = [torch.empty_like(t) for t in tensors]

    def body(*views):
        k = len(tensors)
        res = fn(*views[:k])
        for o, r in zip(views[k:], res):
            o.copy_(r)

    coll.spmd(grid_dev, body, *tensors, *out)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("axis", ["c", "r"])
def test_cuda_ring_matches_twin_bitwise(axis, skew, monkeypatch):
    dev = _cuda()
    pr, pc, slots, w = 2, 4, 9, 1000
    gen = torch.Generator().manual_seed(9)
    y = torch.randn(pr, pc, slots, w, generator=gen)
    pos = torch.arange(pc if axis == "c" else pr)
    have = torch.zeros(pr, pc, slots, dtype=torch.bool)
    for s in range(slots - 1):
        p = s % len(pos)
        if axis == "c":
            have[:, p, s] = True
        else:
            have[p, :, s] = True
    x = torch.randn(pr, pc, 3, 700, generator=gen, dtype=torch.float64)
    root = 1

    def fn(yl, hl, xl):
        yy, hh = px.ring_exchange(yl, hl, axis)
        return yy, hh, px.ring_bcast(xl, coll._ranks.current().axis(axis)[0] == root, axis)

    ref = _on(Grid.create((pr, pc), device="cpu"), [y, have, x], fn)
    if skew:
        monkeypatch.setitem(px.launch_delay_s, (0, 1), 0.05)
    before = px.ring_launches
    got = _on(Grid.create((pr, pc), device=dev), [y.to(dev), have.to(dev), x.to(dev)], fn)
    torch.cuda.synchronize()
    assert px.ring_launches == before + 2 * pr * pc
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("axis", ["c", "r"])
def test_cuda_pull_matches_hop_ring_and_twin_bitwise(axis, skew, monkeypatch):
    """B5's pull on a 2x4 grid against the hop ring it replaced (on the card)
    and its twin (on a CPU grid), bit for bit, with several contributors per
    slot, slots with none and slots of every rank; a payload that is not a
    whole number of 16-byte pieces per slot takes the word copy."""
    dev = _cuda()
    pr, pc = 2, 4
    gen = torch.Generator().manual_seed(13)
    y = torch.randn(pr, pc, 11, 2048, generator=gen)
    have = torch.rand(pr, pc, 11, generator=gen) < 0.4
    have[..., 0], have[..., 1] = False, True
    odd = torch.randn(pr, pc, 5, 33, generator=gen, dtype=torch.float64).to(torch.complex64)
    odd_have = torch.rand(pr, pc, 5, generator=gen) < 0.5

    def pull(yl, hl, ol, ohl):
        yy, hh = px.ring_exchange(yl, hl, axis)
        oo, oh = px.ring_exchange(ol, ohl, axis)
        return yy, hh, oo, oh

    def hops(yl, hl, ol, ohl):
        yy, hh = px.ring_exchange_hops(yl, hl, axis)
        oo, oh = px.ring_exchange_hops(ol, ohl, axis)
        return yy, hh, oo, oh

    args = [y, have, odd, odd_have]
    ref = _on(Grid.create((pr, pc), device="cpu"), args, pull)
    if skew:
        monkeypatch.setitem(px.launch_delay_s, (0, 1), 0.05)
    grid = Grid.create((pr, pc), device=dev)
    before = (px.ring_launches, px.hop_launches)
    got = _on(grid, [a.to(dev) for a in args], pull)
    old = _on(grid, [a.to(dev) for a in args], hops)
    torch.cuda.synchronize()
    assert (px.ring_launches, px.hop_launches) == (before[0] + 2 * pr * pc,
                                                   before[1] + 2 * pr * pc)
    for g, o, r in zip(got, old, ref):
        assert torch.equal(g.cpu(), r) and torch.equal(o.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("late", ["source", "reader"])
def test_cuda_pull_input_lifetime(late):
    """The pull reads a peer's input only once that peer's kernel has
    started (its stream fills a fresh input with NaN, sleeps 100 ms on the
    card, then writes it), and the source's stream overwrites its input
    right after the launch without harm (its kernel ends only after every
    reader's done flag; with a late source the overwrite is queued before
    the kernel starts, so it runs the moment the kernel ends); with
    ``late='reader'`` a reader's stream sleeps instead."""
    dev = _cuda()
    pr, pc, root = 2, 4, 2
    gen = torch.Generator().manual_seed(14)
    x = torch.randn(pr, pc, 4, 256, 256, generator=gen)
    ref = _on(Grid.create((pr, pc), device="cpu"), [x],
              lambda xl: (px.ring_bcast(xl, coll.my_rank()[1] == root, "c"),))[0]

    held = []  # the inputs outlive the run: freed, the next allocation could reuse them

    def body(xl):
        myc = coll.my_rank()[1]
        mine = torch.full_like(xl, float("nan"))
        held.append(mine)
        if myc == (root if late == "source" else (root + 1) % pc):
            torch.cuda._sleep(int(100e-3 * 2e9))  # cycles; the H100's clock is below 2 GHz
        mine.copy_(xl)  # on this rank's stream, after the sleep
        out = px.ring_bcast(mine, myc == root, "c")
        mine.fill_(float("nan"))  # right after the launch, on the same stream
        return (out,)

    got = _on(Grid.create((pr, pc), device=dev), [x.to(dev)], body)[0]
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_cuda_ring_deadline_raises(monkeypatch):
    """Ranks whose ring partner launches 1 s late time out in the kernel
    after 0.2 s; the error word makes spmd raise DeadlineExceededError, and
    the grid's rings work again afterwards."""
    dev = _cuda()
    monkeypatch.setattr(px, "RING_TIMEOUT_S", 0.2)
    monkeypatch.setitem(px.launch_delay_s, (0, 3), 1.0)
    grid = Grid.create((1, 4), device=dev)
    x = torch.ones(1, 4, 1000, device=dev)

    with pytest.raises(DeadlineExceededError, match="ring kernel"):
        coll.spmd(grid, lambda xl: px.ring_bcast(xl, coll.my_rank()[1] == 0, "c"), x)
    px.launch_delay_s.clear()
    out = _on(grid, [x], lambda xl: (px.ring_bcast(xl * coll.my_rank()[1], coll.my_rank()[1] == 2,
                                                   "c"),))[0]
    assert torch.all(out == 2)


#: B7's card cases (dtype, nb, ltr, below): the first body's small tile,
#: path M's (nb = 512, 16 tiles a rank, the first 4 above the diagonal),
#: M5's (nb = 192, 43 tiles), S7's f64 shapes (N = 4096 at nb = 192 and 512
#: on 2 x 4: 11 and 4 tiles a rank; nb = 512 takes the one-block factor),
#: and the mask's extremes (every tile, no tile below the diagonal)
FUSED_CASES = [
    (torch.float32, 64, 5, "2:"), (torch.float64, 64, 5, "2:"),
    (torch.float32, 512, 16, "4:"), (torch.float32, 192, 43, "1:"),
    (torch.float64, 192, 11, "3:"), (torch.float64, 512, 4, "1:"),
    (torch.float32, 192, 12, "all"), (torch.float32, 192, 12, "none"),
]


def _fused_inputs(dtype, nb, ltr, mask, seed):
    """d on every rank of a 2x4 grid, every rank's xc, and below."""
    d = torch.from_numpy(random_hermitian_pd(nb, np.float64, seed)).to(dtype)
    gen = torch.Generator().manual_seed(seed + 1)
    xc = torch.randn(2, 4, ltr, nb, nb, generator=gen, dtype=dtype)
    below = (torch.ones(ltr, dtype=torch.bool) if mask == "all"
             else torch.zeros(ltr, dtype=torch.bool) if mask == "none"
             else torch.arange(ltr) >= int(mask[:-1]))
    return d.expand(2, 4, nb, nb).contiguous(), xc, below


def _fused_fns(below, root, nb):
    def fused(dl, xl):
        return px.fused_factor_bcast(dl, xl, below.to(dl.device), root, "c")

    def unfused(dl, xl):
        lkk = potrf.potrf_tile(dl)
        pan = panel_trsm.panel_trsm_right_lower_t(lkk, xl.reshape(-1, nb)).reshape(xl.shape)
        cp = torch.where(below.to(dl.device)[:, None, None], pan, torch.zeros_like(pan))
        return lkk, px.ring_bcast(cp, coll.my_rank()[1] == root, "c")

    return fused, unfused


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nb,ltr,mask", FUSED_CASES,
                         ids=[f"{str(c[0])[6:]}-nb{c[1]}-ltr{c[2]}-{c[3].strip(':')}"
                              for c in FUSED_CASES])
def test_cuda_fused_matches_unfused(dtype, nb, ltr, mask):
    """B7 on a 2x4 grid against the unfused composition on the card (B1,
    B2 on the root column, the mask, B5 over 'c'), bitwise, as B7 runs B1's
    and B2's bodies; and against its plain twin on a CPU grid within
    tol_for(dtype, nb).  Every rank of a ring ends with the root's masked
    panel."""
    dev = _cuda()
    root = 3 if nb == 64 else 1
    dd, xc, below = _fused_inputs(dtype, nb, ltr, mask, 10 + nb)
    fused, unfused = _fused_fns(below, root, nb)
    grid = Grid.create((2, 4), device=dev)
    before = px.fused_launches
    got = _on(grid, [dd.to(dev), xc.to(dev)], fused)
    ref = _on(grid, [dd.to(dev), xc.to(dev)], unfused)
    torch.cuda.synchronize()
    assert px.fused_launches == before + 8
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for r in range(2):
        for c in range(4):
            assert torch.equal(got[1][r, c], got[1][r, root])
    if mask == "none":
        assert not got[1].any()
    plain = _on(Grid.create((2, 4), device="cpu"), [dd, xc], fused)
    for g, p in zip(got, plain):
        err = torch.linalg.vector_norm((g.cpu() - p).double()) / torch.linalg.vector_norm(
            p.double()).clamp_min(1e-300)
        assert err <= tol_for(np.float32 if dtype == torch.float32 else np.float64, nb)


@pytest.mark.cuda
@pytest.mark.parametrize("late", ["root", "non-root"])
def test_cuda_fused_skewed_launch(late, monkeypatch):
    """B7 at M5's shape with one rank of each ring launching 0.2 s after
    the others (the root, whose panel the others solve, then a rank that
    is not): the punctual ranks' factor, solve and pulls wait on the card
    for the late one, and the result is still bit for bit the unfused
    composition's."""
    dev = _cuda()
    nb, ltr, root = 192, 43, 1
    dd, xc, below = _fused_inputs(torch.float32, nb, ltr, "1:", 31)
    fused, unfused = _fused_fns(below, root, nb)
    grid = Grid.create((2, 4), device=dev)
    ref = _on(grid, [dd.to(dev), xc.to(dev)], unfused)
    late_c = root if late == "root" else (root + 2) % 4
    for r in range(2):
        monkeypatch.setitem(px.launch_delay_s, (r, late_c), 0.2)
    got = _on(grid, [dd.to(dev), xc.to(dev)], fused)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("lookahead", [False, True])
def test_cuda_cholesky_pallas_matches_v2_bitwise(lookahead):
    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import ops

    dev = _cuda()
    n, nb = 320, 32
    a = torch.from_numpy(np.tril(random_hermitian_pd(n, np.float32, 12))).to(dev)
    out = {}
    counts = {}
    for impl in ("v2", "pallas"):
        with _Knobs(collectives_impl=impl, cholesky_lookahead=lookahead,
                    trailing_update_impl="xla", panel_trsm_pallas=True):
            grid = Grid.create((2, 4), device=dev)
            mat = dtt.DistributedMatrix.from_global(grid, a.clone(), (nb, nb))
            ops.reset_launch_counts()
            fac, info = dtt.cholesky_factorization("L", mat, return_info=True)
            out[impl] = fac.data.clone()
            counts[impl] = ops.launch_counts()
            assert int(info) == 0
    assert torch.equal(out["v2"], out["pallas"])
    assert counts["v2"]["ring_exchange"] == counts["v2"]["fused_factor_bcast"] == 0
    assert counts["pallas"]["ring_exchange"] > 0
    assert (counts["pallas"]["fused_factor_bcast"] > 0) == lookahead
