"""The port's grid collectives (``dlaf_tpu_torch/comm/collectives.py``) against
the JAX package's, on every grid shape of the JAX test fixture
(``tests/conftest.py``: 2x4, 4x2, 2x2, 1x2, 2x1, 1x1), in each of the
port's three tiers.

The same numpy inputs go through ``dlaf_tpu.comm.collectives.spmd`` on the
8 virtual CPU devices (its default tier on the CPU, psum) and through the
port's ``spmd`` (rank threads).  Every one-contributor collective is pure
data movement, so the port is held to the JAX package bitwise, in every
tier, and so the three tiers agree bitwise with each other;
``psum_axis`` adds several contributions and is held within
``tol_for(dtype, P)`` (the two frameworks may add in other orders).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from dlaf_tpu import tune as jtune
from dlaf_tpu.comm import collectives as jcoll
from dlaf_tpu_torch import tune as ttune
from dlaf_tpu_torch.comm import collectives as tcoll
from dlaf_tpu_torch.testing import GRID_SHAPES, grid_like, tol_for

DTYPES = [np.float32, np.complex64]
TIERS = ["psum", "v2", "pallas"]
MT = 5  # ragged against both grid axes
MB = 2
#: names of the outputs of :func:`_collectives`, in order
NAMES = ["bcast_c_last", "bcast_r_0", "bcast_c_0", "bcast2d", "psum_c", "psum_r", "shift_c",
         "shift_r", "gather_c", "gather_r", "transpose_panel", "transpose_panel_rows",
         "windowed_rs0", "windowed_rs1", "rows_windowed_cs0", "rows_windowed_cs1"]


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_state():
    yield
    jax.clear_caches()


def _inputs(shape, dtype):
    pr, pc = shape
    ltr, ltc = -(-MT // pr), -(-MT // pc)
    rng = np.random.default_rng(abs(hash((shape, np.dtype(dtype).name))) % 2 ** 32)

    def rand(*s):
        x = rng.standard_normal(s)
        if np.issubdtype(dtype, np.complexfloating):
            x = x + 1j * rng.standard_normal(s)
        return x.astype(dtype)

    return rand(pr, pc, ltr, MB, MB), rand(pr, pc, ltc, MB, MB), rand(pr, pc, 3, 4)


def _collectives(c, arange, a, b, x):
    """Every collective of the module ``c`` (either package) on one rank's
    blocks: column panel ``a[ltr]``, row panel ``b[ltc]``, payload ``x``."""
    pr, pc = c.grid_shape()
    myr, myc = c.my_rank()
    ltr, ltc = a.shape[0], b.shape[0]
    jv = arange(ltc) * pc + myc
    iv = arange(ltr) * pr + myr
    l1, c1 = max(ltr - 1, 1), max(ltc - 1, 1)
    return (
        c.bcast(x, pc - 1, "c"), c.bcast(x, 0, "r"), c.bcast(x, 0, "c"),
        c.bcast2d(x, pr - 1, pc - 1),
        c.psum_axis(x, "c"), c.psum_axis(x, "r"),
        c.shift(x, "c", 1), c.shift(x, "r", 1),
        c.all_gather_axis(x, "c"), c.all_gather_axis(x, "r"),
        c.transpose_panel(a, MT, ltc), c.transpose_panel_rows(b, MT, ltr),
        c.transpose_panel_windowed(a, jv, 0, MT), c.transpose_panel_windowed(a[:l1], jv, 1, MT),
        c.transpose_panel_rows_windowed(b, iv, 0, MT),
        c.transpose_panel_rows_windowed(b[:c1], iv, 1, MT),
    )


@functools.lru_cache(maxsize=None)
def _jax_reference(shape, dtype):
    import jax.numpy as jnp

    grid = next(g for g in _jax_grids() if tuple(g.grid_size) == shape)
    ins = _inputs(shape, dtype)
    tp = jtune.get_tune_parameters()
    old = tp.collectives_impl
    tp.update(collectives_impl="psum")
    try:
        f = jcoll.spmd(grid, lambda *xs: tuple(
            jcoll.relocal(o) for o in _collectives(jcoll, jnp.arange, *map(jcoll.local, xs))))
        out = f(*[jax.device_put(v, grid.stacked_sharding()) for v in ins])
    finally:
        tp.update(collectives_impl=old)
    return [np.asarray(o) for o in out]


@functools.lru_cache(maxsize=None)
def _jax_grids():
    from dlaf_tpu.comm.grid import Grid
    from dlaf_tpu.common.index import Size2D

    devs = jax.devices()
    return tuple(Grid.create(Size2D(*s), devs) for s in GRID_SHAPES)


def _port(shape, dtype, tier):
    pr, pc = shape
    grid = grid_like(shape)
    ins = [torch.from_numpy(v) for v in _inputs(shape, dtype)]
    got = {}

    def body(a, b, x):
        outs = _collectives(tcoll, lambda n: torch.arange(n), a, b, x)
        got[tcoll.my_rank()] = [o.clone() for o in outs]

    tp = ttune.get_tune_parameters()
    old = tp.collectives_impl
    tp.update(collectives_impl=tier)
    try:
        tcoll.spmd(grid, body, *ins)
    finally:
        tp.update(collectives_impl=old)
    return [np.stack([np.stack([got[(r, c)][i].numpy() for c in range(pc)]) for r in range(pr)])
            for i in range(len(NAMES))]


_PORT_BY_TIER: dict = {}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_collectives_match_jax(shape, dtype, tier):
    ref = _jax_reference(shape, dtype)
    got = _port(shape, dtype, tier)
    _PORT_BY_TIER[(shape, np.dtype(dtype).name, tier)] = got
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape, name
        if name.startswith("psum"):
            assert np.max(np.abs(g - r)) <= tol_for(dtype, max(shape)) * max(np.max(np.abs(r)), 1), name
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)
    # within the port every tier gives the same bits, psum_axis included
    for other in TIERS:
        prev = _PORT_BY_TIER.get((shape, np.dtype(dtype).name, other))
        if prev is not None:
            for name, g, p in zip(NAMES, got, prev):
                np.testing.assert_array_equal(g, p, err_msg=f"{name}: {tier} vs {other}")


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_bcast_roots_and_contents(shape):
    """Correctness against the replicated expectation, not only agreement:
    after ``bcast`` every rank holds the root's bytes, in every tier."""
    pr, pc = shape
    grid = grid_like(shape)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((pr, pc, 5)))
    for tier in TIERS:
        ttune.get_tune_parameters().update(collectives_impl=tier)
        try:
            for axis, root in (("c", pc - 1), ("r", pr - 1), ("c", 1)):
                got = {}

                def body(v, axis=axis, root=root, got=got):
                    got[tcoll.my_rank()] = tcoll.bcast(v, root, axis).clone()

                tcoll.spmd(grid, body, x)
                for (r, c), v in got.items():
                    src = (r, root) if axis == "c" else (root, c)
                    assert torch.equal(v, x[src]), (tier, axis, root, r, c)
        finally:
            ttune.get_tune_parameters().update(collectives_impl="auto")


def test_psum_tier_turns_negative_zero_positive():
    """The one place the psum tier's bits differ from v2 and pallas: it adds
    the zero contributions of the other ranks, and -0.0 + 0.0 is +0.0 (the
    JAX package's psum does the same).  Inputs with -0.0 are the only
    exception to the tiers' bitwise agreement."""
    grid = grid_like((1, 2))
    x = torch.tensor([[[-0.0, 1.0], [-0.0, 2.0]]])
    signs = {}
    for tier in TIERS:
        ttune.get_tune_parameters().update(collectives_impl=tier)
        try:
            got = {}
            tcoll.spmd(grid, lambda v, got=got: got.setdefault(tcoll.my_rank(),
                                                                tcoll.bcast(v, 0, "c").clone()), x)
            signs[tier] = torch.signbit(got[(0, 1)][0]).item()
        finally:
            ttune.get_tune_parameters().update(collectives_impl="auto")
    assert signs == {"psum": False, "v2": True, "pallas": True}


def test_tier_knob_resolution():
    tp = ttune.get_tune_parameters()
    old = tp.collectives_impl
    try:
        tp.update(collectives_impl="auto")
        assert ttune.collectives_tier("cpu") == "psum"
        assert ttune.collectives_tier("cuda") == "v2"  # never pallas
        assert tcoll.collectives_trace_key() == "psum"
        tp.update(collectives_impl="pallas")
        assert tcoll.collectives_trace_key() == "pallas"
        from dlaf_tpu_torch.health import ConfigurationError

        with pytest.raises(ConfigurationError, match="collectives_impl"):
            tp.update(collectives_impl="bogus")
        tp.collectives_impl = "bogus"  # an environment typo bypasses update()
        with pytest.raises(ConfigurationError, match="collectives_impl"):
            tcoll.collectives_trace_key()
    finally:
        tp.collectives_impl = old


def test_overlap_window_is_a_no_op_scope():
    with tcoll.overlap_window():
        assert tcoll.my_rank() == (0, 0)


@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_both_axes_psum_and_gather_match_jax(shape):
    """The collectives over both grid axes that the D&C uses
    (``tridiag_dc_dist._BOTH``): ``psum_axis(x, BOTH)`` against
    ``lax.psum`` within ``tol_for(f64, P)``, ``all_gather_axis(x, BOTH)``
    against ``lax.all_gather`` bit for bit; both stack in the JAX package's
    order of its axis tuple, flat rank ``r * Pc + c``."""
    from jax import lax

    from dlaf_tpu.algorithms.tridiag_dc_dist import _BOTH

    pr, pc = shape
    x = np.random.default_rng(pr * 10 + pc).standard_normal((pr, pc, 3, 4))
    jgrid = next(g for g in _jax_grids() if tuple(g.grid_size) == shape)
    f = jcoll.spmd(jgrid, lambda v: tuple(jcoll.relocal(o) for o in (
        lax.psum(jcoll.local(v), _BOTH), lax.all_gather(jcoll.local(v), _BOTH))))
    want = [np.asarray(o) for o in f(jax.device_put(x, jgrid.stacked_sharding()))]
    got = {}

    def body(v):
        got[tcoll.my_rank()] = [tcoll.psum_axis(v, tcoll.BOTH).clone(),
                                tcoll.all_gather_axis(v, tcoll.BOTH).clone()]

    tcoll.spmd(grid_like(shape), body, torch.from_numpy(x))
    assert tcoll.BOTH == tuple(_BOTH)
    for i in range(2):
        g = np.stack([np.stack([got[(r, c)][i].numpy() for c in range(pc)]) for r in range(pr)])
        assert g.shape == want[i].shape
        if i == 0:
            assert np.max(np.abs(g - want[i])) <= tol_for(np.float64, pr * pc) * np.abs(x).sum()
        else:
            np.testing.assert_array_equal(g, want[i])
            for f_ in range(pr * pc):
                np.testing.assert_array_equal(g[0, 0, f_], x[f_ // pc, f_ % pc])
