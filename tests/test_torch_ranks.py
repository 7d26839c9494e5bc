"""The rank runtime of the port (``dlaf_tpu_torch/comm/_ranks.py``): every
rank of a ``Pr x Pc`` grid as a thread of one process, the counterpart of
the JAX package's ``collectives.spmd`` over a mesh.

Covered on the CPU: each rank sees its own coordinates and its own view
``data[r, c]``; ``spmd`` returns rank (0, 0)'s result; a rank body that
raises makes ``spmd`` raise within its deadline while the other ranks wait
in a collective, and the grid works again afterwards; a wait that runs out
raises ``DeadlineExceededError``; a factorization with a rank thread that
sleeps at every ring entry (the JAX package's ``slow_collective`` case)
gives the v2 tier's bits; a 2x4 JAX matrix round-trips through
``from_stacked``/``to_stacked``; ``Grid.create`` builds every fixture
shape.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import dlaf_tpu as dt
import dlaf_tpu.testing as tu
import dlaf_tpu_torch as dtt
from dlaf_tpu_torch import tune
from dlaf_tpu_torch.comm import _ranks
from dlaf_tpu_torch.comm import collectives as coll
from dlaf_tpu_torch.health import DeadlineExceededError
from dlaf_tpu_torch.matrix.matrix import DistributedMatrix
from dlaf_tpu_torch.ops import panel_exchange as px
from dlaf_tpu_torch.testing import GRID_SHAPES, grid_like


@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_each_rank_runs_on_its_view(shape):
    pr, pc = shape
    grid = grid_like(shape)
    assert tuple(grid.grid_size) == shape and grid.device == torch.device("cpu")
    x = torch.zeros(pr, pc, 3)
    seen = {}
    lock = threading.Lock()

    def body(v):
        r, c = coll.my_rank()
        with lock:
            seen[(r, c)] = (coll.grid_shape(), threading.current_thread().name)
        v += 10 * r + c  # in place: lands in x
        return torch.tensor(float(r * pc + c))

    out = coll.spmd(grid, body, x)
    assert out.item() == 0.0  # rank (0, 0)'s result
    assert set(seen) == {(r, c) for r in range(pr) for c in range(pc)}
    assert all(s[0] == shape for s in seen.values())
    if pr * pc > 1:
        assert len({s[1] for s in seen.values()}) == pr * pc  # one thread per rank
    for r in range(pr):
        for c in range(pc):
            assert torch.all(x[r, c] == 10 * r + c)
    assert coll.my_rank() == (0, 0) and coll.grid_shape() == (1, 1)  # the caller is untouched


@pytest.mark.parametrize("tier", ["psum", "v2", "pallas"])
def test_raising_rank_releases_the_others(tier, monkeypatch):
    """Rank (1, 2) raises while the others wait for it in a broadcast: spmd
    re-raises its exception at once (far inside the wait bound), and the
    grid is usable afterwards."""
    monkeypatch.setattr(_ranks, "WAIT_S", 30.0)
    grid = grid_like((2, 4))
    x = torch.arange(8.0).reshape(2, 4, 1)
    tp = tune.get_tune_parameters()
    old = tp.collectives_impl
    tp.update(collectives_impl=tier)
    try:
        def body(v):
            if coll.my_rank() == (1, 2):
                raise ValueError("rank (1, 2) failed")
            return coll.bcast(v, 2, "c")

        t0 = time.monotonic()
        with pytest.raises(ValueError, match=r"rank \(1, 2\) failed"):
            coll.spmd(grid, body, x)
        assert time.monotonic() - t0 < 10.0
        assert coll.spmd(grid, lambda v: coll.bcast(v, 3, "c"), x).item() == 3.0
    finally:
        tp.update(collectives_impl=old)


def test_wait_bound_raises_deadline(monkeypatch):
    """A collective that one rank never joins is a failure, not a hang."""
    monkeypatch.setattr(_ranks, "WAIT_S", 0.3)
    grid = grid_like((2, 2))

    def body(v):
        if coll.my_rank() == (0, 1):
            return None
        return coll.psum_axis(v, "r")

    t0 = time.monotonic()
    with pytest.raises(DeadlineExceededError):
        coll.spmd(grid, body, torch.zeros(2, 2, 3))
    assert time.monotonic() - t0 < 30.0


def test_skewed_rank_gives_the_v2_bits(monkeypatch):
    """Mirrors the JAX package's slow_collective case: rank (1, 3) sleeps
    before every ring entry; the pallas tier's ring (its plain twin here)
    still completes, with the v2 tier's bits, bucketed and lookahead."""
    a = tu.random_hermitian_pd(32, np.float32, seed=53)
    grid = grid_like((2, 4))
    out = {}
    tp = tune.get_tune_parameters()
    old = {k: getattr(tp, k) for k in ("collectives_impl", "cholesky_lookahead")}
    try:
        for lookahead in (False, True):
            for tier in ("v2", "pallas"):
                tp.update(collectives_impl=tier, cholesky_lookahead=lookahead)
                if tier == "pallas":
                    monkeypatch.setitem(px.launch_delay_s, (1, 3), 0.005)
                mat = DistributedMatrix.from_global(grid, np.tril(a), (8, 8))
                out[tier] = dtt.cholesky_factorization("L", mat).to_global()
                px.launch_delay_s.clear()
            if not lookahead:  # the lookahead panel is B7's twin: B2's schedule
                np.testing.assert_array_equal(out["v2"], out["pallas"])
            else:
                assert np.max(np.abs(out["v2"] - out["pallas"])) <= tu.tol_for(np.float32, 32)
    finally:
        tp.update(**old)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_stacked_round_trip_of_a_2x4_jax_matrix(comm_grids, dtype):
    jgrid = next(g for g in comm_grids if tuple(g.grid_size) == (2, 4))
    a = tu.random_matrix(37, 29, dtype, seed=4)
    jm = dt.DistributedMatrix.from_global(jgrid, a, (8, 6))
    stacked = np.asarray(jm.data)
    tm = DistributedMatrix.from_stacked(stacked, jm.dist, grid_like(jgrid))
    assert tuple(tm.data.shape) == stacked.shape
    np.testing.assert_array_equal(tm.to_stacked(), stacked)
    np.testing.assert_array_equal(tm.to_global(), a)
    # and the port's own packing agrees with the JAX package's, slot for slot
    own = DistributedMatrix.from_global(grid_like((2, 4)), a, (8, 6))
    np.testing.assert_array_equal(own.to_stacked(), stacked)


def test_grid_shapes_and_default():
    assert tuple(dtt.Grid.create(device="cpu").grid_size) == (1, 1)
    for shape in GRID_SHAPES:
        g = dtt.Grid.create(shape, device="cpu")
        assert tuple(g.grid_size) == shape and g.size == shape[0] * shape[1]
    with pytest.raises(ValueError):
        dtt.Grid.create((0, 2), device="cpu")


def test_one_rank_algorithms_refuse_multi_rank_stacks():
    """The HEEV pipeline, once a 1x1-only algorithm, runs on a multi-rank
    stack (here the identity: every eigenvalue 1, orthonormal
    eigenvectors), and so does a partial spectrum (four orthonormal
    columns); what it does not run on any grid yet (complex dtypes) raises
    NotImplementedError naming ROADMAP there too."""
    mat = DistributedMatrix.from_global(grid_like((2, 2)), np.eye(16), (4, 4))
    res = dtt.hermitian_eigensolver("L", mat, backend="pipeline")
    v = res.eigenvectors.to_global()
    np.testing.assert_allclose(res.eigenvalues, np.ones(16), atol=1e-12)
    np.testing.assert_allclose(v.T @ v, np.eye(16), atol=1e-12)
    res = dtt.hermitian_eigensolver("L", mat, spectrum=(0, 3), backend="pipeline")
    v = res.eigenvectors.to_global()
    assert v.shape == (16, 4)
    np.testing.assert_allclose(res.eigenvalues, np.ones(4), atol=1e-12)
    np.testing.assert_allclose(v.T @ v, np.eye(4), atol=1e-12)
    cmat = DistributedMatrix.from_global(grid_like((2, 2)), np.eye(16, dtype=np.complex128),
                                         (4, 4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dtt.hermitian_eigensolver("L", cmat, backend="pipeline")


def test_rendezvous_bounds_the_host_skew_of_a_ring():
    """Before a ring kernel is launched its rank meets the other ranks of
    its ring on the host: no rank leaves call k before every rank of its
    ring has reached it (ranks of other rings are not waited for)."""
    grid = grid_like((2, 4))
    order = []
    lock = threading.Lock()

    def body(v):
        r, c = coll.my_rank()
        for k in range(3):
            if (r, c) == (0, 2):
                time.sleep(0.02)  # the late rank of ring (row) 0
            with lock:
                order.append(("arrive", r, k))
            _ranks.rendezvous("c", "test")
            with lock:
                order.append(("leave", r, k))

    coll.spmd(grid, body, torch.zeros(2, 4, 1))
    for r in range(2):
        for k in range(3):
            arrive = [i for i, e in enumerate(order) if e == ("arrive", r, k)]
            leave = [i for i, e in enumerate(order) if e == ("leave", r, k)]
            assert len(arrive) == len(leave) == 4
            assert max(arrive) < min(leave)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (4, 2), (1, 2), (2, 1)])
def test_first_failure_is_rank_replicated(shape):
    """The Cholesky info combine: every rank holds the info of the tiles it
    scanned (0 where none failed), and every rank gets the least non-zero
    one, or 0."""
    from dlaf_tpu_torch.algorithms.cholesky import _first_failure

    pr, pc = shape
    for local in ({(pr - 1, pc - 1): 28, (0, pc - 1): 46}, {}):
        got = {}

        def body(v):
            r, c = coll.my_rank()
            got[(r, c)] = int(_first_failure(torch.tensor(local.get((r, c), 0),
                                                          dtype=torch.int32)))

        coll.spmd(dtt.Grid.create(shape, device="cpu"), body, torch.zeros(pr, pc, 1))
        want = min(local.values(), default=0)
        assert got == {(r, c): want for r in range(pr) for c in range(pc)}


class _Stream:
    def __init__(self, handle):
        self.cuda_stream = handle


@pytest.mark.parametrize("case", ["ok", "lazy", "too_many_ranks", "few_queues", "shared_streams",
                                  "requested_too_late"])
def test_cuda_settings_are_checked_for_multi_rank_grids(case, monkeypatch):
    """A multi-rank grid on the card needs eager module loading, a hardware
    queue per rank stream (plus the side and the caller's stream) and
    distinct rank streams; where CUDA read other settings, building the
    grid's runtime raises ConfigurationError instead of letting the ring
    kernels time out."""
    from dlaf_tpu_torch.health import ConfigurationError

    env = {"CUDA_MODULE_LOADING": "EAGER", "CUDA_DEVICE_MAX_CONNECTIONS": "32"}
    n = 8
    streams = [_Stream(h) for h in range(1, n + 2)]
    if case == "lazy":
        env["CUDA_MODULE_LOADING"] = "LAZY"
    elif case == "too_many_ranks":
        n = 31
        streams = [_Stream(h) for h in range(1, n + 2)]
    elif case == "few_queues":
        env["CUDA_DEVICE_MAX_CONNECTIONS"] = "8"
    elif case == "shared_streams":
        streams[3] = _Stream(streams[0].cuda_stream)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(_ranks, "_cuda_env_read", None)
    if case == "requested_too_late":
        # CUDA initialised before the package asked: it read the defaults
        for k in env:
            monkeypatch.delenv(k)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        _ranks.request_cuda_env()
        assert all(os.environ[k] == v for k, v in _ranks.CUDA_ENV.items())
    if case == "ok":
        _ranks._check_cuda_settings(n, streams)
        return
    match = {"lazy": "CUDA_MODULE_LOADING", "too_many_ranks": "hardware queues",
             "few_queues": "hardware queues", "shared_streams": "distinct stream",
             "requested_too_late": "imported"}[case]
    with pytest.raises(ConfigurationError, match=match):
        _ranks._check_cuda_settings(n, streams)
