"""The secular-bisection kernel (B10) and the D&C pieces around it.

* Its plain version against the JAX package's Pallas kernel in interpret
  mode (``dlaf_tpu/ops/pallas_secular.py``), at the JAX test's shapes
  (``tests/test_pallas_kernels.py:116``), on bracketed secular equations:
  sorted poles, positive weights and rho, each row anchored at a pole with
  the bracket up to the next one (mu) or from the one before (nu, anchored
  at the upper pole), so every bracket holds one root.  The two loops do
  the same rounds in the same order; the row sums are taken in another
  order by XLA and by PyTorch, so the roots are compared relative to the
  bracket width at ``tol_for(f32, S)``.
* The kernel's stopping rule on the CPU: a loop that leaves a row once a
  round leaves its bracket unchanged bit for bit gives the plain loop's
  answer after all 42 rounds, bit for bit, on mu and nu brackets, roots
  next to their pole, a zero gap and a NaN weight; and
  ``secular_rounds_plain`` counts the rounds that loop runs.
* The segmented scan of the deflation step against a sequential loop.
* On a CUDA card only: the kernel against the plain version, the same
  tolerance, at rows short enough for registers and longer than 8192; the
  kernel bit for bit its first body (``secular_bisect_reference``) at
  every compiled instantiation on those rows; and a small HEEV pipeline on
  the card that launches B10 twice per merge level and B3, with residual
  and orthogonality at ``tol_for``.

The JAX side is imported inside the reference test, so that on a machine
with a card and no JAX the CUDA tests still run:
``python -m pytest tests/test_torch_secular.py --noconftest -m cuda``.
"""
import numpy as np
import pytest
import torch

from dlaf_tpu_torch import tune
from dlaf_tpu_torch.algorithms.tridiag_dc_dist import _segmented_sum
from dlaf_tpu_torch.ops import secular, trailing_update
from dlaf_tpu_torch.testing import random_hermitian_pd, tol_for

ITERS = 42  # f32 rounds, tridiag_dc_dist.py:604


def _bracketed(k: int, s: int, seed: int, side: str = "mu"):
    """k secular equations over s sorted poles: row r's root lies between
    poles j = r mod (s - 1) and j + 1.  ``side="mu"`` anchors the row at
    pole j with the bracket (0, d[j+1] - d[j]); ``"nu"`` at pole j + 1 with
    (-(d[j+1] - d[j]), 0), as the D&C's second bisection."""
    rng = np.random.default_rng(seed)
    d = np.sort(rng.standard_normal((k, s)), axis=1).astype(np.float32)
    z2 = (rng.standard_normal((k, s)) ** 2 * 0.1 + 1e-3).astype(np.float32)
    rho = (np.abs(rng.standard_normal(k)) + 0.1).astype(np.float32)
    rows = np.arange(k)
    j = rows % (s - 1)
    gap = (d[rows, j + 1] - d[rows, j]).astype(np.float32)
    zero = np.zeros(k, np.float32)
    if side == "mu":
        return d, z2, rho, d[rows, j], zero, gap
    return d, z2, rho, d[rows, j + 1], -gap, zero


def _adversarial(k: int, s: int, seed: int):
    """``_bracketed``'s tables with the rows the early stop must not
    flatter or break: even rows mu brackets, odd rows nu; rows r with
    r mod 8 = 0 give their anchor pole a weight of 1e-6 of the row's mean
    weight and rows with r mod 8 = 1 one of 1e-12, so that where the other
    poles' terms do not change sign inside the bracket, the root sits next
    to that pole and needs every round; row k - 2 has a zero gap (the
    bracket (0, 0): the anchor pole's gap to mid is 0 in every round,
    FLT_MIN in its place); row k - 1 a NaN weight."""
    d, z2, rho, anchor, lo, hi = _bracketed(k, s, seed)
    _, _, _, anchor_nu, lo_nu, hi_nu = _bracketed(k, s, seed, side="nu")
    rows = np.arange(k)
    nu = rows % 2 == 1
    anchor, lo, hi = (np.where(nu, b, a) for a, b in ((anchor, anchor_nu), (lo, lo_nu),
                                                     (hi, hi_nu)))
    a_idx = rows % (s - 1) + nu
    for r8, frac in ((0, 1e-6), (1, 1e-12)):
        near = rows % 8 == r8
        z2[rows[near], a_idx[near]] = frac * z2[near].mean(axis=1)
    lo[k - 2] = hi[k - 2] = 0.0
    z2[k - 1, s // 2] = np.nan
    return d, z2, rho, anchor.astype(np.float32), lo.astype(np.float32), hi.astype(np.float32)


def _check_plain_matches_pallas(k, s, side):
    jnp = pytest.importorskip("jax.numpy")
    from dlaf_tpu.ops.pallas_secular import secular_bisect as jax_bisect

    args = _bracketed(k, s, seed=k + s, side=side)
    ref = np.asarray(jax_bisect(*map(jnp.asarray, args), ITERS, True))
    before = secular.launches
    got = secular.secular_bisect(*map(torch.from_numpy, args), ITERS)
    assert secular.launches == before  # CPU tensors take the plain loop
    lo, hi = args[4], args[5]
    gap = hi - lo
    assert np.all(np.isfinite(ref)) and np.all((ref > lo) & (ref < hi))
    assert np.max(np.abs(got.numpy() - ref) / gap) <= tol_for(np.float32, s)


@pytest.mark.parametrize("k,s", [(64, 128), (128, 64), (256, 256)])
def test_secular_plain_matches_pallas(k, s):
    _check_plain_matches_pallas(k, s, "mu")


@pytest.mark.parametrize("k,s", [(64, 128), (128, 64), (256, 256)])
def test_secular_plain_matches_pallas_nu(k, s):
    """The D&C's second bisection: anchored at the upper pole, (-gap, 0)."""
    _check_plain_matches_pallas(k, s, "nu")


def _bits(t):
    return t.view(torch.int32)


def _stop_at_fixed_point(dw, z2w, rho, anchor, lo0, hi0, iters):
    """The plain loop under the kernel's stopping rule: a row leaves once a
    round leaves both ends of its bracket unchanged, compared by their
    bits.  Returns the answers and the rounds each row ran."""
    tiny = torch.finfo(dw.dtype).tiny
    ag = dw - anchor[:, None]
    lo, hi = lo0.clone(), hi0.clone()
    live = torch.ones(lo.shape, dtype=torch.bool)
    ran = torch.zeros(lo.shape, dtype=torch.int64)
    for _ in range(iters):
        if not live.any():
            break
        mid = 0.5 * (lo + hi)
        diff = ag - mid[:, None]
        fm = 1.0 + rho * torch.sum(z2w / torch.where(diff == 0, tiny, diff), dim=1)
        neg = fm < 0
        nlo, nhi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
        fixed = (_bits(nlo) == _bits(lo)) & (_bits(nhi) == _bits(hi))
        ran += live
        lo, hi = torch.where(live, nlo, lo), torch.where(live, nhi, hi)
        live &= ~fixed
    return 0.5 * (lo + hi), ran


@pytest.mark.parametrize("k,s", [(64, 128), (128, 64), (256, 256)])
def test_fixed_point_stop_is_the_plain_answer(k, s):
    """Stopping each row at its bracket's fixed point gives the 42-round
    answer bit for bit, on every kind of row; some near-pole rows run all
    42 rounds and most others stop well before, so the rule is exercised."""
    args = [torch.from_numpy(a) for a in _adversarial(k, s, seed=7 * k + s)]
    want = secular.secular_bisect_plain(*args, ITERS)
    got, ran = _stop_at_fixed_point(*args, ITERS)
    assert torch.equal(_bits(got), _bits(want))
    # the zero gap's bracket is fixed after one round; the NaN weight's f is
    # NaN in every round, so hi walks down to lo
    assert want[k - 2] == 0.0 and ran[k - 2] == 1
    assert torch.isfinite(want[k - 1]) and ran[k - 1] < ITERS
    near = torch.arange(k) % 8 < 2
    assert bool((ran[near] == ITERS).any())
    assert ran[near].float().mean() > ran[~near].float().mean() + 5


@pytest.mark.parametrize("k,s", [(64, 128), (128, 64), (256, 256)])
def test_rounds_plain_counts_the_stop(k, s):
    """``secular_rounds_plain`` is the last round that moved a bracket:
    the stopping loop runs one round more to see it fixed, or all 42."""
    for side in ("mu", "nu", None):
        raw = _adversarial(k, s, seed=k + 3 * s) if side is None else \
            _bracketed(k, s, seed=k + 3 * s, side=side)
        args = [torch.from_numpy(a) for a in raw]
        need = secular.secular_rounds_plain(*args, ITERS)
        _, ran = _stop_at_fixed_point(*args, ITERS)
        assert torch.equal(torch.clamp(need + 1, max=ITERS), ran)
        assert int(need.max()) <= ITERS
        assert int(need.min()) > 0 or side is None and need[k - 2] == 0  # the zero gap


def test_secular_plain_is_a_root():
    """The plain loop's answers make f change sign across them."""
    d, z2, rho, anchor, lo, gap = map(torch.from_numpy, _bracketed(32, 50, seed=3))
    x = secular.secular_bisect_plain(d, z2, rho, anchor, lo, gap, ITERS).double()
    ag = d.double() - anchor.double()[:, None]

    def f(v):
        return 1.0 + rho.double() * torch.sum(z2.double() / (ag - v[:, None]), 1)

    h = gap.double() * 1e-4
    assert torch.all(f(x - h) < 0) and torch.all(f(x + h) > 0)


@pytest.mark.parametrize("s", [1, 7, 64, 300])
def test_segmented_sum_matches_sequential(s):
    rng = np.random.default_rng(s)
    vals = rng.standard_normal((3, s))
    starts = rng.random((3, s)) < 0.3
    starts[:, 0] = True
    want = np.zeros_like(vals)
    for r in range(3):
        acc = 0.0
        for c in range(s):
            acc = vals[r, c] if starts[r, c] else acc + vals[r, c]
            want[r, c] = acc
    got = _segmented_sum(torch.from_numpy(vals), torch.from_numpy(starts)).numpy()
    np.testing.assert_allclose(got, want, rtol=tol_for(np.float64, s), atol=tol_for(np.float64, s))


@pytest.mark.parametrize("dtype,secular_knob,calls",
                         [(np.float32, True, 4), (np.float32, False, 4), (np.float64, True, 0)],
                         ids=["f32-knob_on", "f32-knob_default", "f64"])
def test_dc_bisection_route(monkeypatch, dtype, secular_knob, calls):
    """The D&C sends f32 through the kernel's wrapper (two bisections per
    merge level, here two levels) whatever ``dc_secular_pallas`` says, and
    f64 through the plain loop, as the JAX package's gate."""
    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch.algorithms.tridiag_dc_dist import tridiag_dc_distributed

    seen = []
    wrapper = secular.secular_bisect

    def counting(*args):
        seen.append(args[0].shape)
        return wrapper(*args)

    monkeypatch.setattr(secular, "secular_bisect", counting)
    rng = np.random.default_rng(5)
    n = 64
    d = rng.standard_normal(n).astype(dtype)
    e = rng.standard_normal(n - 1).astype(dtype)
    tp = tune.get_tune_parameters()
    old = {"dc_leaf_size": tp.dc_leaf_size, "dc_secular_pallas": tp.dc_secular_pallas}
    tp.update(dc_leaf_size=16, dc_secular_pallas=secular_knob)
    try:
        w, _ = tridiag_dc_distributed(dtt.Grid.create(device="cpu"), d, e, 16, dtype=dtype)
    finally:
        tp.update(**old)
    assert len(seen) == calls
    tri = np.diag(d.astype(np.float64)) + np.diag(e, 1) + np.diag(e, -1)
    want = np.linalg.eigvalsh(tri)
    assert np.max(np.abs(w - want)) <= tol_for(dtype, n) * np.max(np.abs(want))


# --------------------------------------------------- CUDA kernel (card only)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,s", [(64, 100), (64, 512), (256, 1024), (64, 2048), (64, 4096),
                                 (33, 8192), (16, 9000)])
def test_cuda_secular_matches_plain(k, s):
    """One row length per compiled instantiation of the kernel (elements
    per thread 1, 2, 4, 8, 16, 32, and the streaming one)."""
    dev = _cuda()
    args = [torch.from_numpy(a).to(dev) for a in _bracketed(k, s, seed=k * s)]
    before = secular.launches
    got = secular.secular_bisect(*args, ITERS)
    assert secular.launches == before + 1
    ref = secular.secular_bisect_plain(*args, ITERS)
    gap = args[5]
    assert torch.max((got - ref).abs() / gap).item() <= tol_for(np.float32, s)


@pytest.mark.cuda
@pytest.mark.parametrize("k,s", [(64, 100), (64, 512), (256, 1024), (64, 2048), (64, 4096),
                                 (33, 8192), (16, 9000)])
def test_cuda_secular_is_its_first_body(k, s):
    """The body that stops each row at its bracket's fixed point, one
    barrier a round, bit for bit its first body (every round, two barriers)
    at every compiled instantiation: on the rows of the plain comparison,
    their nu brackets, and the adversarial rows (roots next to their pole,
    a zero gap, a NaN weight)."""
    dev = _cuda()
    for raw in (_bracketed(k, s, seed=k * s), _bracketed(k, s, seed=k * s, side="nu"),
                _adversarial(k, s, seed=k + s)):
        args = [torch.from_numpy(a).to(dev) for a in raw]
        before = secular.launches
        got = secular.secular_bisect(*args, ITERS)
        ref = secular.secular_bisect_reference(*args, ITERS)
        assert secular.launches == before + 1  # the reference counts nothing
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1024, 9000])
@pytest.mark.parametrize("iters", [0, 1, 7, 60])
def test_cuda_secular_is_its_first_body_at_any_rounds(s, iters):
    """The same at other round counts: none (the bracket's midpoint), one,
    a few, and more than f32 needs (every row reaches its fixed point)."""
    dev = _cuda()
    args = [torch.from_numpy(a).to(dev) for a in _adversarial(40, s, seed=s + iters)]
    got = secular.secular_bisect(*args, iters)
    ref = secular.secular_bisect_reference(*args, iters)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
def test_cuda_secular_refuses_what_it_does_not_take():
    dev = _cuda()
    args = [torch.from_numpy(a).to(dev) for a in _bracketed(8, 16, seed=1)]
    with pytest.raises(TypeError):
        secular.secular_bisect(*[a.double() for a in args], ITERS)
    with pytest.raises(ValueError):
        secular.secular_bisect(args[0], args[1], args[2][:4], *args[3:], ITERS)
    with pytest.raises(TypeError):
        secular.secular_bisect_reference(*[a.double() for a in args], ITERS)


@pytest.mark.cuda
@pytest.mark.parametrize("secular_knob", [True, False], ids=["knob_on", "knob_default"])
def test_cuda_pipeline_launches_its_kernels(secular_knob):
    """B10 is launched on the card whatever ``dc_secular_pallas`` says
    (False is its default): the plain loop never runs on a CUDA grid."""
    dev = _cuda()
    import dlaf_tpu_torch as dtt

    n = 256
    a = random_hermitian_pd(n, np.float32, seed=4)
    mat = dtt.DistributedMatrix.from_global(dtt.Grid.create(), np.tril(a), (64, 64))
    tp = tune.get_tune_parameters()
    knobs = dict(eigensolver_min_band=16, eigensolver_sbr_band=8, dc_leaf_size=64,
                 dc_secular_pallas=secular_knob, trailing_update_impl="fused",
                 band_chase_backend="native")
    old = {k: getattr(tp, k) for k in knobs}
    tp.update(**knobs)
    try:
        b10, b3 = secular.launches, trailing_update.launches
        res = dtt.hermitian_eigensolver("L", mat, backend="pipeline")
    finally:
        tp.update(**old)
    assert secular.launches - b10 == 4  # two merge levels, mu and nu each
    assert trailing_update.launches > b3
    v = torch.from_numpy(res.eigenvectors.to_global()).to(dev, torch.float64)
    w = torch.from_numpy(np.asarray(res.eigenvalues, np.float64)).to(dev)
    a64 = torch.from_numpy(a).to(dev, torch.float64)
    tol = tol_for(np.float32, n)
    assert (a64 @ v - v * w).abs().max().item() < tol * a64.abs().max().item()
    assert (v.T @ v - torch.eye(n, device=dev, dtype=torch.float64)).abs().max().item() < tol
