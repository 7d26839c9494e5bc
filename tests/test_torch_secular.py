"""The secular-bisection kernel (B10) and the D&C pieces around it.

* Its plain version against the JAX package's Pallas kernel in interpret
  mode (``dlaf_tpu/ops/pallas_secular.py``), at the JAX test's shapes
  (``tests/test_pallas_kernels.py:116``), on bracketed secular equations:
  sorted poles, positive weights and rho, each row anchored at a pole with
  the bracket up to the next one, so every bracket holds one root.  The
  two loops do the same rounds in the same order; the row sums are taken
  in another order by XLA and by PyTorch, so the roots are compared
  relative to the bracket width at ``tol_for(f32, S)``.
* The segmented scan of the deflation step against a sequential loop.
* On a CUDA card only: the kernel against the plain version, the same
  tolerance, at rows short enough for registers and longer than 8192; and
  a small HEEV pipeline on the card that launches B10 twice per merge
  level and B3, with residual and orthogonality at ``tol_for``.

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


def _bracketed(k: int, s: int, seed: int):
    """k secular equations over s sorted poles: row r anchors at pole
    j = r mod (s - 1), bracket (0, d[j+1] - d[j])."""
    rng = np.random.default_rng(seed)
    d = np.sort(rng.standard_normal((k, s)), axis=1).astype(np.float32)
    z2 = (rng.standard_normal((k, s)) ** 2 * 0.1 + 1e-3).astype(np.float32)
    rho = (np.abs(rng.standard_normal(k)) + 0.1).astype(np.float32)
    j = np.arange(k) % (s - 1)
    anchor = d[np.arange(k), j]
    gap = (d[np.arange(k), j + 1] - anchor).astype(np.float32)
    return d, z2, rho, anchor, np.zeros(k, np.float32), gap


@pytest.mark.parametrize("k,s", [(64, 128), (128, 64), (256, 256)])
def test_secular_plain_matches_pallas(k, s):
    jnp = pytest.importorskip("jax.numpy")
    from dlaf_tpu.ops.pallas_secular import secular_bisect as jax_bisect

    args = _bracketed(k, s, seed=k + s)
    ref = np.asarray(jax_bisect(*map(jnp.asarray, args), ITERS, True))
    before = secular.launches
    got = secular.secular_bisect(*map(torch.from_numpy, args), ITERS)
    assert secular.launches == before  # CPU tensors take the plain loop
    gap = args[5]
    assert np.all(np.isfinite(ref)) and np.all((ref > 0) & (ref < gap))
    assert np.max(np.abs(got.numpy() - ref) / gap) <= tol_for(np.float32, s)


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
def test_cuda_secular_refuses_what_it_does_not_take():
    dev = _cuda()
    args = [torch.from_numpy(a).to(dev) for a in _bracketed(8, 16, seed=1)]
    with pytest.raises(TypeError):
        secular.secular_bisect(*[a.double() for a in args], ITERS)
    with pytest.raises(ValueError):
        secular.secular_bisect(args[0], args[1], args[2][:4], *args[3:], ITERS)


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
