"""The port's kernels: each plain PyTorch version against the JAX package's
Pallas kernel run in interpret mode (as the JAX package's own tests run it
on the CPU), the wrappers' dispatch and checks, and — on a CUDA card only —
each CUDA kernel against its plain version.

Tolerance: ``tol_for(dtype, n)`` (``dlaf_tpu/testing/__init__.py:55``) of
the relative max error, n the tile side or contraction depth: the two
frameworks sum in different orders.

The JAX side is imported inside the reference tests, so that on a machine
with a card and no JAX the CUDA tests still run:
``python -m pytest tests/test_torch_kernels.py --noconftest -m cuda``.
"""
import numpy as np
import pytest
import torch

from dlaf_tpu_torch import ops
from dlaf_tpu_torch.ops import panel_trsm, potrf, secular, tile, trailing_update
from dlaf_tpu_torch.testing import random_hermitian_pd, random_matrix, tol_for
from dlaf_tpu_torch.tune import get_tune_parameters

DTYPES = [np.float32, np.float64]


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


def _jax():
    jax = pytest.importorskip("jax")
    return jax, pytest.importorskip("jax.numpy")


def _lower_factor(n, dtype, seed=0):
    return np.linalg.cholesky(random_hermitian_pd(n, np.float64, seed)).astype(dtype)


# ------------------------------------------------ plain versions vs the JAX kernels


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [32, 64])
def test_potrf_plain_matches_pallas(n, dtype):
    jax, jnp = _jax()
    from jax.experimental import pallas as pl

    from dlaf_tpu.ops import pallas_potrf

    a = random_hermitian_pd(n, dtype, seed=n)
    a_lower = np.tril(a) + np.triu(random_matrix(n, n, dtype, seed=1), 1)  # garbage upper
    herm = jnp.tril(a_lower) + jnp.tril(a_lower, -1).T
    ref = pl.pallas_call(pallas_potrf._potrf_kernel,
                         out_shape=jax.ShapeDtypeStruct(herm.shape, herm.dtype),
                         interpret=True)(herm)
    got = potrf.potrf_tile(torch.from_numpy(a_lower))
    assert got.dtype == torch.from_numpy(a).dtype
    assert np.all(np.triu(got.numpy(), 1) == 0)
    assert _rel_err(got.numpy(), np.asarray(ref)) <= tol_for(dtype, n)


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb", [(64, 32), (96, 64), (40, 96), (200, 96), (200, 160)])
def test_panel_trsm_plain_matches_pallas(m, nb, dtype, conj):
    _, jnp = _jax()
    from dlaf_tpu.ops.pallas_panel_trsm import panel_trsm_right_lower_t

    ell = _lower_factor(nb, dtype, seed=m)
    ell_g = ell + np.triu(random_matrix(nb, nb, dtype, seed=2), 1)  # upper is not read
    b = random_matrix(m, nb, dtype, seed=3)
    ref = panel_trsm_right_lower_t(jnp.asarray(ell_g), jnp.asarray(b), conj, True)
    got = panel_trsm.panel_trsm_right_lower_t(torch.from_numpy(ell_g), torch.from_numpy(b), conj)
    assert _rel_err(got.numpy(), np.asarray(ref)) <= tol_for(dtype, nb)
    np.testing.assert_allclose(got.numpy() @ ell.T, b, rtol=0, atol=tol_for(dtype, nb) * 10)


#: B3's (L, C, M, N, K): a small case, then M and N off the CUDA body's 128
#: tile (192, 200) and K off (130) and on (128) its 16-deep k slice
B3_SHAPES = [(3, 2, 16, 8, 16), (2, 1, 192, 200, 130), (1, 2, 200, 192, 128)]


def _b3_cases():
    return [pytest.param(sub, shape, id=sub if i == 0 else f"{sub}-{'x'.join(map(str, shape))}")
            for sub in (trailing_update.CHOLESKY_SUBSCRIPTS, trailing_update.TRSM_SUBSCRIPTS)
            for i, shape in enumerate(B3_SHAPES)]


def _b3_operands(subscripts, shape, dtype):
    L, C, M, N, K = shape
    x = random_matrix(L * C * M, N, dtype, seed=4).reshape(L, C, M, N)
    a = random_matrix(L * M, K, dtype, seed=5).reshape(L, M, K)
    bshape = (C, N, K) if subscripts == trailing_update.CHOLESKY_SUBSCRIPTS else (C, K, N)
    b = random_matrix(int(np.prod(bshape[:-1])), bshape[-1], dtype, seed=6).reshape(bshape)
    return x, a, b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("subscripts,shape", _b3_cases())
def test_trailing_update_plain_matches_pallas(subscripts, shape, dtype):
    _, jnp = _jax()
    from dlaf_tpu.ops import pallas_trailing_update as ptu

    K = shape[4]
    x, a, b = _b3_operands(subscripts, shape, dtype)
    ref = ptu.trailing_update(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), subscripts,
                              interpret=True, tier="default")
    xt = torch.from_numpy(x.copy())
    out = trailing_update.trailing_update(xt, torch.from_numpy(a), torch.from_numpy(b), subscripts)
    assert out is xt  # written in place
    assert _rel_err(out.numpy(), np.asarray(ref)) <= tol_for(dtype, K)


# ------------------------------------------------------ wrappers on the CPU


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    ops.reset_launch_counts()
    d = torch.from_numpy(random_hermitian_pd(32, np.float64, 1))
    potrf.potrf_tile(d)
    panel_trsm.panel_trsm_right_lower_t(torch.linalg.cholesky(d), torch.ones(8, 32, dtype=d.dtype))
    x = torch.zeros(1, 1, 4, 4, dtype=d.dtype)
    trailing_update.trailing_update(x, torch.ones(1, 4, 2, dtype=d.dtype),
                                    torch.ones(1, 4, 2, dtype=d.dtype))
    root = secular.secular_bisect(torch.tensor([[0.0, 1.0]]), torch.tensor([[0.5, 0.5]]),
                                  torch.ones(1), torch.zeros(1), torch.zeros(1), torch.ones(1), 30)
    assert ops.launch_counts() == {"potrf": 0, "panel_trsm": 0, "trailing_update": 0,
                                   "secular_bisect": 0, "merge_hop": 0, "ring_exchange": 0,
                                   "fused_factor_bcast": 0, "dma_ring_consume": 0,
                                   "fused_step": 0, "panel_contract": 0}
    assert torch.all(x == -2)
    # 1 - 0.5/x + 0.5/(1 - x) = 0 at x = 1 - sqrt(1/2)
    assert abs(root.item() - (1 - 0.5 ** 0.5)) < 1e-6


def test_reference_kernels_take_only_cuda_tensors():
    """The first B3 / B9 body is a reference for the card's before/after
    checks: it has no plain version to fall back on."""
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(ValueError):
        trailing_update.trailing_update_reference(x, torch.ones(1, 4, 2), torch.ones(1, 4, 2))
    with pytest.raises(ValueError):
        trailing_update.panel_contract_reference(torch.ones(1, 2, 4, 2), torch.ones(2, 2, 4),
                                                 trailing_update.TRTRI_LOWER_SUBSCRIPTS)
    assert torch.all(x == 0)


def test_b2_and_b4_reference_kernels_take_only_cuda_tensors():
    """B2's first body is the reference of the card's before/after checks:
    no plain version to fall back on, no count.  (B4 keeps no reference
    kernel: its select is held bit for bit to its plain version.)"""
    ops.reset_launch_counts()
    with pytest.raises(ValueError):
        panel_trsm.panel_trsm_reference(torch.eye(32), torch.ones(8, 32))
    assert sum(ops.launch_counts().values()) == 0


def test_wrappers_reject_other_devices_and_forms():
    meta = torch.empty(32, 32, device="meta")
    with pytest.raises(ValueError):
        potrf.potrf_tile(meta)
    with pytest.raises(ValueError):
        panel_trsm.panel_trsm_right_lower_t(meta, torch.empty(8, 32, device="meta"))
    with pytest.raises(ValueError):
        trailing_update.trailing_update(torch.zeros(1, 1, 2, 2), torch.zeros(1, 2, 2),
                                        torch.zeros(1, 2, 2), "ab,bc->ac")


@pytest.mark.parametrize("dtype", DTYPES)
def test_static_gates_match_jax(dtype):
    _, jnp = _jax()
    from dlaf_tpu.ops import pallas_panel_trsm, pallas_potrf

    for n in (8, 12, 32, 64):
        a = np.zeros((n, n), dtype)
        assert potrf.supported(torch.from_numpy(a)) == pallas_potrf.supported(jnp.asarray(a))
    for nb, rows in ((32, 64), (64, 12), (16, 16), (64, 8)):
        a, b = np.zeros((nb, nb), dtype), np.zeros((rows, nb), dtype)
        for op in (tile.TRANS, tile.CONJ_TRANS, tile.NO_TRANS):
            args = (tile.RIGHT, tile.LOWER, op, tile.NON_UNIT)
            assert (panel_trsm.supported(*args, torch.from_numpy(a), torch.from_numpy(b))
                    == pallas_panel_trsm.supported(*args, jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("panel", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_trsm_panel_routing(dtype, panel):
    """The Cholesky-panel trsm gives the same X with the panel kernel
    routed on (plain version here) and off (torch.linalg.solve_triangular)."""
    tp = get_tune_parameters()
    old = tp.panel_trsm_pallas
    ell = torch.from_numpy(_lower_factor(64, dtype, seed=7))
    b = torch.from_numpy(random_matrix(3 * 64, 64, dtype, seed=8)).reshape(3, 64, 64)
    try:
        tp.update(panel_trsm_pallas=panel)
        x = tile.trsm(tile.RIGHT, tile.LOWER, tile.CONJ_TRANS, tile.NON_UNIT, 1.0, ell, b)
    finally:
        tp.update(panel_trsm_pallas=old)
    assert x.shape == b.shape and x.is_contiguous()
    back = x @ ell.T
    assert _rel_err(back.numpy(), b.numpy()) <= tol_for(dtype, 64)


# --------------------------------------------------- CUDA kernels (card only)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_potrf_matches_plain(dtype):
    dev = _cuda()
    d = torch.from_numpy(random_hermitian_pd(200, np.float64, 9)).to(dev, dtype)
    before = potrf.launches
    got = potrf.potrf_tile(d)
    assert potrf.launches == before + 1
    ref = potrf.potrf_tile_plain(d)
    assert _rel_err(got.cpu().numpy(), ref.cpu().numpy()) <= tol_for(np.dtype(str(dtype)[6:]), 200)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(torch.float32, 512), (torch.float32, 200),
                                     (torch.float32, 40), (torch.float32, 24),
                                     (torch.float64, 352), (torch.float64, 96)])
def test_cuda_potrf_cluster_matches_one_block_bitwise(dtype, n):
    """The cluster kernel against the one-block kernel it replaced (whose
    body B7 and B8 run), bit for bit: every element sees the same
    operations in the same order; n = 40 and 24 end on a narrower panel."""
    dev = _cuda()
    d = torch.from_numpy(random_hermitian_pd(n, np.float64, n)).to(dev, dtype)
    d = torch.tril(d) + torch.triu(torch.full_like(d, 3.0), 1)  # the upper triangle is not read
    assert potrf.cluster_fits(d)
    before = (potrf.launches, potrf.cluster_launches)
    got = potrf.potrf_tile(d)
    ref = potrf.potrf_tile_one_block(d)
    torch.cuda.synchronize()
    assert (potrf.launches, potrf.cluster_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, ref)
    assert not torch.triu(got, 1).any()


@pytest.mark.cuda
def test_cuda_potrf_routes_large_f64_tiles_to_one_block():
    """A tile whose cluster does not fit the blocks' shared memory goes to
    the one-block kernel, statically, by shape and dtype."""
    dev = _cuda()
    d = torch.from_numpy(random_hermitian_pd(512, np.float64, 15)).to(dev)
    assert not potrf.cluster_fits(d)
    before = (potrf.launches, potrf.cluster_launches)
    got = potrf.potrf_tile(d)
    assert (potrf.launches, potrf.cluster_launches) == (before[0] + 1, before[1])
    assert torch.equal(got, potrf.potrf_tile_one_block(d))


@pytest.mark.cuda
def test_cuda_potrf_refuses_a_cluster_the_card_cannot_hold(monkeypatch):
    """A cluster larger than Hopper's largest (16 blocks) cannot launch: the
    wrapper raises, launches nothing and does not fall back to one block."""
    dev = _cuda()
    monkeypatch.setattr(potrf, "CLUSTER_BLOCKS", 32)
    d = torch.from_numpy(random_hermitian_pd(512, np.float64, 16)).to(dev, torch.float32)
    assert potrf.cluster_fits(d)
    before = (potrf.launches, potrf.cluster_launches)
    with pytest.raises(RuntimeError, match="cluster of 32 blocks"):
        potrf.potrf_tile(d)
    torch.cuda.synchronize()
    assert (potrf.launches, potrf.cluster_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_panel_trsm_matches_plain(dtype):
    dev = _cuda()
    ell = torch.from_numpy(_lower_factor(128, np.float64, 10)).to(dev, dtype)
    b = torch.from_numpy(random_matrix(200, 128, np.float64, 11)).to(dev, dtype)
    got = panel_trsm.panel_trsm_right_lower_t(ell, b)
    ref = panel_trsm.panel_trsm_plain(ell, b)
    assert _rel_err(got.cpu().numpy(), ref.cpu().numpy()) <= tol_for(np.dtype(str(dtype)[6:]), 128)


@pytest.mark.cuda
@pytest.mark.parametrize("tiny", [False, True], ids=["normal", "subnormal"])
@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb", [(200, 128), (40, 96), (1000, 160), (8, 32), (2056, 512),
                                  (520, 1024)])
def test_cuda_panel_trsm_matches_reference_bitwise(m, nb, dtype, off, tiny):
    """B2's Hopper body (``solve_rows``) gives its first body's bits: rows
    off every strip and warp size, 1 to 32 column blocks, every
    instantiation; at an offset of one element L's slabs take element
    copies.  And it is within tol_for of the plain version.  With ``tiny``
    L's diagonal is 98 and every other row of b is scaled below the
    smallest normal number, so some quotients (v - contrib) / 98 are ties
    between two subnormals (K * 2^-150, K odd) that the f32 body's product
    with RN64(1/98) misses (with 6 the product is always the tie, which
    then rounds to even as the division does); the normal rows are held to
    the plain version."""
    dev = _cuda()
    ell_np, b_np = _lower_factor(nb, dtype, nb + m), random_matrix(m, nb, dtype, seed=m)
    if tiny:
        np.fill_diagonal(ell_np, 98.0)
        b_np[1::2] *= np.ldexp(1.0, -133 if dtype == np.float32 else -1040)
    ell = torch.from_numpy(ell_np).to(dev)
    lo = torch.empty(nb * nb + off, dtype=ell.dtype, device=dev)[off:].view(nb, nb)
    lo.copy_(ell)
    b = torch.from_numpy(b_np).to(dev)
    before = panel_trsm.launches
    got = panel_trsm.panel_trsm_right_lower_t(lo, b)
    ref = panel_trsm.panel_trsm_reference(lo, b)
    torch.cuda.synchronize()
    assert panel_trsm.launches == before + 1
    words = torch.int32 if dtype == np.float32 else torch.int64
    assert torch.equal(got.view(words), ref.view(words))
    if tiny:
        assert ((got.abs() < torch.finfo(got.dtype).tiny) & (got != 0)).any()
    rows = slice(None, None, 2 if tiny else 1)
    plain = panel_trsm.panel_trsm_plain(ell, b)
    assert _rel_err(got[rows].cpu().numpy(), plain[rows].cpu().numpy()) <= tol_for(dtype, nb)


@pytest.mark.cuda
@pytest.mark.parametrize("subscripts", [trailing_update.CHOLESKY_SUBSCRIPTS,
                                        trailing_update.TRSM_SUBSCRIPTS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_trailing_update_matches_plain(dtype, subscripts):
    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(12)
    L, C, M, N, K = 3, 2, 70, 90, 40  # ragged against the 64 x 64 x 16 tiling
    x = torch.randn(L, C, M, N, generator=g, dtype=dtype)
    a = torch.randn(L, M, K, generator=g, dtype=dtype)
    bshape = (C, N, K) if subscripts == trailing_update.CHOLESKY_SUBSCRIPTS else (C, K, N)
    b = torch.randn(*bshape, generator=g, dtype=dtype)
    ref = trailing_update.trailing_update_plain(x.clone(), a, b, subscripts)
    got = trailing_update.trailing_update(x.to(dev), a.to(dev), b.to(dev), subscripts)
    assert _rel_err(got.cpu().numpy(), ref.numpy()) <= tol_for(np.dtype(str(dtype)[6:]), K)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("subscripts,shape", _b3_cases())
def test_cuda_trailing_update_matches_reference_bitwise(subscripts, shape, dtype):
    """B3's FMA body (csrc/fma_gemm.cuh) gives the first body's bits: every
    output one FMA chain in the same order, the zero-filled k tail included;
    and it is within tol_for of the plain version.  Also at an offset of one
    element (rows not 16-byte aligned: the element copies)."""
    dev = _cuda()
    x, a, b = (torch.from_numpy(v).to(dev) for v in _b3_operands(subscripts, shape, dtype))
    update = (trailing_update.trailing_update_plain(x.clone(), a, b, subscripts) - x).cpu()
    words = torch.int32 if dtype == np.float32 else torch.int64
    for off in (0, 1):
        ao = torch.empty(a.numel() + off, dtype=a.dtype, device=dev)[off:].view(a.shape)
        ao.copy_(a)
        before = trailing_update.launches
        got = trailing_update.trailing_update(x.clone(), ao, b, subscripts)
        ref = trailing_update.trailing_update_reference(x.clone(), ao, b, subscripts)
        torch.cuda.synchronize()
        assert trailing_update.launches == before + 1
        assert torch.equal(got.view(-1).view(words), ref.view(-1).view(words))
        assert _rel_err((got - x).cpu().numpy(), update.numpy()) <= tol_for(dtype, shape[4])


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _cuda()
    with pytest.raises(TypeError):
        potrf.potrf_tile(torch.eye(32, dtype=torch.complex64, device=dev))
    with pytest.raises(ValueError):
        potrf.potrf_tile(torch.eye(12, device=dev))
    with pytest.raises(ValueError):
        panel_trsm.panel_trsm_right_lower_t(torch.eye(32, device=dev), torch.ones(8, 32, device=dev).T)
    with pytest.raises(ValueError):
        trailing_update.trailing_update(torch.zeros(1, 1, 4, 4, device=dev),
                                        torch.zeros(1, 4, 2, device=dev),
                                        torch.zeros(1, 2, 4, device=dev))
