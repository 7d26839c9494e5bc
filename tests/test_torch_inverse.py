"""The port's triangular_inverse (``dlaf_tpu_torch/algorithms/inverse.py``)
and its panel contraction (B9, ``ops/trailing_update.panel_contract``).

On the CPU: B9's plain version against the JAX kernel in Pallas interpret
mode, both TRTRI forms, f32 and f64, and its signed zeros;
``triangular_inverse`` for L and U, non-unit and unit diagonal, on the 1x1
grid and on 2x2, 2x4 and 4x2 grids of rank threads, under the 'xla' and
'fused' trailing-update tiers, against the JAX package within
``tol_for(dtype, n)`` and 'fused' against 'xla' bitwise;
``inverse_from_cholesky_factor`` raising until ``multiplication.py`` is
ported.

On a card only (``-m cuda``, skipped here): B9 against its plain version,
and the fused tier's inverse on a 2x4 grid against 'xla'.  The JAX side is
imported inside the tests that use it:
``python -m pytest tests/test_torch_inverse.py --noconftest -m cuda``.
"""
import contextlib

import numpy as np
import pytest
import torch

import dlaf_tpu_torch as dtt
from dlaf_tpu_torch import ops, tune
from dlaf_tpu_torch.algorithms.inverse import inverse_from_cholesky_factor
from dlaf_tpu_torch.comm.grid import Grid
from dlaf_tpu_torch.ops import trailing_update as tu
from dlaf_tpu_torch.testing import random_hermitian_pd, tol_for

FORMS = [tu.TRTRI_LOWER_SUBSCRIPTS, tu.TRTRI_UPPER_SUBSCRIPTS]
SHAPES = [(1, 1), (2, 2), (2, 4), (4, 2)]


@contextlib.contextmanager
def knobs(**kw):
    tp = tune.get_tune_parameters()
    old = {k: getattr(tp, k) for k in kw}
    tp.update(**kw)
    try:
        yield
    finally:
        tp.update(**old)


def _rel_err(got, ref) -> float:
    wide = np.result_type(np.asarray(got).dtype, np.float64)  # complex stays complex
    got, ref = np.asarray(got, wide), np.asarray(ref, wide)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


def _operands(subscripts, dtype, seed, L=3, C=4, mb=8, M=None, N=None, K=None):
    """B9's operands: a [L, C, M, K], b [C, K, N] (lower form) or a [L, M, K],
    b [L, C, K, N] (upper form); M, N and K default to mb."""
    M, N, K = (mb if v is None else v for v in (M, N, K))
    rng = np.random.default_rng(seed)
    if subscripts == tu.TRTRI_LOWER_SUBSCRIPTS:
        big = rng.standard_normal((L, C, M, K)).astype(dtype)
        return big, rng.standard_normal((C, K, N)).astype(dtype)
    big = rng.standard_normal((L, C, K, N)).astype(dtype)
    return rng.standard_normal((L, M, K)).astype(dtype), big


#: B9's (L, C, M, N, K): the small case, then M and N off the CUDA body's 128
#: tile (192, 200) and K off (130) and on (128) its 16-deep k slice
B9_SHAPES = [(3, 4, 8, 8, 8), (2, 2, 192, 200, 130), (2, 1, 200, 192, 128)]


def _b9_cases():
    return [pytest.param(sub, shape, id=sub if i == 0 else f"{sub}-{'x'.join(map(str, shape))}")
            for sub in FORMS for i, shape in enumerate(B9_SHAPES)]


def _b9_operands(subscripts, shape, dtype, seed):
    L, C, M, N, K = shape
    return _operands(subscripts, dtype, seed, L=L, C=C, M=M, N=N, K=K)


# ------------------------------------------------------------------ B9


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("subscripts,shape", _b9_cases())
def test_panel_contract_plain_matches_pallas(subscripts, shape, dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from dlaf_tpu.ops import pallas_trailing_update as ptu

    a, b = _b9_operands(subscripts, shape, dtype, seed=61)
    ref = np.asarray(ptu.panel_contract(jnp.asarray(a), jnp.asarray(b), subscripts,
                                        interpret=True))
    out = tu.panel_contract(torch.from_numpy(a), torch.from_numpy(b), subscripts)
    assert out.shape == ref.shape and out.dtype == torch.from_numpy(a).dtype
    L, C, _, _, K = shape
    assert _rel_err(out.numpy(), ref) <= tol_for(dtype, max(L, C) * K)


def test_panel_contract_signed_zero():
    """``contract``, not ``0 - contract``: zero operands give +0.0, which the
    caller's negation turns into -0.0 exactly as the 'xla' tier's does."""
    for sub in FORMS:
        a, b = _operands(sub, np.float32, seed=1)
        out = tu.panel_contract(torch.zeros_like(torch.from_numpy(a)),
                                torch.zeros_like(torch.from_numpy(b)), sub)
        assert not torch.signbit(out).any()
        assert torch.signbit(-out).all()


def test_panel_contract_rejects_other_forms():
    with pytest.raises(ValueError):
        tu.panel_contract(torch.zeros(2, 2, 2), torch.zeros(2, 2, 2), "iab,jcb->ijac")


# --------------------------------------------------- triangular_inverse

_JAX_REF: dict = {}


def _factor(uplo, diag, n=60, dtype=np.float64):
    src = np.complex128 if np.dtype(dtype).kind == "c" else np.float64
    ell = np.linalg.cholesky(random_hermitian_pd(n, src, 79)).astype(dtype)
    f = ell if uplo == "L" else ell.T.copy()
    if diag == "U":
        np.fill_diagonal(f, 1.0)
    # the triangle not referenced holds garbage
    other = np.triu(np.full((n, n), 7.0, dtype), 1)
    return f + (other if uplo == "L" else other.T)


def _jax_inverse(comm_grids, grid_1x1, shape, uplo, diag, f):
    import dlaf_tpu as dt

    key = (shape, uplo, diag, f.dtype.str)
    if key not in _JAX_REF:
        jgrid = grid_1x1 if shape == (1, 1) else next(
            g for g in comm_grids if tuple(g.grid_size) == shape)
        m = dt.DistributedMatrix.from_global(jgrid, f, (8, 8))
        _JAX_REF[key] = dt.triangular_inverse(uplo, diag, m).to_global()
    return _JAX_REF[key]


@pytest.mark.parametrize("tier", ["xla", "fused"])
@pytest.mark.parametrize("shape,dtype", [pytest.param(s, np.float64, id=f"shape{i}")
                                         for i, s in enumerate(SHAPES)]
                         + [pytest.param((2, 4), np.complex64, id="shape2-complex64"),
                            pytest.param((4, 2), np.complex128, id="shape3-complex128")])
@pytest.mark.parametrize("diag", ["N", "U"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_triangular_inverse_matches_jax(comm_grids, grid_1x1, uplo, diag, shape, dtype, tier):
    """The inverse's ``uplo`` triangle within tol_for(dtype, n) of the JAX
    package's, the other triangle as the JAX package leaves it, 'fused'
    bitwise 'xla' (the JAX references in its default tier: its own tests
    hold fused == xla); f64 on every shape, c64 and c128 on one each."""
    pytest.importorskip("jax")
    n = 60
    f = _factor(uplo, diag, n, dtype)
    ref = _jax_inverse(comm_grids, grid_1x1, shape, uplo, diag, f)
    out = {}
    for impl in ("xla", tier):
        with knobs(trailing_update_impl=impl, collectives_impl="pallas"):
            m = dtt.DistributedMatrix.from_global(Grid.create(shape, device="cpu"), f, (8, 8))
            res = dtt.triangular_inverse(uplo, diag, m)
            assert res.data is m.data
            out[impl] = res.to_global()
    tri = np.tril if uplo == "L" else np.triu
    strict = (lambda v: np.triu(v, 1)) if uplo == "L" else (lambda v: np.tril(v, -1))
    np.testing.assert_array_equal(out[tier], out["xla"])
    # outside the diagonal tiles the other triangle is untouched; inside them
    # both packages write the inverted tile, zeros above (below) its diagonal
    np.testing.assert_array_equal(strict(out[tier]), strict(ref))
    assert _rel_err(tri(out[tier]), tri(ref)) <= tol_for(dtype, n)


def test_triangular_inverse_is_an_inverse():
    """On a 2x4 grid under 'fused', ragged (n = 61, nb = 8), f32: tril(X) L
    is the identity to tol_for(f32, n), and the check rejects X = L."""
    n = 61
    ell = np.linalg.cholesky(random_hermitian_pd(n, np.float64, 5)).astype(np.float32)
    with knobs(trailing_update_impl="fused", collectives_impl="pallas"):
        m = dtt.DistributedMatrix.from_global(Grid.create((2, 4), device="cpu"), ell, (8, 8))
        x = np.tril(dtt.triangular_inverse("L", "N", m).to_global()).astype(np.float64)

    def resid(inv):
        return np.linalg.norm(inv @ ell - np.eye(n)) / (np.linalg.norm(inv) * np.linalg.norm(ell))

    assert resid(x) <= tol_for(np.float32, n) < resid(ell.astype(np.float64))


def test_cpu_inverse_launches_nothing():
    ops.reset_launch_counts()
    with knobs(trailing_update_impl="fused"):
        m = dtt.DistributedMatrix.from_global(Grid.create((2, 2), device="cpu"),
                                              np.eye(32) * 2, (8, 8))
        out = dtt.triangular_inverse("L", "N", m).to_global()
    np.testing.assert_array_equal(np.tril(out), np.eye(32) / 2)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("shape", [(1, 1), (2, 4)])
def test_inverse_from_cholesky_factor_raises(shape):
    """POTRI runs (the identity's inverse is the identity, in a new matrix;
    the factor is inverted in place on the way, as in the JAX package) and
    raises only on what TRTRI refuses: a matrix that is not square."""
    m = dtt.DistributedMatrix.from_global(Grid.create(shape, device="cpu"), np.eye(16), (8, 8))
    out = inverse_from_cholesky_factor("L", m)
    assert out.data is not m.data
    np.testing.assert_array_equal(out.to_global(), np.eye(16))
    np.testing.assert_array_equal(m.to_global(), np.eye(16))
    rect = dtt.DistributedMatrix.from_global(Grid.create(shape, device="cpu"), np.ones((16, 8)),
                                             (8, 8))
    with pytest.raises(ValueError, match="square"):
        inverse_from_cholesky_factor("L", rect)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_triangular_inverse_split_tier_fused_matches_xla_and_jax(comm_grids, grid_1x1, uplo):
    """Under gemm_precision='bf16x3' on a 2x4 grid: 'fused' (B9's plain
    version at the tier) bitwise 'xla', and within tol_for(f32, n) of the
    JAX package's fused tier at bf16x3 (f32: both are float32 class)."""
    pytest.importorskip("jax")
    import dlaf_tpu as dt

    n = 60
    f = _factor(uplo, "N", n, np.float32)
    jgrid = next(g for g in comm_grids if tuple(g.grid_size) == (2, 4))
    from dlaf_tpu import tune as jtune

    jp = jtune.get_tune_parameters()
    jold = {k: getattr(jp, k) for k in ("gemm_precision", "trailing_update_impl")}
    try:
        jp.update(gemm_precision="bf16x3", trailing_update_impl="fused")
        ref = dt.triangular_inverse(uplo, "N", dt.DistributedMatrix.from_global(jgrid, f, (8, 8)))
        ref = ref.to_global()
    finally:
        jp.update(**jold)
    out = {}
    for impl in ("xla", "fused"):
        with knobs(gemm_precision="bf16x3", trailing_update_impl=impl, collectives_impl="pallas"):
            m = dtt.DistributedMatrix.from_global(Grid.create((2, 4), device="cpu"), f, (8, 8))
            out[impl] = dtt.triangular_inverse(uplo, "N", m).to_global()
    tri = np.tril if uplo == "L" else np.triu
    np.testing.assert_array_equal(out["fused"], out["xla"])
    assert _rel_err(tri(out["fused"]), tri(ref)) <= tol_for(np.float32, n)


# ------------------------------------------------------------ card only


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("subscripts", FORMS)
def test_cuda_panel_contract_matches_plain(subscripts, dtype):
    dev = _cuda()
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    a, b = (torch.from_numpy(v) for v in _operands(subscripts, np_dtype, seed=3, L=5, C=3, mb=72))
    ref = tu.panel_contract_plain(a, b, subscripts)
    before = tu.contract_launches
    got = tu.panel_contract(a.to(dev), b.to(dev), subscripts)
    torch.cuda.synchronize()
    assert tu.contract_launches == before + 1
    assert _rel_err(got.cpu().numpy(), ref.numpy()) <= tol_for(np_dtype, 5 * 72)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("subscripts,shape", _b9_cases())
def test_cuda_panel_contract_matches_reference_bitwise(subscripts, shape, dtype):
    """B9's FMA body (csrc/fma_gemm.cuh) gives the first body's bits, signed
    zeros included, and is within tol_for of the plain version; also with
    b at an offset of one element (rows not 16-byte aligned)."""
    dev = _cuda()
    a, b = (torch.from_numpy(v).to(dev) for v in _b9_operands(subscripts, shape, dtype, seed=5))
    plain = tu.panel_contract_plain(a, b, subscripts)
    words = torch.int32 if dtype == np.float32 else torch.int64
    L, C, _, _, K = shape
    for off in (0, 1):
        bo = torch.empty(b.numel() + off, dtype=b.dtype, device=dev)[off:].view(b.shape)
        bo.copy_(b)
        before = tu.contract_launches
        got = tu.panel_contract(a, bo, subscripts)
        ref = tu.panel_contract_reference(a, bo, subscripts)
        torch.cuda.synchronize()
        assert tu.contract_launches == before + 1
        assert torch.equal(got.view(-1).view(words), ref.view(-1).view(words))
        assert _rel_err(got.cpu().numpy(), plain.cpu().numpy()) <= tol_for(dtype, max(L, C) * K)
    zero = tu.panel_contract(torch.zeros_like(a), torch.zeros_like(b), subscripts)
    assert not torch.signbit(zero).any()


@pytest.mark.cuda
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_cuda_triangular_inverse_fused_matches_xla(uplo):
    """On a 2x4 grid of the card: 'fused' launches B9 once per step and
    rank, and its inverse is the 'xla' tier's within tol_for(f32, n)."""
    dev = _cuda()
    n, nb = 1280, 128
    f = torch.from_numpy(_factor(uplo, "N", n, np.float32)).to(dev)
    out = {}
    for impl in ("xla", "fused"):
        with knobs(trailing_update_impl=impl, collectives_impl="pallas"):
            ops.reset_launch_counts()
            m = dtt.DistributedMatrix.from_global(Grid.create((2, 4), device=dev), f.clone(),
                                                  (nb, nb))
            out[impl] = (dtt.triangular_inverse(uplo, "N", m).to_global(), ops.launch_counts())
    tri = np.tril if uplo == "L" else np.triu
    assert _rel_err(tri(out["fused"][0]), tri(out["xla"][0])) <= tol_for(np.float32, n)
    assert out["fused"][1]["panel_contract"] == 8 * (n // nb)
    assert out["xla"][1]["panel_contract"] == 0
    assert out["fused"][1]["trailing_update"] == 0
