"""The split-GEMM tiers of the port (``tune.gemm_precision`` 'bf16x3',
'bf16x6', 'auto'): ``ops.tile.contract`` against the JAX package's, the
plain versions of B3 and B9 at every tier, the ambient
``gemm_precision_scope`` in the rank threads of a grid, and, on a card
only, B3's and B9's split-tier kernels against their plain versions.

Tolerances, from a probe at k = 128 on the CPU:

- bf16x3 on f32 operands: the port is 1.5e-5 from the JAX package
  (absolute; both add exact bf16 products in float32, in different orders)
  where the split is 3.2e-4 from the 'default' product.  So the port must
  be within ``tol_for(f32, k)`` of the JAX split, and at least 5 times
  closer to it than to the JAX 'default' product.
- bf16x6: the port is 9.5e-6 from the JAX package on f64 operands, where
  the split is 5.0e-6 from the f64 'default' product: both are float32
  class (each product accumulates in float32), so the port must be within
  ``tol_for(f32, k)`` of the JAX split, and, on 64-bit operands, more than
  1e-10 from the 'default' product (far above f64 rounding: a split that
  quietly ran the 'default' tier fails here).

The CUDA tests (``-m cuda``, skipped without a card) import no JAX:
``python -m pytest tests/test_torch_split.py --noconftest -m cuda``.
"""
import threading

import numpy as np
import pytest
import torch

from dlaf_tpu_torch import tune
from dlaf_tpu_torch.comm import _ranks
from dlaf_tpu_torch.comm.grid import Grid
from dlaf_tpu_torch.health import ConfigurationError
from dlaf_tpu_torch.ops import tile
from dlaf_tpu_torch.ops import trailing_update as tu
from dlaf_tpu_torch.testing import random_matrix, tol_for

TIERS = ["default", "bf16x3", "bf16x6"]
# (subscripts, a shape, b shape) of B3's two forms and B9's two forms
FORMS = {
    "b3_cholesky": (tu.CHOLESKY_SUBSCRIPTS, (3, 16, 24), (2, 8, 24)),
    "b3_trsm": (tu.TRSM_SUBSCRIPTS, (3, 16, 24), (2, 24, 8)),
    "b9_lower": (tu.TRTRI_LOWER_SUBSCRIPTS, (3, 2, 16, 24), (2, 24, 8)),
    "b9_upper": (tu.TRTRI_UPPER_SUBSCRIPTS, (3, 16, 24), (3, 2, 24, 8)),
}


def _rel_err(got, ref) -> float:
    wide = np.result_type(np.asarray(got).dtype, np.float64)
    got, ref = np.asarray(got, wide), np.asarray(ref, wide)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0))


def _operands(shape_a, shape_b, dtype, seed):
    a = random_matrix(int(np.prod(shape_a[:-1])), shape_a[-1], dtype, seed).reshape(shape_a)
    b = random_matrix(int(np.prod(shape_b[:-1])), shape_b[-1], dtype, seed + 1).reshape(shape_b)
    return a, b


# ------------------------------------------------------------------ the knob


def test_gemm_precision_accepts_the_tiers_and_rejects_the_rest():
    p = tune.TuneParameters()
    for tier in tune.GEMM_PRECISIONS:
        p.update(gemm_precision=tier)
        assert p.gemm_precision == tier
    for bad in ("bf16", "tf32", None):
        with pytest.raises(ConfigurationError, match="gemm_precision"):
            p.update(gemm_precision=bad)
    with pytest.raises(ConfigurationError):
        with tune.gemm_precision_scope("bf16"):
            pass


def test_scope_overrides_the_knob_and_nests():
    tp = tune.get_tune_parameters()
    old = tp.gemm_precision
    try:
        tp.update(gemm_precision="bf16x3")
        assert tune.resolved_gemm_precision() == "bf16x3"
        with tune.gemm_precision_scope("default"):
            assert tune.resolved_gemm_precision() == "default"
            with tune.gemm_precision_scope("bf16x6"):
                assert tune.resolved_gemm_precision() == "bf16x6"
            assert tune.resolved_gemm_precision() == "default"
        assert tune.resolved_gemm_precision() == "bf16x3"
    finally:
        tp.update(gemm_precision=old)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_scope_reaches_every_rank_thread(shape):
    """Each rank thread of a grid sees the caller's gemm_precision_scope
    (a new thread starts in an empty context; ``spmd`` copies the
    caller's), and its contractions are counted under its name and tier."""
    tp = tune.get_tune_parameters()
    old = tp.gemm_precision
    grid = Grid.create(shape, device="cpu")
    stack = torch.zeros(shape + (1,))
    seen = {}

    def body(_):
        ctx = _ranks.current()
        seen[(ctx.myr, ctx.myc)] = tune.resolved_gemm_precision()
        tile.contract("ab,bc->ac", torch.ones(4, 4), torch.ones(4, 4))

    try:
        tp.update(gemm_precision="bf16x3")
        for scope in ("default", "bf16x6", None):
            seen.clear()
            tile.contract_counts.clear()
            if scope is None:
                _ranks.spmd(grid, body, stack)
            else:
                with tune.gemm_precision_scope(scope):
                    _ranks.spmd(grid, body, stack)
            want = "bf16x3" if scope is None else scope
            assert seen == {(r, c): want for r in range(shape[0]) for c in range(shape[1])}
            ranks = {f"dlaf-rank-{r}-{c}" for r in range(shape[0]) for c in range(shape[1])}
            assert tile.contract_counts == {(name, want): 1 for name in ranks}
    finally:
        tp.update(gemm_precision=old)
        tile.contract_counts.clear()


def test_contract_counts_lose_no_update_under_thread_switches():
    """Eight rank threads counting 200 contractions each, with the
    interpreter switching threads every microsecond: no update is lost."""
    import sys

    grid = Grid.create((2, 4), device="cpu")
    one = torch.ones(1, 1)

    def body(_):
        for _ in range(200):
            tile.contract("ab,bc->ac", one, one, "default")

    old = sys.getswitchinterval()
    tile.contract_counts.clear()
    try:
        sys.setswitchinterval(1e-6)
        _ranks.spmd(grid, body, torch.zeros(2, 4, 1))
    finally:
        sys.setswitchinterval(old)
    assert tile.contract_counts == {(f"dlaf-rank-{r}-{c}", "default"): 200
                                    for r in range(2) for c in range(4)}
    tile.contract_counts.clear()


# ------------------------------------------------- contract against the JAX package


@pytest.mark.parametrize("tier", ["bf16x3", "bf16x6", "auto"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_contract_matches_jax(dtype, tier):
    pytest.importorskip("jax")
    from dlaf_tpu.ops import tile as jtile

    k = 128
    sub = tu.CHOLESKY_SUBSCRIPTS
    a, b = _operands((3, 16, k), (2, 12, k), dtype, seed=21)
    ref = np.asarray(jtile.contract(sub, a, b, tier=tier))
    ref_default = np.asarray(jtile.contract(sub, a, b, tier="default"))
    got = tile.contract(sub, torch.from_numpy(a), torch.from_numpy(b), tier=tier).numpy()
    assert got.dtype == ref.dtype == np.dtype(dtype)
    real = np.float32 if np.dtype(dtype) in (np.float32, np.complex64) else np.float64
    if tier == "auto":  # CPU tensors keep 'default', as the JAX package does on its CPU
        np.testing.assert_array_equal(
            got, torch.einsum(sub, torch.from_numpy(a), torch.from_numpy(b)).numpy())
        assert _rel_err(got, ref) <= tol_for(real, k)
        return
    err = _rel_err(got, ref)
    assert err <= tol_for(np.float32, k)
    if tier == "bf16x3":
        assert 5 * err <= _rel_err(got, ref_default)
    elif real == np.float64:
        assert _rel_err(got, ref_default) > 1e-10


def test_split_terms_are_the_jax_order():
    assert tile.split_terms(2) == [(0, 1), (1, 0), (0, 0)]
    assert tile.split_terms(3) == [(0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0)]


def test_slices_capture_the_mantissa():
    x = torch.from_numpy(random_matrix(64, 64, np.float64, 3))
    for nslices, bits in ((1, 8), (2, 16), (3, 24)):
        s = tile._bf16_slices(x, nslices)
        assert all(v.dtype == torch.bfloat16 for v in s)
        back = sum(v.double() for v in s)
        assert float((back - x).abs().max() / x.abs().max()) <= 2.0 ** -bits


def test_integer_and_narrow_operands_are_never_split():
    a16 = torch.ones(4, 4, dtype=torch.float16)
    ai = torch.ones(4, 4, dtype=torch.int64)
    tile.contract_counts.clear()
    for tier in ("bf16x3", "bf16x6"):
        assert tile.resolve_tier("ab,bc->ac", a16, a16, tier) == "default"
        assert tile.resolve_tier("ab,bc->ac", ai, ai, tier) == "default"
        assert torch.equal(tile.contract("ab,bc->ac", ai, ai, tier), ai @ ai)
    assert set(tile.contract_counts) == {(threading.current_thread().name, "default")}
    tile.contract_counts.clear()


def test_auto_resolves_by_device_and_extent():
    cpu = torch.zeros(2, 8, 1024)
    meta = torch.zeros(2, 8, 1024, device="meta")
    assert tile.resolve_tier(tu.CHOLESKY_SUBSCRIPTS, cpu, cpu, "auto") == "default"
    assert tile.resolve_tier(tu.CHOLESKY_SUBSCRIPTS, meta, meta, "auto") == "default"
    assert tile.contracted_extent(tu.CHOLESKY_SUBSCRIPTS, cpu, cpu) == 1024
    assert tile.contracted_extent(tu.TRTRI_LOWER_SUBSCRIPTS, torch.zeros(3, 2, 8, 40),
                                  torch.zeros(2, 40, 8)) == 80


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("op", ["trmm", "gemm", "herk", "hemm", "lange_max", "laset"])
def test_tile_blas_matches_jax(op, dtype):
    """The tile BLAS wrappers over ``contract`` (trmm, gemm, herk, hemm) and
    lange_max / laset against the JAX package's, on tile stacks."""
    pytest.importorskip("jax")
    from dlaf_tpu.ops import tile as jtile

    a, b = _operands((2, 6, 6), (2, 6, 6), dtype, seed=31)
    c = _operands((2, 6, 6), (1, 1), dtype, seed=33)[0]
    args = {"trmm": ("Left", "L", "C", "U", 0.5, a, b), "gemm": ("T", "N", 1.5, a, b, -0.5, c),
            "herk": ("L", "C", 2.0, a, 0.25, c), "hemm": ("Right", "L", 1.25, a, b, 0.5, c),
            "lange_max": (a,), "laset": ((3, 5), 0.5, 2.0, np.dtype(dtype))}[op]
    ref = np.asarray(getattr(jtile, op)(*args))
    targs = tuple(torch.from_numpy(v) if isinstance(v, np.ndarray) else v for v in args)
    if op == "laset":
        targs = targs[:3] + (torch.from_numpy(np.zeros((), dtype)).dtype,)
    got = getattr(tile, op)(*targs).numpy()
    assert got.shape == ref.shape
    assert _rel_err(got, ref) <= tol_for(dtype, 6)


# ---------------------------------------------------- B3 and B9, plain versions


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("form", list(FORMS))
def test_plain_versions_are_contract_at_the_tier(form, tier, dtype):
    """B3's and B9's plain versions are ``tile.contract`` at the same tier,
    bit for bit (what keeps the CPU's 'fused' tier on the 'xla' tier's
    bits), with ``tier=None`` read from the knob."""
    sub, sa, sb = FORMS[form]
    a, b = (torch.from_numpy(v) for v in _operands(sa, sb, dtype, seed=5))
    want = tile.contract(sub, a, b, tier=tier)
    tp = tune.get_tune_parameters()
    old = tp.gemm_precision
    try:
        tp.update(gemm_precision=tier)
        if form.startswith("b9"):
            got = [tu.panel_contract(a, b, sub), tu.panel_contract(a, b, sub, tier=tier),
                   tu.panel_contract_plain(a, b, sub, tier)]
        else:
            x0 = torch.from_numpy(random_matrix(3 * 2 * 16, 8, dtype, 9)).reshape(3, 2, 16, 8)
            want = x0 - want
            got = [tu.trailing_update(x0.clone(), a, b, sub),
                   tu.trailing_update(x0.clone(), a, b, sub, tier=tier),
                   tu.trailing_update_plain(x0.clone(), a, b, sub, tier)]
    finally:
        tp.update(gemm_precision=old)
    for g in got:
        assert torch.equal(g, want)


@pytest.mark.parametrize("tier", ["bf16x3", "bf16x6"])
@pytest.mark.parametrize("form", ["b3_cholesky", "b3_trsm", "b9_lower", "b9_upper"])
def test_plain_versions_match_pallas_interpret(form, tier):
    """The port's B3 and B9 at a split tier against the JAX package's Pallas
    kernels in interpret mode at the same tier, f32, within tol_for(f32, K)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from dlaf_tpu.ops import pallas_trailing_update as ptu

    sub, sa, sb = FORMS[form]
    a, b = _operands(sa, sb, np.float32, seed=11)
    k = sa[-1]
    if form.startswith("b9"):
        ref = np.asarray(ptu.panel_contract(jnp.asarray(a), jnp.asarray(b), sub, interpret=True,
                                            tier=tier))
        got = tu.panel_contract(torch.from_numpy(a), torch.from_numpy(b), sub, tier=tier).numpy()
    else:
        x = random_matrix(3 * 2 * 16, 8, np.float32, 12).reshape(3, 2, 16, 8)
        ref = np.asarray(ptu.trailing_update(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), sub,
                                             interpret=True, tier=tier))
        got = tu.trailing_update(torch.from_numpy(x.copy()), torch.from_numpy(a),
                                 torch.from_numpy(b), sub, tier=tier).numpy()
    assert _rel_err(got, ref) <= tol_for(np.float32, k)


# --------------------------------------------------------------- card only


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _split_case(form, dtype, dev, seed):
    """Operands of ragged shapes against the 64 x 64 x 32 tiling (K = 40)."""
    g = torch.Generator().manual_seed(seed)
    L, C, M, N, K = 3, 2, 70, 90, 40
    shapes = {"b3_cholesky": ((L, M, K), (C, N, K)), "b3_trsm": ((L, M, K), (C, K, N)),
              "b9_lower": ((L, C, M, K), (C, K, N)), "b9_upper": ((L, M, K), (L, C, K, N))}
    sa, sb = shapes[form]
    a = torch.randn(*sa, generator=g, dtype=dtype).to(dev)
    b = torch.randn(*sb, generator=g, dtype=dtype).to(dev)
    x = torch.randn(L, C, M, N, generator=g, dtype=dtype).to(dev)
    return x, a, b, K


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tier", [(torch.float32, "bf16x3"), (torch.float32, "bf16x6"),
                                        (torch.float64, "bf16x3"), (torch.float64, "bf16x6")])
@pytest.mark.parametrize("form", list(FORMS))
def test_cuda_split_kernels_match_plain(form, dtype, tier):
    """B3 and B9 under a split tier against their plain versions on the card
    (``tile.contract`` at the tier): within tol_for(f32, K), and really
    split: at bf16x3 on f32 at least 5 times closer to the plain split than
    to the 'default' product, at bf16x6 on f64 more than 1e-10 from it."""
    dev = _cuda()
    x, a, b, K = _split_case(form, dtype, dev, 17)
    sub = FORMS[form][0]
    if form.startswith("b9"):
        before = (tu.contract_launches, tu.split_contract_launches)
        got = tu.panel_contract(a, b, sub, tier=tier)
        torch.cuda.synchronize()
        assert (tu.contract_launches, tu.split_contract_launches) == (before[0] + 1,
                                                                      before[1] + 1)
        plain = tu.panel_contract_plain(a, b, sub, tier)
        default = tu.panel_contract_plain(a, b, sub, "default")
    else:
        before = (tu.launches, tu.split_launches)
        got = tu.trailing_update(x.clone(), a, b, sub, tier=tier) - x
        torch.cuda.synchronize()
        assert (tu.launches, tu.split_launches) == (before[0] + 1, before[1] + 1)
        plain = tu.trailing_update_plain(x.clone(), a, b, sub, tier) - x
        default = tu.trailing_update_plain(x.clone(), a, b, sub, "default") - x
    got, plain, default = (v.cpu().numpy() for v in (got, plain, default))
    assert np.isfinite(got).all()
    err = _rel_err(got, plain)
    assert err <= tol_for(np.float32, K)
    if (dtype, tier) == (torch.float32, "bf16x3"):
        assert 5 * err <= _rel_err(got, default)
    if (dtype, tier) == (torch.float64, "bf16x6"):
        assert _rel_err(got, default) > 1e-10


@pytest.mark.cuda
def test_cuda_auto_splits_by_extent_and_width():
    dev = _cuda()
    for k, dtype, want in ((512, torch.float32, "bf16x3"), (512, torch.float64, "bf16x6"),
                           (256, torch.float32, "default")):
        a = torch.zeros(2, 8, k, device=dev, dtype=dtype)
        assert tile.resolve_tier(tu.CHOLESKY_SUBSCRIPTS, a, a, "auto") == want
    x = torch.zeros(2, 2, 8, 8, device=dev)
    a = torch.randn(2, 8, 512, device=dev)
    before = tu.split_launches
    tu.trailing_update(x, a, a.clone(), tu.CHOLESKY_SUBSCRIPTS, tier="auto")
    assert tu.split_launches == before + 1


def _split_and_plain(form, x, a, b, tier):
    """B3-split's applied update (or B9-split's output) and its plain
    version's, on the card."""
    sub = FORMS[form][0]
    if form.startswith("b9"):
        return (tu.panel_contract(a, b, sub, tier=tier),
                tu.panel_contract_plain(a, b, sub, tier))
    return (tu.trailing_update(x.clone(), a, b, sub, tier=tier) - x,
            tu.trailing_update_plain(x.clone(), a, b, sub, tier) - x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tier", [(torch.float32, "bf16x3"), (torch.float32, "bf16x6"),
                                        (torch.float64, "bf16x3"), (torch.float64, "bf16x6")])
@pytest.mark.parametrize("form", list(FORMS))
def test_cuda_split_kernels_deep_k(form, dtype, tier):
    """B3 and B9 under a split tier at K = 1000: many more 32-deep stages
    than the body's ring holds, and a last stage half past K (zero-filled
    planes), within tol_for(f32, K) of the plain split."""
    dev = _cuda()
    g = torch.Generator().manual_seed(23)
    L, C, M, N, K = 2, 2, 70, 90, 1000
    shapes = {"b3_cholesky": ((L, M, K), (C, N, K)), "b3_trsm": ((L, M, K), (C, K, N)),
              "b9_lower": ((L, C, M, K), (C, K, N)), "b9_upper": ((L, M, K), (L, C, K, N))}
    sa, sb = shapes[form]
    a, b, x = (torch.randn(*s, generator=g, dtype=dtype).to(dev)
               for s in (sa, sb, (L, C, M, N)))
    got, plain = _split_and_plain(form, x, a, b, tier)
    torch.cuda.synchronize()
    got, plain = got.cpu().numpy(), plain.cpu().numpy()
    assert np.isfinite(got).all()
    assert _rel_err(got, plain) <= tol_for(np.float32, K)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["bf16x3", "bf16x6"])
@pytest.mark.parametrize("form", ["b9_lower", "b9_upper"])
def test_cuda_b9_split_nine_slots(form, tier):
    """B9-split summing over 9 slots of K = 40 (two stages each: 18 slices,
    not a multiple of the body's 4 stages), within tol_for(f32, K) of the
    plain split."""
    dev = _cuda()
    g = torch.Generator().manual_seed(29)
    S, M, N, K = 9, 70, 90, 40
    sa, sb = ((3, S, M, K), (S, K, N)) if form == "b9_lower" else ((S, M, K), (S, 3, K, N))
    a, b = (torch.randn(*s, generator=g).to(dev) for s in (sa, sb))
    got, plain = _split_and_plain(form, None, a, b, tier)
    torch.cuda.synchronize()
    got, plain = got.cpu().numpy(), plain.cpu().numpy()
    assert np.isfinite(got).all()
    assert _rel_err(got, plain) <= tol_for(np.float32, K)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tier", [(torch.float32, "bf16x3"), (torch.float32, "bf16x6"),
                                        (torch.float64, "bf16x3"), (torch.float64, "bf16x6")])
def test_cuda_b9_split_is_one_chain_over_the_slots(dtype, tier):
    """With K a multiple of 32, B9-split's 'ijab,jbc->iac' sums each output
    in one chain over the slots in order, k ascending within each: bit for
    bit B3-split 'iab,jbc->ijac' of zero with the slots laid end to end
    along the depth (negated).  A misordered slot loop fails here."""
    dev = _cuda()
    g = torch.Generator().manual_seed(31)
    L, C, M, N, K = 2, 3, 70, 90, 64
    a = torch.randn(L, C, M, K, generator=g, dtype=dtype).to(dev)
    b = torch.randn(C, K, N, generator=g, dtype=dtype).to(dev)
    got = tu.panel_contract(a, b, tu.TRTRI_LOWER_SUBSCRIPTS, tier=tier)
    a_cat = a.permute(0, 2, 1, 3).reshape(L, M, C * K).contiguous()
    b_cat = b.reshape(1, C * K, N).contiguous()
    x = torch.zeros(L, 1, M, N, dtype=dtype, device=dev)
    tu.trailing_update(x, a_cat, b_cat, tu.TRSM_SUBSCRIPTS, tier=tier)
    torch.cuda.synchronize()
    assert torch.equal(got, -x[:, 0])
