"""The port stands alone: no module of dlaf_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package; importing the port leaves
JAX unloaded; the card is the default device; multi-rank grids run the
factorizations, POTRI and sub-matrix copies; and the tune knobs keep the JAX package's names,
environment and domains."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import dlaf_tpu_torch as dtt
from dlaf_tpu_torch import tune
from dlaf_tpu_torch.health import ConfigurationError

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "dlaf_tpu")


def _port_sources():
    return sorted((ROOT / "dlaf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_port_module_imports_jax_or_the_jax_package():
    srcs = _port_sources()
    assert len(srcs) > 10
    for mod in ("algorithms/inverse.py", "ops/trailing_update.py", "ops/panel_exchange.py",
                "algorithms/eig_refine.py", "algorithms/permutations.py", "algorithms/_origin.py",
                "matrix/ref.py", "matrix/window.py"):
        assert ROOT / "dlaf_tpu_torch" / mod in srcs
    bad = [(str(p.relative_to(ROOT)), m) for p in srcs for m in _imported_roots(p)
           if m in FORBIDDEN]
    assert bad == []


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys, dlaf_tpu_torch, dlaf_tpu_torch.ops.tile; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dlaf_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_grid_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dtt.Grid.create()
    g = dtt.Grid.create(device="cpu")
    assert g.device == torch.device("cpu") and tuple(g.grid_size) == (1, 1)


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1)])
def test_multi_rank_grids_wait_for_the_next_slice(shape):
    """Multi-rank grids are rank threads, and the lookahead kernel's fused
    trailing-update tier runs on them (the 'xla' tier's bits on the CPU),
    as do POTRI (``inverse_from_cholesky_factor``) and ``sub_matrix`` at an
    origin off the tile grid, a copy of the window in the layout of its own
    distribution (the HEEV stages' multi-rank code, which cuts the D&C's
    padded eigenvectors to size with it)."""
    from dlaf_tpu_torch.algorithms.inverse import inverse_from_cholesky_factor
    from dlaf_tpu_torch.matrix.util import sub_matrix

    grid = dtt.Grid.create(shape, device="cpu")
    assert tuple(grid.grid_size) == shape
    a = np.eye(16) * 4 + np.tril(np.full((16, 16), 0.5), -1)
    tp = tune.get_tune_parameters()
    old = {k: getattr(tp, k) for k in ("cholesky_lookahead", "trailing_update_impl")}
    out = {}
    try:
        for impl in ("xla", "fused"):
            tp.update(cholesky_lookahead=True, trailing_update_impl=impl)
            mat = dtt.DistributedMatrix.from_global(grid, a, (4, 4))
            out[impl] = dtt.cholesky_factorization("L", mat).to_stacked()
    finally:
        tp.update(**old)
    np.testing.assert_array_equal(out["fused"], out["xla"])
    ell = np.tril(a)
    inv = inverse_from_cholesky_factor("L", dtt.DistributedMatrix.from_global(grid, ell, (4, 4)))
    np.testing.assert_allclose(inv.to_global() @ (ell @ ell.T), np.eye(16), atol=1e-10)
    sub = sub_matrix(dtt.DistributedMatrix.from_global(grid, a, (4, 4)), (3, 5), (9, 10))
    np.testing.assert_array_equal(sub.to_global(), a[3:12, 5:15])
    np.testing.assert_array_equal(
        sub.to_stacked(), dtt.DistributedMatrix.from_global(grid, a[3:12, 5:15], (4, 4)).to_stacked())


def test_tune_env_names_precedence_and_domains(monkeypatch):
    monkeypatch.setenv("DLAF_TPU_PANEL_TRSM_PALLAS", "1")
    monkeypatch.setenv("DLAF_TPU_TRAILING_UPDATE_IMPL", "fused")
    monkeypatch.setenv("DLAF_TPU_BUCKET_SEGMENT_RATIO", "2.0")
    p = tune.TuneParameters()
    assert p.panel_trsm_pallas and p.trailing_update_impl == "fused"
    assert p.bucket_segment_ratio == 2.0 and not p.cholesky_lookahead
    p.update(panel_trsm_pallas=False)  # explicit update beats the environment
    assert not p.panel_trsm_pallas
    with pytest.raises(ConfigurationError):
        p.update(trailing_update_impl="pallas")
    with pytest.raises(ConfigurationError, match="gemm_precision"):
        p.update(gemm_precision="bf16")
    with pytest.raises(ValueError):
        p.update(no_such_knob=1)


def test_auto_trailing_update_tier_resolves_to_xla():
    tp = tune.get_tune_parameters()
    old = tp.trailing_update_impl
    try:
        tp.update(trailing_update_impl="auto")
        assert tune.trailing_update_tier() == "xla"
        tp.update(trailing_update_impl="fused")
        assert tune.trailing_update_tier() == "fused"
    finally:
        tp.update(trailing_update_impl=old)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, or on a machine without a card, the smoke
    script exits non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    scripts = [lone] if torch.cuda.is_available() else [lone, ROOT / "chip_smoke.py"]
    for script in scripts:
        proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                              timeout=120, cwd=tmp_path)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_host_chase_source_is_the_jax_packages_copy():
    """The port builds its own copy of the chase; it must stay the JAX
    package's C++ (plain C++, no framework), byte for byte."""
    mine = ROOT / "dlaf_tpu_torch" / "csrc" / "host" / "band2trid.cpp"
    theirs = ROOT / "dlaf_tpu" / "native" / "band2trid.cpp"
    assert mine.read_bytes() == theirs.read_bytes()


def test_importing_the_port_builds_nothing():
    """The CUDA kernels and the host chase build at first use, never at
    import: importing every module leaves the build directory alone."""
    code = ("import pathlib, sys, importlib; root = pathlib.Path(sys.argv[1]); "
            "before = sorted((root / 'dlaf_tpu_torch' / '_build').glob('*')) "
            "if (root / 'dlaf_tpu_torch' / '_build').exists() else []; "
            "[importlib.import_module('dlaf_tpu_torch.' + '.'.join(p.relative_to(root / 'dlaf_tpu_torch')"
            ".with_suffix('').parts)) for p in (root / 'dlaf_tpu_torch').rglob('*.py') "
            "if p.name != '__init__.py']; "
            "after = sorted((root / 'dlaf_tpu_torch' / '_build').glob('*')) "
            "if (root / 'dlaf_tpu_torch' / '_build').exists() else []; "
            "sys.exit(0 if before == after else 1)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_eigensolver_knobs_env_and_domains(monkeypatch):
    monkeypatch.setenv("DLAF_TPU_DC_SECULAR_PALLAS", "1")
    monkeypatch.setenv("DLAF_TPU_DC_LEAF_SIZE", "64")
    monkeypatch.setenv("DLAF_TPU_BAND_CHASE_BACKEND", "native")
    monkeypatch.setenv("DLAF_TPU_EIGENSOLVER_SBR_BAND", "16")
    p = tune.TuneParameters()
    assert p.dc_secular_pallas and p.dc_leaf_size == 64 and p.band_chase_backend == "native"
    assert p.eigensolver_sbr_band == 16 and p.eigensolver_min_band == -1
    assert p.bt_band_hh_group_size == -1 and p.eigensolver_matmul_precision == "float32"
    p.update(eigensolver_matmul_precision="f32")  # the JAX package's alias of float32
    for bad in ({"eigensolver_matmul_precision": "bfloat16"}, {"band_chase_backend": "host"},
                {"dc_leaf_size": 0}):
        with pytest.raises(ConfigurationError):
            p.update(**bad)
