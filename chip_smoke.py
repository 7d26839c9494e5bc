#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dlaf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  The workloads are fixed: the headline
Cholesky configuration of bench.py (N=16384, nb=512, f32, 1x1 grid,
distributed kernel forced), on a random SPD matrix made from seed 0, the
same inputs on a 2x4 grid of rank threads (path M), and
bench.py's HEEV configuration (N=8192, nb=512, f32, 1x1 grid, the full
pipeline) on random_hermitian_pd(8192, f32, seed=2), the same on the
2x4 grid (path H2) and in float64 through the mixed-precision eigensolver
(paths E2, EW), and the JAX miniapp's generalized eigenproblem (N=8192,
nb=512, f32, A and B random_hermitian_pd of seeds 1 and 2) on the 2x4
grid (path G2).  Phases, each fatal
on failure:

0. header: the card's name and power limit (nvidia-smi), stamped on every
   timing line;
1. build: every kernel under dlaf_tpu_torch/csrc/, one nvcc per source,
   all started together, then one link, and the host bulge chase (csrc/host/band2trid.cpp, g++);
2. kernels vs their plain PyTorch versions at the main paths' shapes (f32),
   on seeded inputs whose off-diagonal coupling is not small (so a kernel
   that drops terms disagrees), each within a stated tolerance, with
   kernel / plain / library-call times (CUDA events) and the card's bound
   for the same work: B1 (the cluster kernel, also bit for bit the
   one-block kernel it replaced at 512 f32 and in float64, and timed in
   turns with it: old, new, new, old), B2 (its Hopper body bit for bit
   the first body, the reference kernel, at heights 15872 down to 512 x
   512, 15872 x 512 in float64, at ragged shapes and with subnormal
   quotients (ties between two subnormals), each check first shown
   to reject the reference with its last column block's GEMM term dropped,
   timed in turns with it beside torch.linalg.solve_triangular, and summed
   over the heights of path A's 32 launches), B3 in both lookahead forms and
   at red2band's shapes (K = band = 128) and in float64, its FMA body
   (csrc/fma_gemm.cuh) bit for bit the first body (the reference kernel)
   and timed in turns with it, the bitwise check first shown to reject the
   reference with its last k slice dropped; both forms of B3 and B9 at
   ragged shapes (M, N off the 128 tile, K off the 16 slice) in f32 and
   f64, bit for bit their reference kernels; and B10, the secular bisection,
   at each of path H's shapes (8192, S), S = 1024, 2048, 4096, 8192, and
   at 2048 x 12288 (rows streamed every round) and at path H2's per-rank
   shape 1024 x 8192 (its mu table only), on true secular equations
   (mu brackets, and a table with nu brackets, near-pole roots, a zero gap
   and a NaN weight), its body bit for bit its first body (the reference
   kernel) by digests and timed in turns with it, within its bracket
   budget of the plain version, the rounds each row needs and the bound
   counted from them; then B4 (hop merge: its select bit for bit its
   plain version at path M's panel, at a ragged w, in f64 words, at the
   have masks' extremes and at an offset of one element, each check first
   shown to reject a planted wrong answer; timed beside torch.where three
   ways: the device alone with L2 hot (a CUDA graph) and cold (256 MiB
   written before each launch), and the host's time per call), B5 (the
   pull exchange: M1's panel broadcast, slotted exchanges on both axes,
   the diagonal tile on both axes, slots smaller than the hop ring's
   segments (its merge walks slot boundaries inside a segment), a skewed
   run in which one rank sleeps 50 ms before each
   launch, and the inputs' lifetime with a late source and late readers;
   bit for bit its twin and the hop ring it replaced, timed in turns with
   the hop ring) and B7 (fused factor-and-send) at path M's shapes on a
   2x4 grid of rank threads, B5 bitwise against its plain twin
   (on a CPU grid), B7 against its plain twin within tol_for(f32, nb) and
   bitwise against the unfused B1 -> B2 -> mask -> B5; then B6 (the consume
   ring) on step 0 of path M5, the path that launches it (nb=192 on its
   padded geometry), and of path M4 as B8's consume part, and B8 (the
   one-launch lookahead step) on step 0 of M4 (the main path's matrix on
   the 2x4 grid, panel 0 by B7), B6 also on a ring of 4 and in a skewed
   run at each step 0, B6 and B8 (their FMA body, csrc/consume_gemm.cuh)
   bit for bit B3 on the merged panel they return with the slots they do
   not apply zeroed, each check first shown to reject B3 with the last k
   slice of one applied slot dropped, B6 timed with every slot suppressed
   (the ring alone), B8 also against the card's two-piece step (B6 ->
   narrow update -> bcast_diag_tile -> B7), and B9 (the panel contraction)
   in both forms at path I's widest step, each against its plain twin on
   a CPU grid (merged panels bitwise, the rest within tol_for(f32, nb));
   B9 also bit for bit its reference kernel on every rank and timed in
   turns with it;
   B3's and B9's split-tier bodies (gemm_precision bf16x3 / bf16x6; csrc/
   split_gemm.cuh: a pre-pass cutting each operand into bf16 planes, then a
   pipelined mma.sync GEMM over them, each also timed alone) at the same shapes as their default-tier checks (B3 f32
   bf16x3 at path B's two shapes and red2band's, f64 bf16x6 at 16 x 16 x
   512^2; B9 f32 bf16x3 in both forms at path I's widest step) against
   their plain versions (tile.contract at the tier, on the card), within
   tol_for(f32, K) and shown to be split (far from the 'default' product),
   the check first shown to reject the default-tier kernel's output and a
   dropped term; B6's and B8's split bodies (csrc/consume.cu, the same
   body inside the ring's per-slot update) against their twins at the
   tier on a CPU grid, bf16x3 in f32 and bf16x6 in f64: B6 at step 0 of M5,
   at red2band's first window on 2x4 (K = 128) and in f64 at N=4096, B8 at
   step 0 of M4 and in f64 at N=4096, each on normal operands within
   tol_for(f32, K) and on the split probe bit for bit (merged panels and
   have bitwise on both), each check first shown to reject the
   default-tier kernel's output and a dropped term; then a small
   ragged input factored by the port and by torch.linalg.cholesky;
3. path A, the headline configuration: cholesky_factorization(backend=
   "distributed"), panel TRSM kernel on (DLAF_TPU_PANEL_TRSM_PALLAS=1);
   residual, wall time, GFlop/s (N^3/3 flops, as bench.py counts them),
   launch counts (every path that runs B1 must run it on the cluster);
4. path B, the fused tier: lookahead Cholesky and lookahead triangular
   solves (Left/Lower/N then Left/Lower/C, i.e. cholesky_solver with the
   distributed kernel forced) with trailing_update_impl=fused;
5. POSV through positive_definite_solver(..., return_info=True);
5b. the factor under the psum, v2 and pallas collectives tiers on a 2x4
   grid of rank threads at N=4096, bucketed and lookahead, bitwise;
5c. path M, the multi-rank main path on a 2x4 grid of rank threads on the
   one card, path A's inputs, collectives_impl=pallas: M1 bucketed
   Cholesky, M2 lookahead Cholesky (trailing_update_impl=xla), M3
   positive_definite_solver(..., return_info=True); residuals as in A, B
   and POSV, wall time, GFlop/s, launch counts (B7 once per rank and
   panel on M2); then path MU: M3's call from A's upper triangle (the U
   mirror of the factorization, then the Left/Upper solves), held as M3
   is, and shift recovery at N=4096 of random_hermitian_pd(4096, f32,
   seed=0) moved to a smallest eigenvalue of -1e-4: info 0 after at least
   one shift, the health events, the factor's residual against A +
   shift I, first shown to reject the next shift;
5d. the fused trailing-update tier on the same grid: M4, lookahead
   Cholesky with trailing_update_impl=fused (B8 once per step and rank, B7
   for panel 0), its factor held to M2's and, at N=4096, its info on a
   non-SPD input (a negative pivot in tile 3, owned by rank (1, 3)) to the
   'xla' tier's; M5, the same knobs at nb=192 (B6 per step, B7 per panel);
   path I, triangular_inverse("L", "N") of M4's factor (B9 once per step
   and rank) held by ||tril(X) L - I||_F / (||X||_F ||L||_F) and by
   ||tril(X) L - I||_F / ||I||_F (the first alone does not reject X = L at
   this N), and the upper form on the leading N=4096 block of L^T; S4,
   path I under gemm_precision=bf16x3 (B9's split body once per step and
   rank), then POTRI (inverse_from_cholesky_factor) of the leading N=4096
   block of M4's factor, held by ||A X - I||_F / ||I||_F; S6, M5 under
   bf16x3 (B6's split body per step and rank); S7, float64 Cholesky at
   N=4096 under bf16x6 at nb=512 (B8's split body) and nb=192 (B6's),
   and under 'auto' at both (B8 split, B6 not: K = 192 < 512), each factor
   residual float32 class where split and float64 class where not;
5e. the split-GEMM solvers: S1, positive_definite_solver(refine_to=
   "input") on 1x1 under path B's knobs and bf16x3 (B1, B2, B3's split
   body), its RefineInfo, forward and backward errors, and the unrefined
   split-tier solve's error; S2, the same call on the 2x4 grid with the
   'xla' bulk update (products split in tile.contract), the residual a
   SUMMA hermitian_multiplication over B5 whose contractions are counted in
   every rank thread: all at 'default' under the refinement's scope; S3,
   positive_definite_solver_mixed of a float64 matrix on the 2x4 grid at the
   default tier (the factor in float32: B1, B2, B5), converged without the
   fallback, its forward error within tol_for(f64, N); S5, S2's call under
   the fused tier (B8's split body on every step and rank; the residual at
   'default' in every rank thread);
5f. paths R1 and R2: reduction_to_band of path H's matrix on the 2x4 grid
   under the fused tier (B3 and B6 once per panel and rank), R1 at the
   default tier and R2 under bf16x3 (their split bodies), held by Q^H A Q
   (zero outside the band, its band the stored one) and by the band's
   eigenvalues against A's, each check first shown to reject a band with
   one panel's second addend dropped; the distance to the 1x1 grid's band
   reported;
5g. path O2: M1's Cholesky of the leading N=8192 block on the 2x4 grid at
   source rank (1, 2) (the entry point rolls the rank axes to the origin
   and back) and at the origin: bit for bit, on the caller's handle, the
   roll timed alone;
5h. general_sub_multiplication on the 2x4 grid, f32 parents of 4096^2:
   windows the multiplying ranks own, windows gathered over both axes,
   windows off the tile grid, and A's window overlapping C's in one
   parent, each held to the float64 product of the original windows
   within tol_for(f32, K), the elements outside C's window unchanged;
6. path H: hermitian_eigensolver("L", A, backend="pipeline") with
   dc_secular_pallas=1, trailing_update_impl=fused, band_chase_backend=
   native: one warm-up, one timed run (wall, GFlop/s at 4/3 N^3 as bench.py
   counts them, launch counts), one instrumented run for the stage
   breakdown; eigenvalues, residual and orthogonality held in float64 on
   the card to tol_for(f32, N), each check first shown to reject a wrong
   answer;
6b. path H2: path H's call on the 2x4 grid of rank threads under path H's
   knobs and collectives_impl=pallas, every stage over the grid (B3, B5
   and B6 in red2band, B5 in bt_red2band, B10 twice per merge level and
   rank); the same runs, the launches of each stage, path H's checks and
   H2's eigenvalues against path H's, each within tol_for(f32, N) and
   first shown to reject a wrong answer;
6c. path G2: hermitian_generalized_eigensolver("L", A, B) on the 2x4 grid
   under path H2's knobs, panel_trsm_pallas=1 and gen_to_std_backend=fused
   (B1, B2, B5 in the Cholesky of B; B2, B5 and two B6 rings a step and
   rank in the fused hegst; H2's kernels in the pipeline): a warm-up at
   N=2048, one run at N=8192 with the stage clock on (wall, GFlop/s at
   31/6 N^3, stage seconds, launches by stage); in float64 on the card,
   the eigenvalues against eigvalsh(L^-1 A L^-T), the residual
   max|A V - B V diag(w)| / (max|A| + max|B| max|w|), the B-orthogonality,
   the composed hegst (the Right TRSM: B2) against the fused one on the
   run's factor, and the U form (Cholesky of B's upper triangle, whether
   its factor is bit for bit the transposed L factor, and the composed U
   transform) against the L form, each within tol_for(f32, N) and first
   shown to reject a wrong answer;
6d. path E2: hermitian_eigensolver_mixed("L", A) of path H's matrix in
   float64 on the 2x4 grid under path H2's knobs (H2's call is its low
   stage), one run with the stage clock on (the low pipeline's seconds,
   each sweep's, iters, the orthogonality error); converged, the
   eigenvalues within tol_for(f64, N) of ||A||_2, residual and
   orthogonality within tol_for(f64, N, 200), A untouched, each check
   first shown to reject a wrong answer (the float32 pipeline's own
   eigenpairs among them);
6e. path EW: its narrow-window route, spectrum (0, 1023), under path G2's
   knobs (the Cholesky QR's B1 and B2), E2's checks on the window;
6f. path P2: hermitian_eigensolver(spectrum=(1024, 2047)) and
   hermitian_eigenvalues (all, and the window) at N=4096 on the 2x4 grid,
   within tol_for(f32, N); the eigenvalues-only runs launch no B10;
7. one {"kernels": [...]} JSON line, the card line again, and as the last
   line {"ok": true, "device": {...}}.

Solutions are held to a float64 reference solve on the card (relative
forward error); the script first checks that this test rejects X = B.
Exits non-zero without a result when no CUDA device is present or the
package is missing beside this file.  Needs one card.  scripts/
port_profile.py imports N, NB, the path knobs and make_inputs from here,
and scripts/planted_faults.py the kernel phases.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FP32_PEAK = 67e12   # H100 SXM float32 outside the tensor cores, FLOP/s
BF16_PEAK = 989e12  # H100 SXM bf16 tensor cores, dense, FLOP/s
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s

# the headline workload, bench.py's potrf_gflops_nb512_f32_1chip_distributed
N, NB, SEED = 16384, 512, 0
# tune knobs of the two factorization paths
PATH_A = {"panel_trsm_pallas": True}
PATH_B = {"cholesky_lookahead": True, "trsm_lookahead": True,
          "trailing_update_impl": "fused", "panel_trsm_pallas": True}
# the HEEV workload, bench.py's heev_n8192_nb512_f32_1chip_pipeline, and
# the knobs of path H (the band, SBR band and D&C leaf are the JAX
# package's accelerator defaults: 128, 32 and 512 at nb=512)
NH, NBH, SEED_H = 8192, 512, 2
PATH_H = {"dc_secular_pallas": True, "trailing_update_impl": "fused",
          "band_chase_backend": "native"}
# path M: distributed Cholesky and POSV on a 2x4 grid of rank threads on
# the one card, path A's inputs, the 'pallas' collectives tier (ring
# kernels B5 and B7); M1 bucketed, M2 lookahead with the 'xla' bulk
# update, M3 positive_definite_solver(..., return_info=True)
GRID_M = (2, 4)
PATH_M1 = {"collectives_impl": "pallas", "panel_trsm_pallas": True}
PATH_M2 = {"collectives_impl": "pallas", "panel_trsm_pallas": True,
           "cholesky_lookahead": True, "trailing_update_impl": "xla"}
# path M4: lookahead Cholesky under the fused trailing-update tier on the
# same grid (B8, the one-launch step, per step and rank; B7 for panel 0);
# path M5: the same knobs at nb=192, which B8's gate (nb % 128 == 0)
# refuses and B1, B2, B7 take (nb % 32 == 0): the two-piece path, B6 per
# step and B7 per panel
PATH_M4 = {"collectives_impl": "pallas", "panel_trsm_pallas": True,
           "cholesky_lookahead": True, "trailing_update_impl": "fused"}
NB_M5 = 192
# path I: triangular_inverse of M4's factor under the fused tier (B9 per
# step and rank, the consume ring's transport), then the upper form on the
# leading N_TIERS block of its transpose
PATH_I = {"collectives_impl": "pallas", "trailing_update_impl": "fused"}
# the tier-equality phase: the factor under psum, v2 and pallas, bitwise;
# also the size of the non-SPD info check of M4 and of the upper inverse
N_TIERS = 4096
# the split-GEMM paths (gemm_precision bf16x3): S1 POSV with
# refine_to='input' on 1x1 under path B's knobs (the factor's B3 through its
# split-tier body); S2 the same call on the 2x4 grid, collectives 'pallas',
# lookahead with the 'xla' bulk update (the products split in
# tile.contract, the residual a SUMMA under the 'default' scope); S3
# positive_definite_solver_mixed on the 2x4 grid at the default tier (an
# f64 matrix factored in f32, M1's knobs); S4 path I's inverse under bf16x3
# (B9's split body per step and rank), then POTRI at N_TIERS
PATH_S1 = {**PATH_B, "gemm_precision": "bf16x3"}
PATH_S2 = {**PATH_M2, "trsm_lookahead": True, "gemm_precision": "bf16x3"}
PATH_S4 = {**PATH_I, "gemm_precision": "bf16x3"}
# the split bodies of the ring consumers: S5 S2's call under the fused tier
# (B8's split body per step and rank); S6 M5 under bf16x3 (B6's split body
# per step and rank); S7 float64 Cholesky at N_TIERS under the fused tier,
# bf16x6 at NB (B8, 3 slices) and NB_M5 (B6, 3 slices), and 'auto' at both
# (bf16x6 for B8 at K = 512, 'default' for B6 at K = 192)
PATH_S5 = {**PATH_M4, "trsm_lookahead": True, "gemm_precision": "bf16x3"}
PATH_S6 = {**PATH_M4, "gemm_precision": "bf16x3"}
# paths R1 / R2: reduction_to_band of path H's matrix on the 2x4 grid under
# path H's fused tier and the 'pallas' collectives (B3 and B6 per panel and
# rank), R1 at the 'default' tier, R2 under bf16x3 (their split bodies)
PATH_R = {**PATH_H, "collectives_impl": "pallas"}
# B10 phase: (K, S) secular tables at path H's merge levels (leaf 512:
# one compiled instantiation of the kernel per S), f32 bisection rounds
K_B10, S_B10, ITERS_B10 = 8192, (1024, 2048, 4096, 8192), 42
# the weight of a near-pole row's anchor pole, as a share of the row's mean
B10_NEAR_POLE = 1e-6
# rows longer than 8192 poles: the kernel's streaming form (not on path H)
B10_STREAM = (2048, 12288)
# path H2's per-rank share of the top level's roots: RPD = NH / 8 rows of
# S = NH poles, every rank at once on its own stream (its mu table only)
B10_H2 = (-(-NH // (GRID_M[0] * GRID_M[1])), max(S_B10))
# path G2: the generalized eigensolver (HEGV) of the JAX miniapp's pair
# (A = random_hermitian_pd(NH, seed 1), B = seed 2) on the 2x4 grid at NH,
# NBH under path R's knobs, B2 on and the fused hegst (two B6 rings a step
# and rank); a warm-up at NG_WARM first
PATH_G = {**PATH_R, "panel_trsm_pallas": True, "gen_to_std_backend": "fused"}
SEED_GA, SEED_GB, NG_WARM = 1, 2, 2048
# path MU: M3's call from A's upper triangle; then shift recovery at
# N_TIERS of random_hermitian_pd(N_TIERS, seed 0) moved so that its
# smallest eigenvalue is -MU_GAP
MU_GAP = 1e-4
# path E2: hermitian_eigensolver_mixed("L", A) of path H's matrix in
# float64 on the 2x4 grid under PATH_R (the low stage is path H2's call);
# path EW: its narrow-window route, spectrum EW_SPECTRUM (the partial
# refinement: k <= max(WIDE_WINDOW_MIN, N / 2)) at N_EW under PATH_G, whose
# B2 runs in _cholqr's Cholesky and Right TRSM
EW_SPECTRUM, N_EW = (0, 1023), NH
# path P2: hermitian_eigensolver(spectrum=P2_SPECTRUM) and
# hermitian_eigenvalues (all, and the window) of random_hermitian_pd(N_P2,
# f32, seed SEED_H) on the 2x4 grid under PATH_R
N_P2, P2_SPECTRUM = 4096, (1024, 2047)
# path O2: path M1's Cholesky of the leading N_O2 block of the main path's
# matrix on the 2x4 grid, at source rank O2_SOURCE and at the origin
N_O2, O2_SOURCE = 8192, (1, 2)
# the sub-GEMM phase: general_sub_multiplication on the 2x4 grid under
# PATH_M1, f32 parents of N_SUB x N_SUB in NB tiles; (A's origin, B's
# origin, C's origin, (M, K, N)): the windows' tiles owned by the ranks
# that multiply them, gathered over both axes, off the tile grid, and
# windows of one parent (A overlapping C's window)
N_SUB = 4096
SUB_GEMM_CASES = {
    "owned": ((1024, 512), (512, 0), (1024, 2048), (2048, 1536, 1536)),
    "gathered": ((512, 0), (0, 512), (1024, 2048), (2048, 1536, 1536)),
    "unaligned": ((3, 5), (7, 11), (13, 17), (2000, 1500, 1700)),
    "aliased": ((2048, 0), (0, 2048), (2048, 512), (2048, 1536, 1536)),
}


def make_inputs(dev):
    """The main path's f32 inputs, made on ``dev`` from SEED: the SPD matrix
    A = G G^T / N + I (eigenvalues in [1, 5]) and a right-hand side [N, NB]."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED)
    g = torch.randn(N, N, generator=gen, device=dev, dtype=torch.float32)
    a = g @ g.T / N
    a.diagonal().add_(1.0)
    del g
    rhs = torch.randn(N, NB, generator=gen, device=dev, dtype=torch.float32)
    return a, rhs


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
            else f"nvidia-smi rc {out.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


_T0 = time.perf_counter()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)
    what = obj.get("phase") or obj.get("kernel")
    if what:  # progress, with the seconds since the script started
        print(f"chip_smoke: {time.perf_counter() - _T0:8.1f} s  {what}", file=sys.stderr,
              flush=True)


def worst(values) -> float:
    """The largest of ``values``, NaN if any is NaN (Python's max() keeps
    whichever of a NaN and a number comes first, so a check built on it
    could pass a NaN)."""
    values = list(values)
    return float("nan") if any(v != v for v in values) else max(values)


def timed_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean time of one call of ``fn`` in ms, by CUDA events over ``iters``
    calls after ``warmup`` untimed ones."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    """The card's least time in ms for ``flops`` f32 operations outside the
    tensor cores and ``nbytes`` of device memory, and which of the two it is."""
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def launch_counts() -> dict:
    """The kernels' launch counts since the last ``ops.reset_launch_counts``
    and their shares (``ops.SUB_COUNTS``): "potrf_cluster", how many of B1's
    went to its cluster kernel, and "trailing_update_split",
    "panel_contract_split", "dma_ring_consume_split" and "fused_step_split",
    how many of B3's, B9's, B6's and B8's ran their split-tier body."""
    from dlaf_tpu_torch import ops

    return {**ops.launch_counts(), **ops.sub_counts()}


def heev_check_fns(a64, w_ref):
    """Path H's and H2's checks in float64 on the card against
    ``w_ref = eigvalsh(a64)``: the eigenvalue error over ||A||_2, the
    residual ||A V - V diag(w)||_F / ||A||_F and the orthogonality
    ||V^T V - I||_F / sqrt(N)."""
    import torch

    n = a64.shape[0]
    norm2 = w_ref.abs().max()
    norm_f = torch.linalg.matrix_norm(a64)
    eye = torch.eye(n, dtype=torch.float64, device=a64.device)

    def eig_err(w, ref=w_ref):
        return ((w - ref).abs().max() / norm2).item()

    def residual(v, w):
        return (torch.linalg.matrix_norm(a64 @ v - v * w[None, :]) / norm_f).item()

    def orthogonality(v):
        return (torch.linalg.matrix_norm(v.T @ v - eye) / n ** 0.5).item()

    return eig_err, residual, orthogonality, eye


def heev_wrong_answers(a64, w, v, eig_err, residual, orthogonality, eye) -> dict:
    """The wrong answers each of path H's checks is first shown to reject."""
    import torch

    n = a64.shape[0]
    w_diag = torch.sort(a64.diagonal()).values
    swapped = v[:, [n - 1] + list(range(1, n - 1)) + [0]]
    dup = v.clone()
    dup[:, 0] = v[:, n - 1]
    return {"eig_err of w = sort(diag A)": eig_err(w_diag),
            "residual of V = I": residual(eye, w),
            "residual of V with its first and last columns swapped": residual(swapped, w),
            "orthogonality of V with its first column replaced by its last": orthogonality(dup)}


def path_h(stamp: dict, kept: dict) -> dict:
    """Phase 6: hermitian_eigensolver("L", A, backend="pipeline") at NH,
    NBH.  Returns the timed run's launch counts; keeps its eigenvalues and
    eigvalsh's (float64, on the card) in ``kept`` for path H2."""
    import numpy as np
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import ops, tune
    from dlaf_tpu_torch.algorithms.eigensolver import _sbr_target
    from dlaf_tpu_torch.algorithms.reduction_to_band import get_band_size
    from dlaf_tpu_torch.algorithms.tridiag_dc_dist import _plan
    from dlaf_tpu_torch.common import stagetimer
    from dlaf_tpu_torch.matrix import layout
    from dlaf_tpu_torch.testing import random_hermitian_pd, tol_for

    n, nb = NH, NBH
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    a_np = random_hermitian_pd(n, np.float32, seed=SEED_H)
    a_low = torch.from_numpy(np.tril(a_np)).to(dev)
    emit({"phase": "path_H_input", "n": n, "seed": SEED_H, "host_s": time.perf_counter() - t0})
    del a_np
    os.environ.pop("DLAF_TPU_PANEL_TRSM_PALLAS", None)
    tune.initialize(**PATH_H)

    def run(instrumented: bool = False):
        mat = dtt.DistributedMatrix.from_global(dtt.Grid.create(), a_low, (nb, nb))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        if instrumented:
            stagetimer.start()
        t0 = time.perf_counter()
        res = dtt.hermitian_eigensolver("L", mat, backend="pipeline")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        times = stagetimer.stop() if instrumented else None
        return res, wall, launch_counts(), times

    band = get_band_size(nb, dev)
    run()  # warm-up (allocator, library handles, the chase's threads), discarded
    res, wall, counts, _ = run()
    _, wall_i, _, times = run(instrumented=True)
    gflop = 4.0 * n ** 3 / 3 / 1e9

    # checks in float64 on the card against eigvalsh of the same matrix
    a64 = a_low.double()
    a64 = a64 + torch.tril(a64, -1).T
    w_ref = torch.linalg.eigvalsh(a64)
    eig_err, residual, orthogonality, eye = heev_check_fns(a64, w_ref)
    tol = tol_for("float32", n)
    w = torch.from_numpy(np.asarray(res.eigenvalues, np.float64)).to(dev)
    v = layout.unpad_global(layout.unpack(res.eigenvectors.data, res.eigenvectors.dist),
                            res.eigenvectors.dist).double()
    got = {"eig_err": eig_err(w), "residual": residual(v, w), "orthogonality": orthogonality(v)}
    # each check first rejects a wrong answer
    wrong = heev_wrong_answers(a64, w, v, eig_err, residual, orthogonality, eye)
    kept.update(H_w=w, w_ref=w_ref)
    del a64, eye, v
    torch.cuda.empty_cache()
    emit({"phase": "path_H", "config": "hermitian_eigensolver(L, pipeline), " + ", ".join(
              f"{k}={v_}" for k, v_ in PATH_H.items()),
          "n": n, "nb": nb, "band": band, "sbr_band": _sbr_target(band, dev),
          "dc_leaf_size": tune.get_tune_parameters().dc_leaf_size, "wall_s": wall,
          "gflops": gflop / wall, "instrumented_wall_s": wall_i, "stage_s": times,
          "checks": got, "tol": tol, "wrong_answers": wrong, "launches": counts, **stamp})
    for name, val in wrong.items():
        if not val > tol:
            fail(f"path H check accepts a wrong answer: {name} = {val:.3e} <= {tol:.3e}")
    for name, val in got.items():
        if not val <= tol:
            fail(f"path H {name} {val:.3e} > {tol:.3e}")
    s0, levels = _plan(n, nb, tune.get_tune_parameters().dc_leaf_size)[:2]
    if tuple(s0 << lv for lv in range(1, levels + 1)) != S_B10:
        fail(f"path H's merge sizes {[s0 << lv for lv in range(1, levels + 1)]} are not "
             f"the B10 phase's {S_B10}")
    if counts["secular_bisect"] != 2 * levels or counts["trailing_update"] <= 0:
        fail(f"path H did not launch B10 twice per merge level ({levels} levels) and B3: {counts}")
    return counts


def path_h2(stamp: dict, kept: dict) -> dict:
    """Phase 6b: path H's call on the GRID_M grid of rank threads under
    PATH_R (path H's knobs and the 'pallas' collectives tier, on which R1
    runs red2band): hermitian_eigensolver("L", A, backend="pipeline") at
    NH, NBH, every stage over the grid (B3 and B6 in red2band, B5 there and
    in bt_red2band's strip broadcast, B10 on each rank's share of every
    level's roots).  A warm-up, one timed run (wall, GFlop/s at 4/3 N^3,
    launches) and one instrumented run (stage seconds, and the launches of
    each stage).  Path H's checks in float64 on the card, and H2's
    eigenvalues against path H's (``kept``), each within tol_for(f32, N)
    and first shown to reject a wrong answer.  Returns the timed run's
    launch counts."""
    import numpy as np
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import ops, tune
    from dlaf_tpu_torch.algorithms.tridiag_dc_dist import _plan
    from dlaf_tpu_torch.common import stagetimer
    from dlaf_tpu_torch.matrix import layout
    from dlaf_tpu_torch.testing import random_hermitian_pd, tol_for

    n, nb = NH, NBH
    dev = torch.device("cuda")
    a_np = random_hermitian_pd(n, np.float32, seed=SEED_H)
    a_low = torch.from_numpy(np.tril(a_np)).to(dev)
    del a_np
    tune.initialize(**PATH_R)
    grid = dtt.Grid.create(GRID_M, device=dev)
    ranks = grid.size
    by_stage = {}
    timer_stage = stagetimer.stage

    @contextlib.contextmanager
    def counted_stage(name, device=None):
        """stagetimer.stage, and the launches made inside it."""
        before = launch_counts()
        with timer_stage(name, device):
            yield
        after = launch_counts()
        by_stage[name] = {k: after[k] - before[k] for k in after if after[k] != before[k]}

    def run(instrumented: bool = False):
        mat = dtt.DistributedMatrix.from_global(grid, a_low, (nb, nb))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        if instrumented:
            stagetimer.start()
            stagetimer.stage = counted_stage
        t0 = time.perf_counter()
        try:
            res = dtt.hermitian_eigensolver("L", mat, backend="pipeline")
            torch.cuda.synchronize()
        finally:
            stagetimer.stage = timer_stage
        wall = time.perf_counter() - t0
        times = stagetimer.stop() if instrumented else None
        return res, wall, launch_counts(), times

    run()  # warm-up, discarded
    res, wall, counts, _ = run()
    _, wall_i, _, times = run(instrumented=True)
    gflop = 4.0 * n ** 3 / 3 / 1e9

    a64 = a_low.double()
    a64 = a64 + torch.tril(a64, -1).T
    del a_low
    eig_err, residual, orthogonality, eye = heev_check_fns(a64, kept["w_ref"])
    tol = tol_for("float32", n)
    w = torch.from_numpy(np.asarray(res.eigenvalues, np.float64)).to(dev)
    v = layout.unpad_global(layout.unpack(res.eigenvectors.data, res.eigenvectors.dist),
                            res.eigenvectors.dist).double()
    del res
    w_h = kept["H_w"]
    kept.update(H2_w=w, H2_v=v)  # the float32 pipeline's pairs: wrong answers of E2 and EW
    got = {"eig_err": eig_err(w), "residual": residual(v, w), "orthogonality": orthogonality(v),
           "eig_vs_path_H": eig_err(w, w_h)}
    wrong = heev_wrong_answers(a64, w, v, eig_err, residual, orthogonality, eye)
    wrong["eig_vs_path_H of w = sort(diag A)"] = eig_err(torch.sort(a64.diagonal()).values, w_h)
    del a64, eye, v
    torch.cuda.empty_cache()
    s0, levels = _plan(n, nb, tune.get_tune_parameters().dc_leaf_size)[:2]
    emit({"phase": "path_H2", "config": "hermitian_eigensolver(L, pipeline), " + ", ".join(
              f"{k}={v_}" for k, v_ in PATH_R.items()),
          "grid": list(GRID_M), "n": n, "nb": nb, "seed": SEED_H, "wall_s": wall,
          "gflops": gflop / wall, "instrumented_wall_s": wall_i, "stage_s": times,
          "launches_by_stage": by_stage, "checks": got, "tol": tol, "wrong_answers": wrong,
          "launches": counts, "launches_per_rank": {k: v_ / ranks for k, v_ in counts.items()},
          **stamp})
    for name, val in wrong.items():
        if not val > tol:
            fail(f"path H2 check accepts a wrong answer: {name} = {val:.3e} <= {tol:.3e}")
    for name, val in got.items():
        if not val <= tol:
            fail(f"path H2 {name} {val:.3e} > {tol:.3e}")
    if counts["secular_bisect"] != 2 * levels * ranks or min(
            counts["trailing_update"], counts["ring_exchange"], counts["dma_ring_consume"]) <= 0:
        fail(f"path H2 did not launch B10 twice per merge level ({levels} levels) and rank "
             f"({ranks}), and B3, B5 and B6: {counts}")
    return counts


def path_mu(stamp: dict, a_glob, rhs, solve_err, res_tol) -> dict:
    """Phase 5c-MU: path M3's call from the upper triangle,
    positive_definite_solver("U", A, B, return_info=True) at N, NB on the
    GRID_M grid under PATH_M1 (the U mirror: A's upper triangle transposed
    into lower storage, M1's bucketed factor, the factor transposed back,
    then the Left/Upper/C and Left/Upper/N solves), held as M3 is (the
    factor residual ||A - U^T U||_F / ||A||_F and the forward error against
    the float64 solve).  Then shift recovery at N_TIERS on the same grid:
    cholesky_factorization("L", ..., shift_recovery=True, return_info=True)
    of random_hermitian_pd(N_TIERS, f32, seed 0) - (lambda_min + MU_GAP) I
    (lambda_min in float64 on the card): info 0 after at least one shift,
    the health events' shifts, and the factor's residual against A + shift
    I within tol_for(f32, N_TIERS), the check first shown to reject the
    residual against A + 100 shift I (the next shift).  Returns each run's
    launch counts."""
    import numpy as np
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import health, ops, tune
    from dlaf_tpu_torch.matrix import layout
    from dlaf_tpu_torch.testing import random_hermitian_pd, tol_for

    n, nb = N, NB
    dev = torch.device("cuda")
    grid = dtt.Grid.create(GRID_M)
    ranks = grid.size
    counts_by = {}
    tune.initialize(**PATH_M1)
    mat_a = dtt.DistributedMatrix.from_global(grid, a_glob, (nb, nb))
    mat_b = dtt.DistributedMatrix.from_global(grid, rhs.clone(), (nb, nb))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    x, info = dtt.positive_definite_solver("U", mat_a, mat_b, return_info=True)
    info = int(info)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counts_by["MU"] = launch_counts()
    serr = solve_err(layout.unpack(x.data, x.dist)[:n, :nb])
    del mat_b, x
    up = torch.triu(layout.unpack(mat_a.data, mat_a.dist)[:n, :n]).double()
    del mat_a
    a64 = a_glob.double()
    fres = (torch.linalg.matrix_norm(a64 - up.T @ up) / torch.linalg.matrix_norm(a64)).item()
    del up, a64
    torch.cuda.empty_cache()
    emit({"phase": "path_MU", "config": "positive_definite_solver(U, return_info=True), "
          "collectives_impl=pallas, panel_trsm_pallas=1", "grid": list(GRID_M), "n": n,
          "nrhs": nb, "wall_s": wall, "info": info, "factor_residual": fres,
          "solve_forward_err": serr, "tol": res_tol, "launches": counts,
          "launches_per_rank": {k: v / ranks for k, v in counts.items()}, **stamp})
    if info != 0 or not (serr <= res_tol and fres <= res_tol):
        fail(f"path MU info {info}, factor residual {fres:.3e}, solve error {serr:.3e}")
    if min(counts[k] for k in ("potrf", "panel_trsm", "ring_exchange")) <= 0 \
            or counts["potrf_cluster"] != counts["potrf"]:
        fail(f"path MU did not launch B1 (on the cluster), B2 and B5: {counts}")

    # shift recovery of a matrix whose smallest eigenvalue is -MU_GAP
    ns = N_TIERS
    a64 = torch.from_numpy(random_hermitian_pd(ns, np.float32, seed=0)).to(dev).double()
    eye = torch.eye(ns, dtype=torch.float64, device=dev)
    lam = torch.linalg.eigvalsh(a64)[0].item()
    near = (a64 - (lam + MU_GAP) * eye).float()
    lam_near = torch.linalg.eigvalsh(near.double())[0].item()
    del a64
    mat = dtt.DistributedMatrix.from_global(grid, near, (nb, nb))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with health.capture_events() as events:
        fac, info = dtt.cholesky_factorization("L", mat, shift_recovery=True, return_info=True)
    info = int(info)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counts_by["MU_shift"] = launch_counts()
    shift = events[-1]["shift"] if events else 0.0
    ell = torch.tril(layout.unpack(fac.data, fac.dist)[:ns, :ns]).double()
    del fac, mat
    target = near.double() + shift * eye
    llt = ell @ ell.T
    norm_t = torch.linalg.matrix_norm(target)
    res = (torch.linalg.matrix_norm(target - llt) / norm_t).item()
    wrong = (torch.linalg.matrix_norm(target + 99.0 * shift * eye - llt) / norm_t).item()
    del ell, target, llt, eye, near
    torch.cuda.empty_cache()
    tol = tol_for("float32", ns)
    retries = [e for e in events if e["event"] == "cholesky_shift_retry"]
    emit({"phase": "path_MU_shift", "config": "cholesky_factorization(L, shift_recovery=True, "
          "return_info=True), collectives_impl=pallas, panel_trsm_pallas=1",
          "grid": list(GRID_M), "n": ns, "nb": nb, "lambda_min_of_input": lam_near,
          "wall_s": wall, "info": info, "events": events, "shift": shift,
          "factor_residual_vs_a_plus_shift": res,
          "wrong_answers": {"residual against A + 100 shift I": wrong}, "tol": tol,
          "launches": counts, **stamp})
    if not wrong > tol:
        fail(f"path MU's shift check accepts the next shift: {wrong:.3e} <= {tol:.3e}")
    if info != 0 or not retries or events[-1]["event"] != "cholesky_shift_recovered" \
            or not res <= tol:
        fail(f"path MU shift recovery: info {info}, events {events}, residual {res:.3e}")
    return counts_by


def path_g2(stamp: dict) -> dict:
    """Phase 6c: hermitian_generalized_eigensolver("L", A, B) on the GRID_M
    grid of rank threads at NH, NBH under PATH_G: Cholesky of B (B1, B2,
    B5), the fused hegst (B2 for the diagonal tile and the panel, B5 for
    both panels, and its her2k as two B6 rings a step and rank), the Left
    solve of phase B, path H2's pipeline, and the back-substitution.  A
    warm-up at NG_WARM, then one run at NH with the stage clock on (wall,
    GFlop/s at 31/6 N^3 as the JAX miniapp counts them, stage seconds, the
    launches of each stage).  Checks in float64 on the card, each within
    tol_for(f32, NH) and first shown to reject a wrong answer: the
    eigenvalues against eigvalsh(L^-1 A L^-T) with L the float64 factor of
    B, relative to max|lambda|; the residual max|A V - B V diag(w)| / (max|A|
    + max|B| max|w|); the B-orthogonality max|V^T B V - I|; generalized_to_
    standard on the run's factor under 'composed' (the Right TRSM on the
    card: B2) against 'fused'; and the U form (cholesky_factorization("U")
    of B's upper triangle, then the composed transform from A's) against
    the L form, with whether the U factor is bit for bit the transposed L
    factor.  Returns each run's launch counts."""
    import numpy as np
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import ops, tune
    from dlaf_tpu_torch.algorithms.tridiag_dc_dist import _plan
    from dlaf_tpu_torch.common import stagetimer
    from dlaf_tpu_torch.matrix import layout
    from dlaf_tpu_torch.testing import random_hermitian_pd, tol_for

    n, nb = NH, NBH
    dev = torch.device("cuda")
    tune.initialize(**PATH_G)
    grid = dtt.Grid.create(GRID_M, device=dev)
    ranks = grid.size

    def lower_inputs(m):
        return [torch.from_numpy(np.tril(random_hermitian_pd(m, np.float32, seed=s))).to(dev)
                for s in (SEED_GA, SEED_GB)]

    def mat(x):
        return dtt.DistributedMatrix.from_global(grid, x, (nb, nb))

    def dense(m):
        return layout.unpad_global(layout.unpack(m.data, m.dist), m.dist)

    # warm-up at NG_WARM, discarded
    a_w, b_w = lower_inputs(NG_WARM)
    dtt.hermitian_generalized_eigensolver("L", mat(a_w), mat(b_w))
    torch.cuda.synchronize()
    del a_w, b_w
    torch.cuda.empty_cache()

    a_low, b_low = lower_inputs(n)
    by_stage = {}
    timer_stage = stagetimer.stage

    @contextlib.contextmanager
    def counted_stage(name, device=None):
        """stagetimer.stage, and the launches made inside it."""
        before = launch_counts()
        with timer_stage(name, device):
            yield
        after = launch_counts()
        by_stage[name] = {k: after[k] - before[k] for k in after if after[k] != before[k]}

    mat_a, mat_b = mat(a_low), mat(b_low)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    stagetimer.start()
    stagetimer.stage = counted_stage
    t0 = time.perf_counter()
    try:
        res = dtt.hermitian_generalized_eigensolver("L", mat_a, mat_b)
        torch.cuda.synchronize()
    finally:
        stagetimer.stage = timer_stage
    wall = time.perf_counter() - t0
    times = stagetimer.stop()
    counts_by = {"G2_hegv": launch_counts()}
    counts = counts_by["G2_hegv"]
    gflop = 31.0 / 6.0 * n ** 3 / 1e9

    # float64 checks on the card
    a64 = a_low.double()
    a64 = a64 + torch.tril(a64, -1).T
    b64 = b_low.double()
    b64 = b64 + torch.tril(b64, -1).T
    l64 = torch.linalg.cholesky(b64)
    s64 = torch.linalg.solve_triangular(l64, a64, upper=False)
    s64 = torch.linalg.solve_triangular(l64, s64.T, upper=False)
    s64 = 0.5 * (s64 + s64.T)
    w_ref = torch.linalg.eigvalsh(s64)
    w_diag = torch.sort(s64.diagonal()).values
    del l64, s64
    w = torch.from_numpy(np.asarray(res.eigenvalues, np.float64)).to(dev)
    v = dense(res.eigenvectors).double()
    del res
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    scale = a64.abs().max() + b64.abs().max() * w.abs().max()

    def eig_err(x):
        return ((x - w_ref).abs().max() / w_ref.abs().max()).item()

    def residual(vv):
        return ((a64 @ vv - (b64 @ vv) * w[None, :]).abs().max() / scale).item()

    def b_orthogonality(vv):
        return (vv.T @ b64 @ vv - eye).abs().max().item()

    swapped = v[:, [n - 1] + list(range(1, n - 1)) + [0]]
    dup = v.clone()
    dup[:, 0] = v[:, n - 1]
    got = {"eig_err": eig_err(w), "residual": residual(v), "b_orthogonality": b_orthogonality(v)}
    wrong = {"eig_err of w = sort(diag(L^-1 A L^-T))": eig_err(w_diag),
             "residual of V with its first and last columns swapped": residual(swapped),
             "b_orthogonality of V with its first column replaced by its last":
                 b_orthogonality(dup)}
    del v, swapped, dup, w_ref, w_diag, eye
    torch.cuda.empty_cache()

    # the two backends on the run's factor (mat_b holds it), then the U form
    def transform(uplo, ma, mb, backend):
        tune.get_tune_parameters().update(gen_to_std_backend=backend)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = dtt.generalized_to_standard(uplo, ma, mb)
        torch.cuda.synchronize()
        return dense(out).double(), time.perf_counter() - t0, launch_counts()

    std_f, wall_f, counts_by["G2_fused"] = transform("L", mat_a, mat_b, "fused")
    std_c, wall_c, counts_by["G2_composed"] = transform("L", mat_a, mat_b, "composed")
    norm_c = std_c.abs().max()
    skipped = std_c.clone()  # a wrong answer: the last tile row and column untransformed
    skipped[-nb:, :] = a64[-nb:, :]
    skipped[:, -nb:] = a64[:, -nb:]
    del a64, b64
    got["backends"] = ((std_f - std_c).abs().max() / norm_c).item()
    # the yardstick of both comparisons with the composed L form
    wrong["backends and u_form: the L form with its last tile row and column untransformed"] = (
        (skipped - std_c).abs().max() / norm_c).item()
    del std_f
    mat_bu = mat(b_low.T.contiguous())  # the upper triangle, the mirror of the lower
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fac_u = dtt.cholesky_factorization("U", mat_bu)
    torch.cuda.synchronize()
    wall_fu = time.perf_counter() - t0
    counts_by["G2_upper_factor"] = launch_counts()
    fl, fu = torch.tril(dense(mat_b)), torch.triu(dense(fac_u))
    u_bitwise = bool(torch.equal(fu.T, fl))
    u_max_diff = (fu.T.double() - fl.double()).abs().max().item()
    del fl, fu
    std_u, wall_u, counts_by["G2_upper_composed"] = transform(
        "U", mat(a_low.T.contiguous()), fac_u, "composed")
    got["u_form"] = ((std_u - std_c).abs().max() / norm_c).item()
    del std_u, std_c, skipped, mat_a, mat_b, mat_bu, fac_u, a_low, b_low
    torch.cuda.empty_cache()

    tol = tol_for("float32", n)
    mt = -(-n // nb)
    hegst_b6 = by_stage.get("gen_to_std", {}).get("dma_ring_consume", 0)
    emit({"phase": "path_G2", "config": "hermitian_generalized_eigensolver(L), " + ", ".join(
              f"{k}={v_}" for k, v_ in PATH_G.items()),
          "grid": list(GRID_M), "n": n, "nb": nb, "seeds": [SEED_GA, SEED_GB],
          "warmup_n": NG_WARM, "wall_s": wall, "gflops": gflop / wall, "stage_clock_on": True,
          "flops_counted": "31/6 N^3", "stage_s": times, "launches_by_stage": by_stage,
          "hegst_b6_launches": hegst_b6, "checks": got, "tol": tol, "wrong_answers": wrong,
          "transform_wall_s": {"fused": wall_f, "composed": wall_c, "upper_factor": wall_fu,
                               "upper_composed": wall_u},
          "u_factor_bitwise_transposed_l_factor": u_bitwise,
          "u_factor_max_abs_diff": u_max_diff, "launches": counts,
          "launches_per_rank": {k: v_ / ranks for k, v_ in counts.items()},
          "launches_of_the_transforms": {k: counts_by[k] for k in (
              "G2_fused", "G2_composed", "G2_upper_factor", "G2_upper_composed")}, **stamp})
    for name, val in wrong.items():
        if not val > tol:
            fail(f"path G2 check accepts a wrong answer: {name} = {val:.3e} <= {tol:.3e}")
    for name, val in got.items():
        if not val <= tol:
            fail(f"path G2 {name} {val:.3e} > {tol:.3e}")
    s0, levels = _plan(n, nb, tune.get_tune_parameters().dc_leaf_size)[:2]
    chol = by_stage.get("cholesky_b", {})
    hegst = by_stage.get("gen_to_std", {})
    if (hegst_b6 != 2 * mt * ranks or min(chol.get(k, 0) for k in (
            "potrf", "panel_trsm", "ring_exchange")) <= 0
            or min(hegst.get(k, 0) for k in ("panel_trsm", "ring_exchange")) <= 0
            or counts["secular_bisect"] != 2 * levels * ranks
            or min(counts["trailing_update"], counts["dma_ring_consume"]) <= 0
            or counts_by["G2_composed"]["panel_trsm"] <= 0):
        fail(f"path G2 did not launch B6 twice a step and rank in hegst ({hegst_b6}, want "
             f"{2 * mt * ranks}), B1, B2, B5 in cholesky_b, B2 and B5 in hegst, B10 twice per "
             f"merge level and rank, B3, B6, and B2 in the composed Right TRSM: {by_stage}, "
             f"{counts_by['G2_composed']}")
    return counts_by


def window_check_fns(a64, w_ref):
    """The checks of an n x k block of eigenpairs in float64 on the card
    (paths E2, EW, P2): the eigenvalue error over ||A||_2 against a window
    of ``w_ref = eigvalsh(a64)``, the residual ||A V - V diag(w)||_F /
    ||A||_F and the orthogonality ||V^T V - I||_F / sqrt(k)."""
    import torch

    norm2 = w_ref.abs().max()
    norm_f = torch.linalg.matrix_norm(a64)

    def eig_err(w, ref):
        return ((w - ref).abs().max() / norm2).item()

    def residual(v, w):
        return (torch.linalg.matrix_norm(a64 @ v - v * w[None, :]) / norm_f).item()

    def orthogonality(v):
        k = v.shape[1]
        eye = torch.eye(k, dtype=v.dtype, device=v.device)
        return (torch.linalg.matrix_norm(v.T @ v - eye) / k ** 0.5).item()

    return eig_err, residual, orthogonality


def window_wrong_answers(a64, w, v, window, ref, eig_err, residual, orthogonality) -> dict:
    """The wrong answers each window check is first shown to reject:
    path H's, on the k columns of ``window`` (``ref`` its eigenvalues)."""
    import torch

    il, iu = window
    n, k = v.shape
    w_diag = torch.sort(a64.diagonal()).values[il:iu + 1]
    eye_k = torch.eye(n, k, dtype=v.dtype, device=v.device)
    swapped = v[:, [k - 1] + list(range(1, k - 1)) + [0]]
    dup = v.clone()
    dup[:, 0] = v[:, k - 1]
    return {"eig_err of w = sort(diag A) on the window": eig_err(w_diag, ref),
            "residual of V = the first k columns of I": residual(eye_k, w),
            "residual of V with its first and last columns swapped": residual(swapped, w),
            "orthogonality of V with its first column replaced by its last": orthogonality(dup)}


def _low_pairs(kept: dict, grid, a_low, nb):
    """The float32 pipeline's own eigenpairs of path H's matrix on the grid
    (float64 on the card): path H2's, kept, or computed here."""
    import numpy as np
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch.matrix import layout

    if "H2_v" not in kept:
        res = dtt.hermitian_eigensolver(
            "L", dtt.DistributedMatrix.from_global(grid, a_low.float(), (nb, nb)))
        kept["H2_w"] = torch.from_numpy(np.asarray(res.eigenvalues, np.float64)).to(a_low.device)
        kept["H2_v"] = layout.unpad_global(layout.unpack(res.eigenvectors.data,
                                                         res.eigenvectors.dist),
                                           res.eigenvectors.dist).double()
    return kept["H2_w"], kept["H2_v"]


def _path_h_matrix(n: int, dev):
    """random_hermitian_pd(n, f32, seed SEED_H): its lower triangle in
    float64, and the whole matrix in float64, on the card."""
    import numpy as np
    import torch

    from dlaf_tpu_torch.testing import random_hermitian_pd

    a_low = torch.from_numpy(np.tril(random_hermitian_pd(n, np.float32, seed=SEED_H))).to(dev)
    a_low = a_low.double()
    return a_low, a_low + torch.tril(a_low, -1).T


def path_e2(stamp: dict, kept: dict) -> dict:
    """Phase 6d: hermitian_eigensolver_mixed("L", A) on the GRID_M grid of
    rank threads at NH, NBH under PATH_R, A path H's matrix in float64: the
    low stage is path H2's call (B3, B5 and B6 in red2band, B10 in the
    D&C), then Ogita-Aishima sweeps in float64 over the SUMMA products (B5
    for every panel broadcast).  One run with the stage clock on: the
    wall, the low pipeline's wall, the seconds of each sweep, info.iters
    and info.ortho_error, the launches.  Checks in float64 on the card:
    converged; the eigenvalue error over ||A||_2 within tol_for(f64, N);
    the residual and the orthogonality within tol_for(f64, N, 200); A left
    untouched, bit for bit.  Each check is first shown to reject a wrong
    answer: the float32 pipeline's own eigenpairs (path H2's, ``kept``),
    heev_wrong_answers' others, and A with one element changed.  Returns
    the run's launch counts."""
    import numpy as np
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import ops, tune
    from dlaf_tpu_torch.algorithms.eigensolver import _sbr_target
    from dlaf_tpu_torch.algorithms.reduction_to_band import get_band_size
    from dlaf_tpu_torch.common import stagetimer
    from dlaf_tpu_torch.matrix import layout
    from dlaf_tpu_torch.testing import tol_for

    n, nb = NH, NBH
    dev = torch.device("cuda")
    tune.initialize(**PATH_R)
    grid = dtt.Grid.create(GRID_M, device=dev)
    a_low, a64 = _path_h_matrix(n, dev)
    w_lo, v_lo = _low_pairs(kept, grid, a_low, nb)
    mat = dtt.DistributedMatrix.from_global(grid, a_low, (nb, nb))
    before = mat.data.clone()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    stagetimer.start()
    t0 = time.perf_counter()
    res, info = dtt.hermitian_eigensolver_mixed("L", mat)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    times = stagetimer.stop()
    counts = launch_counts()
    untouched = bool(torch.equal(mat.data, before))
    before.view(-1)[0] += 1.0
    changed_untouched = bool(torch.equal(mat.data, before))
    del mat, before, a_low
    w_ref = kept["w_ref"] if "w_ref" in kept else torch.linalg.eigvalsh(a64)
    eig_err, residual, orthogonality, eye = heev_check_fns(a64, w_ref)
    w = torch.from_numpy(np.asarray(res.eigenvalues, np.float64)).to(dev)
    v = layout.unpad_global(layout.unpack(res.eigenvectors.data, res.eigenvectors.dist),
                            res.eigenvectors.dist)
    del res
    got = {"eig_err": eig_err(w), "residual": residual(v, w), "orthogonality": orthogonality(v)}
    wrong = {f"{k} (the float32 pipeline's)": val for k, val in (
        ("eig_err", eig_err(w_lo)), ("residual", residual(v_lo, w_lo)),
        ("orthogonality", orthogonality(v_lo)))}
    wrong.update(heev_wrong_answers(a64, w, v, eig_err, residual, orthogonality, eye))
    del a64, eye, v
    torch.cuda.empty_cache()
    tol_w, tol_v = tol_for("float64", n), tol_for("float64", n, 200)
    tols = {"eig_err": tol_w, "residual": tol_v, "orthogonality": tol_v}
    pipeline = ("red2band", "sbr", "chase", "tridiag", "bt_band", "bt_sbr", "bt_red2band")
    band = get_band_size(nb, dev)
    emit({"phase": "path_E2", "config": "hermitian_eigensolver_mixed(L), " + ", ".join(
              f"{k}={v_}" for k, v_ in PATH_R.items()),
          "grid": list(GRID_M), "n": n, "nb": nb, "seed": SEED_H, "dtype": "float64",
          "low_dtype": "float32", "band": band, "sbr_band": _sbr_target(band, dev),
          "wall_s": wall, "stage_clock_on": True,
          "low_pipeline_s": sum(times.get(k, 0.0) for k in pipeline),
          "refine_s": times.get("eig_refine"),
          "sweep_s": {k: v_ for k, v_ in times.items() if k.startswith("eig_refine/sweep")},
          "stage_s": times, "iters": info.iters, "ortho_error": info.ortho_error,
          "converged": info.converged, "a_untouched": untouched, "checks": got, "tol": tols,
          "wrong_answers": wrong, "a_untouched_of_a_changed_element": changed_untouched,
          "launches": counts, **stamp})
    if changed_untouched:
        fail("path E2's untouched check accepts A with one element changed")
    for name, val in wrong.items():
        lim = tols[name.split(" ")[0]]
        if not val > lim:
            fail(f"path E2 check accepts a wrong answer: {name} = {val:.3e} <= {lim:.3e}")
    if not (info.converged and untouched):
        fail(f"path E2 converged {info.converged} ({info}), A untouched {untouched}")
    for name, val in got.items():
        if not val <= tols[name]:
            fail(f"path E2 {name} {val:.3e} > {tols[name]:.3e}")
    if min(counts[k] for k in ("trailing_update", "ring_exchange", "dma_ring_consume",
                               "secular_bisect")) <= 0:
        fail(f"path E2 did not launch B3, B5, B6 and B10: {counts}")
    return counts


def path_ew(stamp: dict, kept: dict) -> dict:
    """Phase 6e: the narrow-window route of hermitian_eigensolver_mixed,
    spectrum EW_SPECTRUM of path H's matrix in float64 at N_EW on the
    GRID_M grid under PATH_G: the float32 pipeline, then the partial
    refinement (the in-window Rayleigh-Ritz, the preconditioned step over
    the whole low basis, and _cholqr: the distributed Cholesky of the k x k
    Gram matrix, B1, B2, B5, and the Right TRSM, B2).  One run with the
    stage clock on; path E2's checks on the window, each first shown to
    reject a wrong answer (the float32 pipeline's window and
    window_wrong_answers').  Returns the run's launch counts."""
    import numpy as np
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import ops, tune
    from dlaf_tpu_torch.common import stagetimer
    from dlaf_tpu_torch.matrix import layout
    from dlaf_tpu_torch.testing import tol_for

    n, nb = N_EW, NBH
    il, iu = EW_SPECTRUM
    dev = torch.device("cuda")
    tune.initialize(**PATH_G)
    grid = dtt.Grid.create(GRID_M, device=dev)
    a_low, a64 = _path_h_matrix(n, dev)
    if n == NH:
        w_lo, v_lo = _low_pairs(kept, grid, a_low, nb)
        w_lo, v_lo = w_lo[il:iu + 1], v_lo[:, il:iu + 1]
        w_ref = kept["w_ref"] if "w_ref" in kept else torch.linalg.eigvalsh(a64)
    else:
        w_lo, v_lo = _low_pairs({}, grid, a_low, nb)
        w_lo, v_lo = w_lo[il:iu + 1], v_lo[:, il:iu + 1]
        w_ref = torch.linalg.eigvalsh(a64)
    mat = dtt.DistributedMatrix.from_global(grid, a_low, (nb, nb))
    del a_low
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    stagetimer.start()
    t0 = time.perf_counter()
    res, info = dtt.hermitian_eigensolver_mixed("L", mat, spectrum=EW_SPECTRUM)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    times = stagetimer.stop()
    counts = launch_counts()
    del mat
    eig_err, residual, orthogonality = window_check_fns(a64, w_ref)
    ref = w_ref[il:iu + 1]
    w = torch.from_numpy(np.asarray(res.eigenvalues, np.float64)).to(dev)
    v = layout.unpad_global(layout.unpack(res.eigenvectors.data, res.eigenvectors.dist),
                            res.eigenvectors.dist)
    k = v.shape[1]
    del res
    got = {"eig_err": eig_err(w, ref), "residual": residual(v, w),
           "orthogonality": orthogonality(v)}
    wrong = {f"{k_} (the float32 pipeline's window)": val for k_, val in (
        ("eig_err", eig_err(w_lo, ref)), ("residual", residual(v_lo, w_lo)),
        ("orthogonality", orthogonality(v_lo)))}
    wrong.update(window_wrong_answers(a64, w, v, EW_SPECTRUM, ref, eig_err, residual,
                                      orthogonality))
    del a64, v, w_lo, v_lo
    torch.cuda.empty_cache()
    tol_w, tol_v = tol_for("float64", n), tol_for("float64", n, 200)
    tols = {"eig_err": tol_w, "residual": tol_v, "orthogonality": tol_v}
    emit({"phase": "path_EW", "config": f"hermitian_eigensolver_mixed(L, spectrum={EW_SPECTRUM})"
                                        ", " + ", ".join(f"{k_}={v_}" for k_, v_ in PATH_G.items()),
          "grid": list(GRID_M), "n": n, "nb": nb, "k": k, "seed": SEED_H, "dtype": "float64",
          "wall_s": wall, "stage_clock_on": True, "refine_s": times.get("eig_refine/partial"),
          "sweep_s": {k_: v_ for k_, v_ in times.items()
                      if k_.startswith("eig_refine/partial/sweep")},
          "stage_s": times, "iters": info.iters, "residual": info.residual,
          "converged": info.converged, "checks": got, "tol": tols, "wrong_answers": wrong,
          "launches": counts, **stamp})
    for name, val in wrong.items():
        lim = tols[name.split(" ")[0]]
        if not val > lim:
            fail(f"path EW check accepts a wrong answer: {name} = {val:.3e} <= {lim:.3e}")
    if not info.converged or k != iu - il + 1:
        fail(f"path EW converged {info.converged} ({info}), {k} columns")
    for name, val in got.items():
        if not val <= tols[name]:
            fail(f"path EW {name} {val:.3e} > {tols[name]:.3e}")
    if min(counts[k_] for k_ in ("potrf", "panel_trsm", "ring_exchange", "secular_bisect")) <= 0:
        fail(f"path EW did not launch B1, B2, B5 and B10: {counts}")
    return counts


def path_p2(stamp: dict) -> dict:
    """Phase 6f: partial spectra and eigenvalues only on the GRID_M grid
    under PATH_R, on random_hermitian_pd(N_P2, f32, seed SEED_H):
    hermitian_eigensolver("L", A, spectrum=P2_SPECTRUM) (the D&C's
    eigenvectors cut to the window, the back-transforms on its k columns),
    then hermitian_eigenvalues("L", A) of the whole spectrum and of the
    window (red2band, the SBR stage and the rotation chase with no
    transform, LAPACK's tridiagonal solver; no B10).  Held in float64 on
    the card against eigvalsh of the same matrix, each within tol_for(f32,
    N_P2) and first shown to reject a wrong answer.  Returns each run's
    launch counts."""
    import numpy as np
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import ops, tune
    from dlaf_tpu_torch.matrix import layout
    from dlaf_tpu_torch.testing import tol_for

    n, nb = N_P2, NBH
    il, iu = P2_SPECTRUM
    dev = torch.device("cuda")
    tune.initialize(**PATH_R)
    grid = dtt.Grid.create(GRID_M, device=dev)
    a_low, a64 = _path_h_matrix(n, dev)
    a_low = a_low.float()
    w_ref = torch.linalg.eigvalsh(a64)
    ref = w_ref[il:iu + 1]
    eig_err, residual, orthogonality = window_check_fns(a64, w_ref)

    def run(fn):
        mat = dtt.DistributedMatrix.from_global(grid, a_low, (nb, nb))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(mat)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, launch_counts()

    counts_by, walls = {}, {}
    res, walls["spectrum"], counts_by["P2_spectrum"] = run(
        lambda m: dtt.hermitian_eigensolver("L", m, spectrum=P2_SPECTRUM))
    w_all, walls["eigenvalues"], counts_by["P2_eigenvalues"] = run(
        lambda m: dtt.hermitian_eigenvalues("L", m))
    w_win, walls["eigenvalues_window"], counts_by["P2_eigenvalues_window"] = run(
        lambda m: dtt.hermitian_eigenvalues("L", m, spectrum=P2_SPECTRUM))

    def on_card(x):
        return torch.from_numpy(np.asarray(x, np.float64)).to(dev)

    w = on_card(res.eigenvalues)
    v = layout.unpad_global(layout.unpack(res.eigenvectors.data, res.eigenvectors.dist),
                            res.eigenvectors.dist).double()
    k = v.shape[1]
    del res
    got = {"eig_err": eig_err(w, ref), "residual": residual(v, w),
           "orthogonality": orthogonality(v),
           "eigenvalues_eig_err": eig_err(on_card(w_all), w_ref),
           "eigenvalues_window_eig_err": eig_err(on_card(w_win), ref)}
    wrong = window_wrong_answers(a64, w, v, P2_SPECTRUM, ref, eig_err, residual,
                                 orthogonality)
    wrong["eigenvalues_eig_err of w = sort(diag A)"] = eig_err(
        torch.sort(a64.diagonal()).values, w_ref)
    del a64, v, a_low, w_ref
    torch.cuda.empty_cache()
    tol = tol_for("float32", n)
    emit({"phase": "path_P2", "config": f"hermitian_eigensolver(L, spectrum={P2_SPECTRUM}), "
                                        "hermitian_eigenvalues(L) and (L, spectrum), "
                                        + ", ".join(f"{k_}={v_}" for k_, v_ in PATH_R.items()),
          "grid": list(GRID_M), "n": n, "nb": nb, "k": k, "seed": SEED_H, "wall_s": walls,
          "checks": got, "tol": tol, "wrong_answers": wrong, "launches": counts_by, **stamp})
    for name, val in wrong.items():
        if not val > tol:
            fail(f"path P2 check accepts a wrong answer: {name} = {val:.3e} <= {tol:.3e}")
    for name, val in got.items():
        if not val <= tol:
            fail(f"path P2 {name} {val:.3e} > {tol:.3e}")
    cs, ce = counts_by["P2_spectrum"], counts_by["P2_eigenvalues"]
    if (k != iu - il + 1 or min(cs[k_] for k_ in ("trailing_update", "ring_exchange",
                                                   "dma_ring_consume", "secular_bisect")) <= 0
            or min(ce["trailing_update"], ce["dma_ring_consume"]) <= 0
            or ce["secular_bisect"] != 0):
        fail(f"path P2: {k} columns; the window did not launch B3, B5, B6 and B10, or the "
             f"eigenvalues B3 and B6 and no B10: {counts_by}")
    return counts_by


def path_o2(stamp: dict, a_glob) -> dict:
    """Phase 5g: path M1's Cholesky (PATH_M1 on the GRID_M grid: B1, B2,
    B5) of the leading N_O2 block of the main path's matrix at the origin,
    then at source rank O2_SOURCE: the entry point rolls the stacked
    tensor's rank axes to the origin and back (algorithms/_origin.py), one
    device copy each way, timed alone.  The factor at O2_SOURCE must be
    bit for bit the origin call's (the check first shown to reject it with
    one element changed), land on the caller's handle with its source
    rank, and its residual ||A - L L^T||_F / ||A||_F lie within
    tol_for(f32, N_O2).  Returns each run's launch counts."""
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import ops, tune
    from dlaf_tpu_torch.matrix import layout
    from dlaf_tpu_torch.testing import tol_for

    n, nb = N_O2, NB
    dev = torch.device("cuda")
    tune.initialize(**PATH_M1)
    grid = dtt.Grid.create(GRID_M, device=dev)
    a = a_glob[:n, :n].contiguous()

    def run(src):
        mat = dtt.DistributedMatrix.from_global(grid, a, (nb, nb), source_rank=src)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fac = dtt.cholesky_factorization("L", mat)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        on_handle = mat.data is fac.data and tuple(mat.dist.source_rank) == tuple(src)
        g = layout.unpad_global(layout.unpack(fac.data, fac.dist), fac.dist)
        return g, tuple(fac.dist.source_rank), on_handle, wall, launch_counts()

    g0, src0, _, wall0, counts0 = run((0, 0))
    g1, src1, on_handle, wall1, counts1 = run(O2_SOURCE)
    bitwise = bool(torch.equal(g0, g1))
    flipped = g1.clone()
    flipped[n - 1, 0] = -flipped[n - 1, 0] if flipped[n - 1, 0] != 0 else 1.0
    rejects = not torch.equal(g0, flipped)
    del flipped
    lo = torch.tril(g1.double())
    a64 = a.double()
    res = (torch.linalg.matrix_norm(a64 - lo @ lo.T) / torch.linalg.matrix_norm(a64)).item()
    del lo, a64, g0, g1
    probe = dtt.DistributedMatrix.from_global(grid, a, (nb, nb), source_rank=O2_SOURCE)
    roll_ms = timed_ms(probe.to_origin, 5)
    del probe, a
    torch.cuda.empty_cache()
    tol = tol_for("float32", n)
    emit({"phase": "path_O2", "config": f"cholesky_factorization(L) at source_rank "
                                        f"{list(O2_SOURCE)} and (0, 0), " + ", ".join(
                                            f"{k}={v}" for k, v in PATH_M1.items()),
          "grid": list(GRID_M), "n": n, "nb": nb, "wall_s": {"origin": wall0, "source": wall1},
          "roll_ms": roll_ms, "roll_bytes": n * n * 4, "bitwise_vs_origin": bitwise,
          "bitwise_check_rejects_a_changed_element": rejects, "result_source_rank": list(src1),
          "on_callers_handle": on_handle, "factor_residual": res, "tol": tol,
          "launches": {"origin": counts0, "source": counts1}, **stamp})
    if not rejects:
        fail("path O2's bitwise check accepts a factor with one element changed")
    if not (bitwise and on_handle and src1 == tuple(O2_SOURCE) and src0 == (0, 0)
            and res <= tol):
        fail(f"path O2: bitwise {bitwise}, on the caller's handle {on_handle}, source rank "
             f"{src1}, residual {res:.3e} (tol {tol:.3e})")
    if min(counts1[k] for k in ("potrf", "panel_trsm", "ring_exchange")) <= 0:
        fail(f"path O2 did not launch B1, B2 and B5: {counts1}")
    return {"O2_origin": counts0, "O2_source": counts1}


def sub_gemm_phase(stamp: dict) -> dict:
    """Phase 5h: general_sub_multiplication(alpha, A_ref, B_ref, beta,
    C_ref) on the GRID_M grid under PATH_M1 (B5 for every panel broadcast),
    f32 parents of N_SUB x N_SUB in NB tiles made from seed SEED + 3, for
    each of SUB_GEMM_CASES: windows whose tiles the multiplying ranks own,
    windows gathered over both axes first, windows off the tile grid (the
    window_extract -> general_multiplication -> window_update route), and
    A's window overlapping C's in one parent (the rank barrier before the
    write-back).  C's window is held to the float64 product of the
    original windows on the card, max|C - C_ref| / max|C_ref| within
    tol_for(f32, K), the check first shown to reject C's window unchanged;
    the elements outside C's window bit for bit unchanged.  Returns each
    case's launch counts."""
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import ops, tune
    from dlaf_tpu_torch.matrix import layout
    from dlaf_tpu_torch.testing import tol_for

    dev = torch.device("cuda")
    tune.initialize(**PATH_M1)
    grid = dtt.Grid.create(GRID_M, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    alpha, beta = 0.75, -0.5
    out, counts_by = {}, {}
    for case, ((ra, ca), (rb, cb), (rc, cc), (m, k, nn)) in SUB_GEMM_CASES.items():
        aliased = case == "aliased"
        xs = [torch.randn(N_SUB, N_SUB, generator=gen, device=dev) for _ in range(1 if aliased
                                                                                 else 3)]
        mats = [dtt.DistributedMatrix.from_global(grid, x, (NB, NB)) for x in xs]
        ma, mb, mc = (mats * 3) if aliased else mats
        xa, xb, xc = (xs * 3) if aliased else xs
        want = (beta * xc[rc:rc + m, cc:cc + nn].double()
                + alpha * xa[ra:ra + m, ca:ca + k].double() @ xb[rb:rb + k, cb:cb + nn].double())
        refs = (dtt.MatrixRef(ma, (ra, ca), (m, k)), dtt.MatrixRef(mb, (rb, cb), (k, nn)),
                dtt.MatrixRef(mc, (rc, cc), (m, nn)))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        dtt.general_sub_multiplication(alpha, refs[0], refs[1], beta, refs[2])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts_by[f"sub_gemm_{case}"] = launch_counts()
        got = layout.unpad_global(layout.unpack(mc.data, mc.dist), mc.dist)
        scale = want.abs().max()
        err = ((got[rc:rc + m, cc:cc + nn].double() - want).abs().max() / scale).item()
        unchanged = ((xc[rc:rc + m, cc:cc + nn].double() - want).abs().max() / scale).item()
        outside = torch.ones_like(got, dtype=torch.bool)
        outside[rc:rc + m, cc:cc + nn] = False
        kept_outside = bool(torch.equal(got[outside], xc[outside]))
        out[case] = {"aligned": [r.aligned for r in refs], "wall_s": wall, "rel_err": err,
                     "rel_err_of_c_unchanged": unchanged, "outside_unchanged": kept_outside,
                     "tol": tol_for("float32", k), "launches": counts_by[f"sub_gemm_{case}"]}
        del xs, mats, ma, mb, mc, xa, xb, xc, want, got, outside, refs
        torch.cuda.empty_cache()
    emit({"phase": "sub_gemm", "config": "general_sub_multiplication, " + ", ".join(
              f"{k}={v}" for k, v in PATH_M1.items()),
          "grid": list(GRID_M), "n_parent": N_SUB, "nb": NB, "alpha": alpha, "beta": beta,
          "cases": out, **stamp})
    for case, r in out.items():
        if not r["rel_err_of_c_unchanged"] > r["tol"]:
            fail(f"sub-GEMM {case}: the check accepts C's window unchanged")
        if not (r["rel_err"] <= r["tol"] and r["outside_unchanged"]):
            fail(f"sub-GEMM {case}: rel err {r['rel_err']:.3e} (tol {r['tol']:.3e}), outside "
                 f"unchanged {r['outside_unchanged']}")
        if all(r["aligned"]) != (case != "unaligned") or r["launches"]["ring_exchange"] <= 0:
            fail(f"sub-GEMM {case}: aligned {r['aligned']}, launches {r['launches']}")
    return counts_by


def potrf_phase(stamp: dict, bound, timed_ms, kgen):
    """Phase 2a: B1 at the main path's tile, 512 x 512 f32: the cluster
    kernel within tol_for(f32, nb) of its plain version and bit for bit the
    one-block kernel it replaced (whose body B7 and B8 run), timed in turns
    with it (one block, cluster, cluster, one block); then float64 at 512
    (which the gate routes to one block) and at 352 (the largest float64
    tile the cluster takes), bit for bit the one-block kernel.  The f32
    tile is a Wishart G G^T / (2 nb), G (nb, 2 nb) (cond about 34; later
    rows of the factor carry half their weight off the diagonal).  Returns
    the report entry and the plain factor (B2's operand)."""
    import torch

    from dlaf_tpu_torch.ops import potrf
    from dlaf_tpu_torch.testing import tol_for

    dev = torch.device("cuda")
    nb = NB
    g = torch.randn(nb, 2 * nb, generator=kgen, device=dev, dtype=torch.float32)
    d = (g @ g.T / (2 * nb)).contiguous()
    del g
    k_out, p_out = potrf.potrf_tile(d), potrf.potrf_tile_plain(d)
    o_out = potrf.potrf_tile_one_block(d)
    torch.cuda.synchronize()
    diff = k_out.double() - p_out.double()
    err_abs = diff.abs().max().item()
    err = (torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(p_out.double())).item()
    tol = tol_for("float32", nb)
    bitwise = {"f32_512_cluster": torch.equal(k_out, o_out)}
    del k_out, o_out, diff
    herm = torch.tril(d) + torch.tril(d, -1).T
    turns = [timed_ms(lambda: potrf.potrf_tile_one_block(d), 20),
             timed_ms(lambda: potrf.potrf_tile(d), 20),
             timed_ms(lambda: potrf.potrf_tile(d), 20),
             timed_ms(lambda: potrf.potrf_tile_one_block(d), 20)]
    routes = {"f32_512": "cluster" if potrf.cluster_fits(d) else "one block"}
    gen64 = torch.Generator(device=dev).manual_seed(SEED + 3)
    for n64 in (nb, 352):
        g = torch.randn(n64, 2 * n64, generator=gen64, device=dev, dtype=torch.float64)
        d64 = (g @ g.T / (2 * n64)).contiguous()
        routes[f"f64_{n64}"] = "cluster" if potrf.cluster_fits(d64) else "one block"
        bitwise[f"f64_{n64}_{routes[f'f64_{n64}'].replace(' ', '_')}"] = torch.equal(
            potrf.potrf_tile(d64), potrf.potrf_tile_one_block(d64))
        del g, d64
    b_ms, b_by = bound(nb ** 3 / 3, 2 * nb * nb * 4)
    rec = {"kernel": "potrf", "shape": [nb, nb], "max_abs_err": err_abs, "rel_err": err,
           "tol": tol, "kernel_ms": (turns[1] + turns[2]) / 2,
           "one_block_ms": (turns[0] + turns[3]) / 2,
           "turns_ms": {"one_block": [turns[0], turns[3]], "cluster": [turns[1], turns[2]]},
           "design": f"a cluster of {potrf.CLUSTER_BLOCKS} blocks holding the tile in distributed "
                     "shared memory (before: one block, the trailing triangle in device memory)",
           "routes": routes, "bitwise_vs_one_block": bitwise,
           "plain_ms": timed_ms(lambda: potrf.potrf_tile_plain(d), 2),
           "library_ms": timed_ms(lambda: torch.linalg.cholesky(herm), 20),
           "library_call": "torch.linalg.cholesky", "bound_ms": b_ms, "bound_by": b_by, **stamp}
    emit(rec)
    del d, herm
    if not err <= tol:
        fail(f"potrf kernel vs plain: rel err {err:.3e} > tol {tol:.3e}")
    if not all(bitwise.values()):
        fail(f"potrf cluster kernel vs the one-block kernel: not bitwise equal {bitwise}")
    if routes["f32_512"] != "cluster":
        fail(f"potrf: the main path's tile does not take the cluster kernel: {routes}")
    return rec, p_out


#: B2's sweep at nb=512, f32: heights from the main path's tallest panel down
#: to its shortest (each bit for bit the reference, timed in turns with it)
B2_HEIGHTS = (15872, 12288, 8192, 4096, 2048, 512)
#: B2's ragged cases (rows, nb, dtype): rows off every strip and warp size,
#: nb of 3 and 5 column blocks
B2_RAGGED = ((1000, 96, "float32"), (200, 160, "float32"), (40, 96, "float32"),
             (200, 96, "float64"), (1000, 160, "float64"))
#: B2's case of subnormal quotients: rows, the power of two every other row
#: of b is scaled by (its x then lie below FLT_MIN), and L's diagonal (98:
#: for some ties between two subnormals, a / 98 = K * 2^-150 with K odd, the
#: f32 body's product with RN64(1/98) is not the tie; with 6 it always is)
B2_SUBNORMAL = (2048, -133, 98.0)


def path_a_heights() -> list:
    """The rows of path A's 32 panel solves (1x1 grid, N, NB): the bucketed
    kernel solves a window of the tile column whose height shrinks by
    halving segments (``_spmd.halving_segments``), not the exact rows below
    the diagonal."""
    from dlaf_tpu_torch.algorithms import _spmd

    mt = N // NB
    return [max(min(mt, mt - k0), 1) * NB
            for k0, k1 in _spmd.halving_segments(mt) for _ in range(k0, k1)]


def _spd_factor(n: int, dtype, gen):
    """The lower Cholesky factor of a Wishart G G^T / (2 n), G (n, 2 n)."""
    import torch

    g = torch.randn(n, 2 * n, generator=gen, device=gen.device, dtype=dtype)
    return torch.linalg.cholesky(g @ g.T / (2 * n)).contiguous()


def _drop_last_block(ell):
    """L with its last column block's row block left of the diagonal block
    zeroed: a solve against it drops that block's GEMM term."""
    from dlaf_tpu_torch.ops import panel_trsm as pt

    d = ell.clone()
    d[-pt.W:, :-pt.W] = 0
    return d


def panel_trsm_phase(stamp: dict, bound, timed_ms, kgen, ell) -> dict:
    """Phase 2a': B2, the Hopper body (``solve_rows``), against its first
    body (the reference kernel, ``panel_trsm_reference``) on the same
    inputs: at B2_HEIGHTS x 512 against B1's factor ``ell`` (f32), at
    15872 x 512 in float64, at the ragged B2_RAGGED, and at B2_SUBNORMAL
    (``ell`` with its diagonal set to 98 and every other row of b scaled
    into the subnormal range, so that some quotients are ties between two
    subnormals that the f32 body's reciprocal product misses, and the body
    must divide there; the tolerance against the plain version is then held
    by the normal rows), each bit for bit the reference, the
    check first shown to reject the reference with its last column block's
    GEMM term dropped, and within tol_for(dtype, nb) of the plain version;
    timed in turns with the reference (reference, new, new, reference)
    beside one ``torch.linalg.solve_triangular``.  Then the same times at
    every height path A launches, summed over its 32 launches.  Standard
    normal right-hand sides.  Returns the report entry (15872 x 512 f32
    first)."""
    import torch

    from dlaf_tpu_torch.ops import panel_trsm as pt
    from dlaf_tpu_torch.testing import tol_for

    dev = kgen.device
    nb = NB
    a_heights = path_a_heights()
    gen64 = torch.Generator(device=dev).manual_seed(SEED + 5)
    # the main path's panel from kgen, as the earlier runs drew it (the later
    # phases draw the same inputs), then the rows path A's windows add
    b_all = torch.cat([torch.randn(N - NB, nb, generator=kgen, device=dev),
                       torch.randn(max(a_heights) - (N - NB), nb, generator=gen64, device=dev)])
    cases, bad = {}, []

    def times(l_op, b, iters):
        lt = l_op.T.contiguous()
        new = lambda: pt.panel_trsm_right_lower_t(l_op, b)  # noqa: E731
        old = lambda: pt.panel_trsm_reference(l_op, b)  # noqa: E731
        turns = [timed_ms(old, iters), timed_ms(new, iters), timed_ms(new, iters),
                 timed_ms(old, iters)]
        return {"kernel_ms": (turns[1] + turns[2]) / 2, "reference_ms": (turns[0] + turns[3]) / 2,
                "turns_ms": {"reference": [turns[0], turns[3]], "hopper_body": [turns[1], turns[2]]},
                "library_ms": timed_ms(lambda: torch.linalg.solve_triangular(
                    lt, b, upper=True, left=False), iters)}

    def case(label, l_op, b, iters, timed=True):
        dname = str(l_op.dtype).replace("torch.", "")
        m, n = b.shape
        new = pt.panel_trsm_right_lower_t(l_op, b)
        v = fma_verdict(label, new, pt.panel_trsm_reference(l_op, b),
                        pt.panel_trsm_reference(_drop_last_block(l_op), b),
                        pt.panel_trsm_plain(l_op, b), tol_for(dname, n),
                        dropped_what="its last column block's GEMM term")
        bad.extend(v.pop("problems"))
        b_ms, b_by = bound(m * n * n, (2 * m * n + n * (n + 1) // 2) * b.element_size())
        rec = {"shape": [m, n], "dtype": dname, **v, "bound_ms": b_ms, "bound_by": b_by,
               "subnormal_x": int(((new.abs() < torch.finfo(new.dtype).tiny)
                                   & (new != 0)).sum())}
        if timed:
            rec.update(times(l_op, b, iters),
                       plain_ms=timed_ms(lambda: pt.panel_trsm_plain(l_op, b), 1))
        cases[label] = rec
        emit({"kernel": "panel_trsm", "case": label, **rec, **stamp})

    for h in B2_HEIGHTS:
        case(f"{h}x{nb} float32", ell, b_all[:h], 10)
    ell64 = _spd_factor(nb, torch.float64, gen64)
    b64 = torch.randn(max(B2_HEIGHTS), nb, generator=gen64, device=dev, dtype=torch.float64)
    case(f"{max(B2_HEIGHTS)}x{nb} float64", ell64, b64, 5)
    del ell64, b64
    for m, n, dname in B2_RAGGED:
        dtype = getattr(torch, dname)
        case(f"{m}x{n} {dname}", _spd_factor(n, dtype, gen64),
             torch.randn(m, n, generator=gen64, device=dev, dtype=dtype), 10, timed=False)
    m, e, diag = B2_SUBNORMAL
    tie = ell.clone()
    tie.diagonal().fill_(diag)
    bs = b_all[:m].clone()
    bs[1::2] *= 2.0 ** e
    label = f"{m}x{nb} float32, subnormal quotients"
    case(label, tie, bs, 10, timed=False)
    if not cases[label]["subnormal_x"]:
        bad.append(f"{label}: no x is subnormal, so the case checks nothing of them")
    del tie, bs


    # every height path A launches, each timed in turns, summed over its launches
    sweep = {}
    for h in sorted(set(a_heights), reverse=True):
        sweep[h] = {"launches": a_heights.count(h), **times(ell, b_all[:h], 10)}
    total = {k: sum(r[k] * r["launches"] for r in sweep.values())
             for k in ("kernel_ms", "reference_ms", "library_ms")}
    emit({"kernel": "panel_trsm", "case": "path A's launches", "heights": a_heights,
          "by_height": sweep, "launch_weighted_sum_ms": total, **stamp})
    del b_all
    torch.cuda.empty_cache()
    if bad:
        fail("panel_trsm (the Hopper body) vs its reference and plain version: " + "; ".join(bad))
    head = cases[f"{max(B2_HEIGHTS)}x{nb} float32"]
    return {**head, "max_abs_err": worst(c["max_abs_err"] for c in cases.values()),
            "cases": cases, "path_a": {"by_height": sweep, "launch_weighted_sum_ms": total}}


def grid_span_ms(grid, fn, stacked, iters: int, gate_s: float = 1.0):
    """Device time of one call of ``fn`` on every rank of ``grid``, and the
    slowest rank thread's host time to queue its calls (both in ms).  The
    caller's stream first sleeps on the card for ``gate_s``, so that every
    rank thread has queued its ``iters`` calls before any runs (eight rank
    threads queue a ring call in several ms: without the gate the span
    would time the host); then the span from the earliest rank's start
    event to the latest rank's end event, over ``iters``."""
    import torch

    from dlaf_tpu_torch.comm import collectives as coll

    pc = grid.grid_size.cols
    starts, ends = [None] * grid.size, [None] * grid.size
    enqueue = [0.0] * grid.size
    ref = torch.cuda.Event(enable_timing=True)
    ref.record()
    torch.cuda._sleep(int(gate_s * 2e9))  # cycles; the H100's clock is below 2 GHz

    def body(*views):
        r, c = coll.my_rank()
        t0 = time.perf_counter()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn(*views)
        e.record()
        enqueue[r * pc + c] = time.perf_counter() - t0
        starts[r * pc + c], ends[r * pc + c] = s, e

    coll.spmd(grid, body, *stacked)
    torch.cuda.synchronize()
    t0 = min(ref.elapsed_time(s) for s in starts)
    t1 = max(ref.elapsed_time(e) for e in ends)
    return (t1 - t0) / iters, max(enqueue) * 1e3


def on_ranks(grid, fn, stacked):
    """``fn(*views)`` on every rank; its tuple of tensors gathered into
    stacked outputs [Pr, Pc, ...] (on the grid's device)."""
    import torch

    from dlaf_tpu_torch.comm import collectives as coll

    got = {}

    def body(*views):
        got[coll.my_rank()] = [t.clone() for t in fn(*views)]

    coll.spmd(grid, body, *stacked)
    pr, pc = grid.grid_size
    return [torch.stack([torch.stack([got[(r, c)][i] for c in range(pc)]) for r in range(pr)])
            for i in range(len(got[(0, 0)]))]


def pull_phase(stamp: dict, bound, kgen, gpu, cpu, timed_ms) -> dict:
    """B5 at path M's shapes (f32, a 2x4 grid of rank threads on the card,
    every ring of the grid at once): the pull bit for bit its twin (a CPU
    grid of the same shape) and the hop ring it replaced, on five cases and
    a skewed run (rank (0, 1) sleeps 50 ms before each launch), timed in
    turns with the hop ring; then the inputs' lifetime on M1's broadcast,
    every rank overwriting its input with NaN right after its launch: a
    late source (its stream fills a fresh input with NaN, sleeps 100 ms on
    the card, then writes it, so a reader that does not wait for the
    source's entry flag reads NaN) and late readers (their streams sleep
    100 ms before their launches, so the source's kernel waits at its
    entry barrier while its host thread queues the overwrite behind it:
    the overwrite runs the moment the source's kernel ends, and a source
    that does not wait for its readers' done flags loses their reads),
    each bit for bit the twin.
    Returns the report entry (the bcast_c case, with every case under
    "shapes")."""
    import torch

    from dlaf_tpu_torch.comm import collectives as coll
    from dlaf_tpu_torch.ops import panel_exchange as px

    dev = torch.device("cuda")
    nb, ltr, ltc = NB, N // NB // GRID_M[0], N // NB // GRID_M[1]
    pr, pc = GRID_M
    root = 1

    def slotted(axis, n_slots):
        have = torch.zeros(pr, pc, n_slots, dtype=torch.bool)
        for s_ in range(n_slots - 1):  # one contributor per slot, the last slot none
            if axis == "c":
                have[:, s_ % pc, s_] = True
            else:
                have[s_ % pr, :, s_] = True
        return have

    cases = {
        # M1's panel broadcast over 'c' (16 MiB)
        "bcast_c": ("c", (ltr, nb, nb), None),
        # a slotted exchange over 'c' (16 slots of 1 MiB)
        "exchange_c": ("c", (ltr, nb, nb), slotted("c", ltr)),
        # M2's transpose_panel over 'r' (8 slots of 1 MiB)
        "exchange_r": ("r", (ltc, nb, nb), slotted("r", ltc)),
        # bcast_diag_tile: 1 MiB over 'c', then over 'r'
        "diag_c": ("c", (nb, nb), None),
        "diag_r": ("r", (nb, nb), None),
        # slots smaller than the hop ring's segments, so that its merge walks
        # slot boundaries inside a segment: 64 slots of 16 KiB (16 a segment,
        # 16-byte accesses), and 37 slots of 129 words (one segment, words)
        "small_slots_c": ("c", (64, 64, 64), slotted("c", 64)),
        "ragged_slots_c": ("c", (37, 129), slotted("c", 37)),
    }
    shapes, bad = {}, []
    for name, (axis, shape, have) in cases.items():
        x = torch.randn(pr, pc, *shape, generator=kgen, device=dev)

        def make(exchange, axis=axis):
            def fn(xl, hl=None):
                if hl is None:
                    is_root = coll._ranks.current().axis(axis)[0] == root
                    return (exchange(xl, is_root, axis, kind="bcast")[0],)
                return exchange(xl, hl, axis)
            return fn

        pull, hops = make(px.ring_exchange), make(px.ring_exchange_hops)
        args_gpu = [x] if have is None else [x, have.to(dev)]
        args_cpu = [x.cpu()] if have is None else [x.cpu(), have]
        got = on_ranks(gpu, pull, args_gpu)
        old = on_ranks(gpu, hops, args_gpu)
        t0 = time.perf_counter()
        ref = on_ranks(cpu, pull, args_cpu)
        plain_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        same = all(torch.equal(g.cpu(), r_) for g, r_ in zip(got, ref))
        same_old = all(torch.equal(o.cpu(), r_) for o, r_ in zip(old, ref))
        err = worst((g.cpu().double() - r_.double()).abs().max().item() for g, r_ in zip(got, ref))
        payload = x[0, 0].numel() * 4
        # every rank reads its contribution and writes its result once
        b_ms, b_by = bound(0.0, 2 * pr * pc * payload)
        union = got[0].reshape(pr * pc, -1)
        src = union[0].clone()
        turns = [grid_span_ms(gpu, hops, args_gpu, 10), grid_span_ms(gpu, pull, args_gpu, 10),
                 grid_span_ms(gpu, pull, args_gpu, 10), grid_span_ms(gpu, hops, args_gpu, 10)]
        rec = {"kernel": "ring_exchange", "case": name, "axis": axis,
               "payload_shape": list(shape), "ranks": pr * pc, "bitwise_vs_plain": same,
               "bitwise_hop_ring_vs_plain": same_old, "max_abs_err": err,
               "kernel_ms": (turns[1][0] + turns[2][0]) / 2,
               "hop_ring_ms": (turns[0][0] + turns[3][0]) / 2,
               "turns_ms": {"hop_ring": [turns[0][0], turns[3][0]],
                            "pull": [turns[1][0], turns[2][0]]},
               "enqueue_ms_of_10_calls": {"pull": turns[1][1], "hop_ring": turns[0][1]},
               "plain_ms": plain_ms, "plain_on": "cpu (the twin's state is host objects)",
               "library_ms": timed_ms(lambda: union.copy_(src.expand_as(union)), 20),
               "library_call": "one copy_ writing a payload into every rank's buffer",
               "bound_ms": b_ms, "bound_by": b_by, **stamp}
        emit(rec)
        shapes[name] = rec
        if not (same and same_old):
            bad.append(f"{name}: pull bitwise the plain ring {same}, hop ring {same_old} "
                       f"(max err {err:.3e})")
        del x, got, old, ref, union, src

    # skewed run: rank (0, 1) sleeps 50 ms before each launch
    x = torch.randn(pr, pc, ltr, nb, nb, generator=kgen, device=dev)

    def bc(exchange):
        return lambda xl: (exchange(xl, coll.my_rank()[1] == root, "c", kind="bcast")[0],)

    ref = on_ranks(cpu, bc(px.ring_exchange), [x.cpu()])[0]
    px.launch_delay_s[(0, 1)] = 0.05
    t0 = time.perf_counter()
    try:
        got = on_ranks(gpu, bc(px.ring_exchange), [x])[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        old = on_ranks(gpu, bc(px.ring_exchange_hops), [x])[0]
        torch.cuda.synchronize()
    finally:
        px.launch_delay_s.clear()
    skew = {"case": "bcast_c, rank (0, 1) sleeps 50 ms before launching",
            "bitwise_vs_plain": torch.equal(got.cpu(), ref),
            "hop_ring_bitwise_vs_plain": torch.equal(old.cpu(), ref), "wall_s": wall}
    emit({"kernel": "ring_exchange", "skewed_run": skew, **stamp})
    if not (skew["bitwise_vs_plain"] and skew["hop_ring_bitwise_vs_plain"]):
        bad.append(f"skewed bcast_c: pull {skew['bitwise_vs_plain']}, hop ring "
                   f"{skew['hop_ring_bitwise_vs_plain']} bitwise the plain ring")
    del got, old

    # the inputs' lifetime: a late source and late readers, every rank
    # overwriting its input right after its launch.  The inputs are held
    # until the run is over: freed, their memory would go to the next
    # allocation on the same stream (the copy of the result), which could
    # write the right bytes back before a late read
    held = []

    def lifetime(late_source: bool):
        def body(xl):
            myc = coll.my_rank()[1]
            mine = torch.full_like(xl, float("nan"))
            held.append(mine)
            if (myc == root) == late_source:
                torch.cuda._sleep(int(100e-3 * 2e9))  # cycles; the H100's clock is below 2 GHz
            mine.copy_(xl)
            out = px.ring_bcast(mine, myc == root, "c")
            mine.fill_(float("nan"))  # on this rank's stream, right after the launch
            return (out,)
        return body

    life, wrong = {}, {}
    for label, late in (("late_source", True), ("late_readers", False)):
        got = on_ranks(gpu, lifetime(late), [x])[0].cpu()
        torch.cuda.synchronize()
        life[label] = torch.equal(got, ref)
        # bitwise equal or not, NaN counting as a difference
        wrong[label] = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        del got
        held.clear()
    emit({"kernel": "ring_exchange", "input_lifetime_bitwise_vs_plain": life,
          "input_lifetime_wrong_elements": wrong, "elements": ref.numel(), **stamp})
    if not all(life.values()):
        bad.append(f"input lifetime: {life}, wrong elements {wrong} of {ref.numel()}")
    del x, ref
    if bad:
        fail("ring_exchange (pull) vs plain ring and hop ring: " + "; ".join(bad))
    torch.cuda.empty_cache()
    return {**shapes["bcast_c"], "shapes": shapes, "skewed_run": skew, "input_lifetime": life}


#: B4's cases beyond path M's panel (slots, words a slot, dtype, have
#: masks): a ragged w (every slot a head or a tail), f64 words, a slot of
#: fewer words than a 16-byte vector, and the masks' extremes
B4_CASES = ((7, 1023, "float32", "mixed"), (5, 300, "float64", "mixed"),
            (9, 3, "float32", "mixed"), (16, 4096, "float32", "all held"),
            (16, 4096, "float32", "none held"), (16, 4096, "float32", "all incoming"))


def _merge_inputs(slots, w, dtype, masks, gen):
    import torch

    dev = gen.device
    y = torch.randn(slots, w, generator=gen, device=dev, dtype=dtype)
    y_in = torch.randn(slots, w, generator=gen, device=dev, dtype=dtype)

    def mask(p):
        return torch.randint(0, 2, (slots, 1), generator=gen, device=dev,
                             dtype=torch.int32) if p is None else torch.full(
                                 (slots, 1), p, device=dev, dtype=torch.int32)

    h, h_in = {"mixed": (None, None), "all held": (1, None), "none held": (0, 0),
               "all incoming": (0, 1)}[masks]
    return y, y_in, mask(h), mask(h_in)


def _poisoned(fn, numel: int, dev):
    """``fn()`` after freeing a block of ``numel`` words of all ones, the
    only free block in PyTorch's caching allocator, which hands it out again
    for the output: a word the kernel leaves unwritten reads as NaN, not as
    an earlier result."""
    import torch

    torch.cuda.empty_cache()
    junk = torch.full((numel,), -1, dtype=torch.int32, device=dev)
    del junk
    return fn()


def merge_verdict(label: str, args) -> dict:
    """B4's checks of one case: the select (``merge_hop``) bit for bit its
    plain version (on the CPU), payload words and have, the check first
    shown to reject a wrong select: the plain version's output for the
    same inputs with the last slot's have flipped (that slot's take, or its
    have out, changes)."""
    import torch

    from dlaf_tpu_torch.ops import panel_exchange as px

    dev = args[0].device
    ky, kh = _poisoned(lambda: px.merge_hop(*args),
                       args[0].numel() * args[0].element_size() // 4, dev)
    py, ph = px.merge_hop_plain(*(a.cpu() for a in args))
    torch.cuda.synchronize()

    def words(t):
        return t.contiguous().view(torch.int32)

    h_wrong = args[2].cpu().clone()
    h_wrong[-1] ^= 1
    wy, wh = px.merge_hop_plain(args[0].cpu(), args[1].cpu(), h_wrong, args[3].cpu())
    rejects = not (torch.equal(words(ky.cpu()), words(wy)) and torch.equal(kh.cpu(), wh))
    vs_plain = torch.equal(words(ky.cpu()), words(py)) and torch.equal(kh.cpu(), ph)
    differ = int((words(ky.cpu()) != words(py)).sum())
    problems = [f"{label}: {p}" for p, bad in (
        ("the bitwise check accepts the select with the last slot's have flipped", not rejects),
        (f"not bit for bit the plain version ({differ} words differ)", not vs_plain)) if bad]
    return {"bitwise_vs_plain": vs_plain, "words_differing": differ, "planted_rejected": rejects,
            "max_abs_err": (ky.cpu().double() - py.double()).abs().max().item(),
            "problems": problems}


def merge_phase(stamp: dict, bound, kgen) -> dict:
    """Phase 2b: B4 at path M's shape, the column panel's wire layout (16
    slots of 512^2 f32 words, mixed have masks), and at B4_CASES: the
    select (``merge_select_kernel``) bit for bit its plain version, each
    check first shown to reject a planted wrong answer, also at an offset
    of one element (element accesses).  Times of the select and the
    yardstick ``torch.where`` (its take mask computed inside the call),
    three ways: the device time alone, a CUDA graph of 20 launches replayed
    (L2 hot: the 48 MiB of operands fit in the 50 MB L2); the device time
    with L2 cold (256 MiB written before each launch, outside its own
    events); and the host's time per wrapper call.  Returns the report
    entry, its ``kernel_ms`` and ``library_ms`` the L2-cold times."""
    import torch

    from dlaf_tpu_torch.ops import panel_exchange as px

    dev = kgen.device
    slots, w = N // NB // GRID_M[0], NB * NB
    y, y_in, h, h_in = _merge_inputs(slots, w, torch.float32, "mixed", kgen)
    args = (y, y_in, h, h_in)
    checks, bad = {}, []
    v = merge_verdict("path M's panel", args)
    bad += v.pop("problems")
    checks["path M's panel"] = v
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    for cs, cw, dname, masks in B4_CASES:
        a = _merge_inputs(cs, cw, getattr(torch, dname), masks, gen)
        label = f"{cs}x{cw} {dname}, {masks}"
        v = merge_verdict(label, a)
        bad += v.pop("problems")
        checks[label] = v
        if masks == "mixed":  # the payloads one element past a 16-byte boundary
            off = []
            for t in a[:2]:
                buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
                off.append(buf[1:].view(t.shape))
                off[-1].copy_(t)
            v = merge_verdict(label + ", offset 1", (*off, *a[2:]))
            bad += v.pop("problems")
            checks[label + ", offset 1"] = v

    def where():
        return torch.where((h == 0) & (h_in != 0), y_in, y), h | h_in

    fns = {"select": lambda: px.merge_hop(*args), "torch.where": where}

    graphs = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(20):
                fn()

    def graph_ms(name, reps=5):
        graphs[name].replay()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            graphs[name].replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / (20 * reps)

    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MiB

    def cold_ms(fn, iters=20):
        fn()
        spans = []
        for i in range(iters):
            flush.fill_(i)
            torch.cuda._sleep(100_000)  # the host queues the launch before the card reaches it
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            spans.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in spans) / iters

    def host_ms(fn, iters=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3 / iters

    timings = {}
    for way, timer in (("device_hot_ms", graph_ms), ("device_cold_ms", lambda n: cold_ms(fns[n])),
                       ("host_ms_per_call", lambda n: host_ms(fns[n]))):
        timings[way] = {name: timer(name) for name in fns}
    del graphs, flush
    nbytes = 2 * slots * w * 4 + 3 * slots * 4  # the kept payload read, the output, the masks
    b_ms, b_by = bound(0.0, nbytes)
    rec = {"kernel": "merge_hop", "shape": [slots, w], "checks": checks,
           "max_abs_err": worst(c["max_abs_err"] for c in checks.values()),
           "bitwise_vs_plain": all(c["bitwise_vs_plain"] for c in checks.values()),
           "kernel_ms": timings["device_cold_ms"]["select"],
           "device_hot_ms": timings["device_hot_ms"]["select"],
           "device_cold_ms": timings["device_cold_ms"]["select"],
           "host_ms_per_call": timings["host_ms_per_call"]["select"], "timings": timings,
           "plain_ms": timed_ms(lambda: px.merge_hop_plain(*args), 20),
           "library_ms": timings["device_cold_ms"]["torch.where"],
           "library_call": "torch.where, its take mask computed in the call (L2 cold)",
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_counts": "the kept payload read, the output written, h, h_in, oh", **stamp}
    emit(rec)
    if bad:
        fail("merge_hop (the select) vs its plain version: " + "; ".join(bad))
    return rec


def ring_phases(stamp: dict, bound, kgen) -> dict:
    """Phase 2b: B4 (``merge_phase``), B5 and B7 against their twins at
    path M's shapes (f32, a 2x4 grid of rank threads on the card; the twins
    run on a CPU grid of the same shape).  Returns their report entries."""
    import torch

    from dlaf_tpu_torch.comm.grid import Grid

    dev = torch.device("cuda")
    gpu, cpu = Grid.create(GRID_M, device=dev), Grid.create(GRID_M, device="cpu")
    report = {}

    def timed_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    # ---- B4: one hop merge of the column panel's wire layout, its select
    # against its reference and its plain version, timed honestly
    report["merge_hop"] = merge_phase(stamp, bound, kgen)

    # ---- B5 at path M's shapes, on all rings of the grid at once: the pull
    # against its twin and against the hop ring it replaced, timed in turns
    # with it (hop ring, pull, pull, hop ring)
    report["ring_exchange"] = pull_phase(stamp, bound, kgen, gpu, cpu, timed_ms)

    # ---- B7 at path M's shapes, at M5's nb and at S7's f64 shapes
    report["fused_factor_bcast"] = fused_phase(stamp, bound, kgen, gpu, cpu)
    torch.cuda.empty_cache()
    return report


#: B7's cases beyond path M's (label, dtype, nb, local row tiles, tiles
#: above the diagonal): M5's nb = 192 (N padded to a whole number of tiles),
#: S7's f64 Cholesky at N = N_TIERS on the 2x4 grid at nb = 192 and 512 (the
#: latter on B1's one-block factor, by B1's gate)
FUSED_CASES = (("M5", "float32", NB_M5, -(-N // NB_M5) // GRID_M[0], 1),
               ("S7_nb192", "float64", NB_M5, -(-N_TIERS // NB_M5) // GRID_M[0], 3),
               ("S7_nb512", "float64", NB, N_TIERS // NB // GRID_M[0], 1))


def residency_record() -> dict:
    """The residency arithmetic of B7's and B8's launches on this card at
    path M's grid: G = SMs // ranks blocks a rank, one each an SM, all the
    grid's at once; B7's blocks per SM and factor team at each shape it
    runs; and, for the cluster design B7 did not take, how many clusters
    of 8 the card holds at B7's tile on an empty card against the clusters
    every rank would need at once (G / 8 a rank) and the ring blocks that
    may spin beside them."""
    import torch

    from dlaf_tpu_torch.ops import _build
    from dlaf_tpu_torch.ops import panel_exchange as px

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ranks = GRID_M[0] * GRID_M[1]
    g, fb = px.fused_geometry(sms, ranks, NB, 4)
    shapes = {"M": ("float32", NB, N // NB // GRID_M[0])}
    shapes.update({c[0]: c[1:4] for c in FUSED_CASES})
    b8 = {f"{t}_nslices{ns}": _build.lib().dlaf_ring_consumer_blocks_per_sm(
        1, int(t == "float64"), ns, n_ // NB // GRID_M[0], n_ // NB // GRID_M[1], NB, NB, g)
        for t, n_ in (("float32", N), ("float64", N_TIERS)) for ns in (0, 2, 3)}
    return {"phase": "residency", "sms": sms, "ranks": ranks, "blocks_per_rank": g,
            "blocks_of_the_grid": g * ranks, "factor_team": fb,
            "b7": {lab: px.fused_occupancy(getattr(torch, t), nb, ltr, g)
                   for lab, (t, nb, ltr) in shapes.items()},
            "b8_blocks_per_sm_at_mb512": b8,
            "cluster_design": {
                "clusters_of_8_on_an_empty_card": px.fused_occupancy(
                    torch.float32, NB, N // NB // GRID_M[0], g)["clusters_of_8_on_an_empty_card"],
                "clusters_needed_at_once": ranks * (g // 8),
                "ring_blocks_that_may_spin_beside_them": (ranks - 1) * g},
            "design": "flag team: B1's cluster body on the plain blocks of the launch"}


def fused_case(gpu, dtype_name: str, nb: int, ltr: int, above: int, gen, root: int = 1):
    """B7 on the 2x4 grid ``gpu`` (both rings over 'c' at once, root
    position ``root``) at tile side nb, ltr local tiles a rank, the first
    ``above`` of them above the diagonal (d SPD and xc standard normal from
    ``gen``): bit for bit against the unfused composition on the card
    (potrf_tile -> panel_trsm_right_lower_t -> mask -> ring_bcast: B1, B2,
    B5), the check first shown to reject the unfused result with the last
    word of rank (0, 0)'s panel flipped in its lowest bit; timed in turns
    with it (unfused, B7, B7, unfused; each the grid's span after a 1 s
    gate, ``grid_span_ms``); digests of lkk and cp (every rank).  Returns
    the record and (d, xc, below, B7's outputs, the unfused outputs)."""
    import torch

    from dlaf_tpu_torch.comm import collectives as coll
    from dlaf_tpu_torch.ops import panel_exchange as px
    from dlaf_tpu_torch.ops import panel_trsm, potrf

    dev = torch.device("cuda")
    pr, pc = GRID_M
    dtype = getattr(torch, dtype_name)
    g = torch.randn(nb, 2 * nb, generator=gen, device=dev, dtype=dtype)
    d = (g @ g.T / (2 * nb)).expand(pr, pc, nb, nb).contiguous()
    xc = torch.randn(pr, pc, ltr, nb, nb, generator=gen, device=dev, dtype=dtype)
    below = torch.arange(ltr, device=dev) >= above
    del g

    def fused(dl, xl):
        return px.fused_factor_bcast(dl, xl, below, root, "c")

    def unfused(dl, xl):
        lkk = potrf.potrf_tile(dl)
        pan = panel_trsm.panel_trsm_right_lower_t(lkk, xl.reshape(-1, nb)).reshape(xl.shape)
        cp = torch.where(below[:, None, None], pan, torch.zeros_like(pan))
        return lkk, px.ring_bcast(cp, coll.my_rank()[1] == root, "c")

    got = on_ranks(gpu, fused, [d, xc])
    ref = on_ranks(gpu, unfused, [d, xc])
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    cp_flip = ref[1].clone()
    w = cp_flip[0, 0].reshape(-1).view(torch.int32 if dtype == torch.float32 else torch.int64)
    w[-1] ^= 1
    rejects = not torch.equal(got[1], cp_flip)
    del cp_flip, w
    spans = {"unfused": [], "fused": []}
    for which in ("unfused", "fused", "fused", "unfused"):
        spans[which].append(grid_span_ms(gpu, fused if which == "fused" else unfused,
                                         [d, xc], 3)[0])
    es = d.element_size()
    solved = int(below.sum()) * nb * pr  # rows solved, once a ring
    flops = pr * pc * nb ** 3 / 3 + solved * nb * nb
    nbytes = (pr * pc * 2 * nb * nb + solved * nb + pr * pc * ltr * nb * nb) * es
    b_ms, b_by = bound(flops, nbytes)
    rec = {"dtype": dtype_name, "shape": {"d": [nb, nb], "xc": [ltr, nb, nb]},
           "tiles_solved_per_ring": int(below.sum()), "bitwise_vs_unfused": same,
           "flipped_bit_rejected": rejects, "kernel_ms": min(spans["fused"]),
           "unfused_ms": min(spans["unfused"]), "spans_ms_in_turns": spans,
           "bound_ms": b_ms, "bound_by": b_by,
           "digests": {"lkk": digest(got[0]), "cp": digest(got[1])}}
    return rec, (d, xc, below, got, ref)


def fused_phase(stamp: dict, bound, kgen, gpu, cpu) -> dict:
    """B7 (the factor-and-send body, csrc/factor_send.cuh) on the 2x4 grid
    of rank threads (``fused_case``): at path M's shape (d 512 x 512, xc
    [16, 512, 512], the first 4 tiles above the diagonal) also against its
    plain twin on a CPU grid within tol_for; then at FUSED_CASES.  Also
    B7's residency at each shape (blocks per SM, the factor's team) and
    ptxas's registers and spills."""
    import torch

    from dlaf_tpu_torch.ops import panel_exchange as px
    from dlaf_tpu_torch.testing import tol_for

    dev = torch.device("cuda")
    pr, pc = GRID_M
    root = 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def residency(dtype_name, nb, ltr):
        es = torch.empty((), dtype=getattr(torch, dtype_name)).element_size()
        return px.fused_occupancy(getattr(torch, dtype_name), nb, ltr,
                                  px.fused_geometry(sms, pr * pc, nb, es)[0])

    nb, ltr = NB, N // NB // pr
    rec, (d, xc, below, got, ref) = fused_case(gpu, "float32", nb, ltr, 4, kgen, root)
    rec["residency"] = residency("float32", nb, ltr)
    tol = tol_for("float32", nb)
    err_unfused = worst((a.double() - b.double()).abs().max().item() for a, b in zip(got, ref))
    # B7's plain twin on the same inputs (a CPU grid of the same shape)
    below_c = below.cpu()
    t0 = time.perf_counter()
    plain = on_ranks(cpu, lambda dl, xl: px.fused_factor_bcast(dl, xl, below_c, root, "c"),
                     [d.cpu(), xc.cpu()])
    plain_ms = (time.perf_counter() - t0) * 1e3
    outs = [o.cpu().double() for o in got]
    refs = [r_.double() for r_ in plain]
    err = worst((o - r_).abs().max().item() for o, r_ in zip(outs, refs))
    rel = worst((torch.linalg.vector_norm(o - r_) / torch.linalg.vector_norm(r_)).item()
                for o, r_ in zip(outs, refs))
    rec.update({"kernel": "fused_factor_bcast", "ranks": pr * pc, "ring": pc,
                "max_abs_err": err, "rel_err": rel, "tol": tol,
                "vs": "the plain twin on a CPU grid (lkk and cp of every rank)",
                "max_abs_err_vs_unfused": err_unfused,
                "unfused": "potrf_tile -> panel_trsm -> mask -> ring_bcast (B1, B2, B5)",
                "plain_ms": plain_ms, "plain_on": "cpu (the twin's ring is host objects)",
                "library_ms": None, "library_call": "none: no single PyTorch call computes it",
                "bound_counts": "potrf nb^3/3 on every rank, the solve rows*nb^2 once a ring; "
                                "bytes: d and lkk per rank, the solved tiles of the root's xc "
                                "once a ring, cp per rank",
                "ptxas": {t_: _ptxas_of(f"fused_kernel<{t_}>") for t_ in ("float", "double")},
                "body": "dlaf_tpu_torch/csrc/factor_send.cuh", **stamp})
    # the inputs' lifetime: every rank overwrites its panel and its output
    # with NaN right after its launch, on its stream; the ranks solve the
    # root's panel and copy each other's outputs where they lie, so only
    # B7's exit barrier keeps an overwrite behind the last reader.  The
    # overwritten outputs stay allocated until the check: freed, the
    # allocator would hand their memory to the next copy on the stream,
    # which writes the right bytes back
    held = []

    def fused_then_nan(dl, xl):
        res = px.fused_factor_bcast(dl, xl, below, root, "c")
        out = [t.clone() for t in res]
        xl.fill_(float("nan"))
        res[1].fill_(float("nan"))
        held.append(res)
        return out

    life = on_ranks(gpu, fused_then_nan, [d, xc.clone()])
    torch.cuda.synchronize()
    rec["input_lifetime_bitwise"] = all(torch.equal(a, b) for a, b in zip(life, got))
    del d, xc, got, ref, plain, life, held
    bad = [] if rec["bitwise_vs_unfused"] and rec["flipped_bit_rejected"] else ["M"]
    if not rec["input_lifetime_bitwise"]:
        bad.append("M, the inputs overwritten after the launch")
    for label, dtype_name, nb_, ltr_, above in FUSED_CASES:
        gen = torch.Generator(device=dev).manual_seed(SEED + 7 + nb_)
        r_, _ = fused_case(gpu, dtype_name, nb_, ltr_, above, gen, root)
        r_["residency"] = residency(dtype_name, nb_, ltr_)
        rec[f"at_{label}"] = r_
        if not (r_["bitwise_vs_unfused"] and r_["flipped_bit_rejected"]):
            bad.append(label)
        torch.cuda.empty_cache()
    emit(rec)
    if not rel <= tol:
        fail(f"fused_factor_bcast vs its plain twin: rel err {rel:.3e} > {tol:.3e}")
    if bad:
        fail(f"fused_factor_bcast vs the unfused composition: not bitwise equal, or the check "
             f"took a flipped bit, at {bad}")
    return rec


def tier_equality(stamp: dict, a_glob) -> None:
    """Phase 5b: the factor under psum, v2 and pallas on the 2x4 grid at
    N_TIERS, bucketed and lookahead, bitwise."""
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import tune

    grid = dtt.Grid.create(GRID_M)
    a = a_glob[:N_TIERS, :N_TIERS].contiguous()
    out = {}
    for variant, knobs in (("bucketed", {}), ("lookahead", {"cholesky_lookahead": True,
                                                            "trailing_update_impl": "xla"})):
        res = {}
        for tier in ("psum", "v2", "pallas"):
            tune.initialize(collectives_impl=tier, panel_trsm_pallas=True, **knobs)
            mat = dtt.DistributedMatrix.from_global(grid, a, (NB, NB))
            res[tier] = dtt.cholesky_factorization("L", mat, backend="distributed").data
        torch.cuda.synchronize()
        out[variant] = {t: torch.equal(res[t], res["v2"]) for t in ("psum", "pallas")}
        del res
    emit({"phase": "tier_equality", "n": N_TIERS, "nb": NB, "grid": list(GRID_M),
          "bitwise_equal_to_v2": out, **stamp})
    if not all(all(v.values()) for v in out.values()):
        fail(f"the collectives tiers disagree on the factor: {out}")


def path_m(stamp: dict, a_glob, rhs, factor_residual, solve_err, res_tol, kept: dict) -> dict:
    """Phase 5c: path M, M1 / M2 / M3 on the 2x4 grid of rank threads at
    N, NB.  Returns each run's launch counts; M2's lower factor goes into
    ``kept['M2']``."""
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import ops, tune
    from dlaf_tpu_torch.matrix import layout

    n, nb = N, NB
    grid = dtt.Grid.create(GRID_M)
    ranks = grid.size
    gflop = n ** 3 / 3 / 1e9
    counts_by = {}

    def factor_run():
        mat = dtt.DistributedMatrix.from_global(grid, a_glob, (nb, nb))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fac = dtt.cholesky_factorization("L", mat, backend="distributed")
        torch.cuda.synchronize()
        return fac, time.perf_counter() - t0, launch_counts()

    for label, knobs, desc in (("M1", PATH_M1, "bucketed"),
                               ("M2", PATH_M2, "lookahead, trailing_update_impl=xla")):
        tune.initialize(**knobs)
        factor_run()  # warm-up: the ring states (landing slots, flags) are made here
        fac, wall, counts = factor_run()
        res = factor_residual(fac)
        if label == "M2":
            kept["M2"] = torch.tril(layout.unpack(fac.data, fac.dist)[:n, :n])
        del fac
        torch.cuda.empty_cache()
        counts_by[label] = counts
        emit({"phase": f"path_{label}", "config": f"{desc}, collectives_impl=pallas, "
              "panel_trsm_pallas=1", "grid": list(GRID_M), "n": n, "nb": nb, "wall_s": wall,
              "gflops": gflop / wall, "factor_residual": res, "tol": res_tol,
              "launches": counts, "launches_per_rank": {k: v / ranks for k, v in counts.items()},
              **stamp})
        if not res <= res_tol:
            fail(f"path {label} residual {res:.3e} > {res_tol:.3e}")
        need = ("potrf", "panel_trsm", "ring_exchange") if label == "M1" \
            else ("fused_factor_bcast", "ring_exchange")
        if min(counts[k] for k in need) <= 0 or counts["potrf_cluster"] != counts["potrf"]:
            fail(f"path {label} did not launch {need} (B1 on the cluster): {counts}")
        if label == "M2" and counts["fused_factor_bcast"] != ranks * (n // nb):
            fail(f"path M2 launched B7 {counts['fused_factor_bcast']} times, not "
                 f"{ranks} ranks x {n // nb} panels")

    tune.initialize(collectives_impl="pallas", panel_trsm_pallas=True)
    mat_a = dtt.DistributedMatrix.from_global(grid, a_glob, (nb, nb))
    mat_b = dtt.DistributedMatrix.from_global(grid, rhs.clone(), (nb, nb))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    x, info = dtt.positive_definite_solver("L", mat_a, mat_b, return_info=True)
    info = int(info)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    counts_by["M3"] = counts
    serr = solve_err(layout.unpack(x.data, x.dist)[:n, :nb])
    del mat_a, mat_b, x
    torch.cuda.empty_cache()
    emit({"phase": "path_M3", "config": "positive_definite_solver(return_info=True), "
          "collectives_impl=pallas, panel_trsm_pallas=1", "grid": list(GRID_M), "n": n,
          "nrhs": nb, "wall_s": wall, "info": info, "solve_forward_err": serr, "tol": res_tol,
          "launches": counts, "launches_per_rank": {k: v / ranks for k, v in counts.items()},
          **stamp})
    if info != 0 or not serr <= res_tol:
        fail(f"path M3 info {info}, solve error {serr:.3e}")
    if min(counts[k] for k in ("potrf", "panel_trsm", "ring_exchange")) <= 0 \
            or counts["potrf_cluster"] != counts["potrf"]:
        fail(f"path M3 did not launch B1 (on the cluster), B2 and B5: {counts}")
    return counts_by


def _rel_frob(got, want) -> tuple[float, float]:
    """Max abs error and relative Frobenius error of ``got`` against ``want``
    (both moved to the CPU, in float64)."""
    import torch

    g, w = got.cpu().double(), want.cpu().double()
    d = g - w
    den = torch.linalg.vector_norm(w).item()
    return d.abs().max().item(), torch.linalg.vector_norm(d).item() / (den if den > 0 else 1.0)


CONSUME_KERNELS = ("dma_ring_consume", "fused_step", "panel_contract")


def _bits(t):
    """The raw words of a float tensor: signed zeros and NaN payloads count."""
    import torch

    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def digest(t) -> str:
    """sha256 of a tensor's raw bytes (bitwise comparisons across processes)."""
    import hashlib

    import torch

    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8).numpy()).hexdigest()


def b3_bitwise_verdict(label: str, xk, x0, cp, panel, applied, tier: str = "default") -> dict:
    """The ring consumers' bitwise check: ``xk`` (x after B6, or after B8,
    whose later phases leave x as its consume phase wrote it; stacked
    [Pr, Pc, ltr, ltc, M, N]) bit for bit B3 at ``tier`` (B3-split under
    'bf16x3' / 'bf16x6') applied once on every rank to ``x0`` with
    ``panel`` (the merged panel the kernel returned, [Pr, Pc, ltc, N, K])
    masked to the ``applied`` slots ([Pr, Pc, ltc] bool), every other slot
    zero.  Each output of a consume update takes one slot, so the kernel's
    chain is B3's.  The check is first shown to reject B3's output with the
    last k16 slice of one applied slot dropped (the first applied slot whose
    last k16 slice meets a non-zero one of cp: the rows above step k are
    zero)."""
    import torch

    from dlaf_tpu_torch.ops import trailing_update as tu

    zero = torch.zeros((), dtype=panel.dtype, device=panel.device)
    masked = torch.where(applied[..., None, None], panel, zero)
    want = x0.clone()
    pr, pc = x0.shape[:2]
    for r in range(pr):
        for c in range(pc):
            tu.trailing_update(want[r, c], cp[r, c].contiguous(), masked[r, c].contiguous(),
                               tu.CHOLESKY_SUBSCRIPTS, tier)
    # the first applied slot whose last k slice meets a non-zero one of cp
    kd = _k_dropped(panel.shape[-1])
    live = (masked[..., kd:] != 0).flatten(-2).any(-1) & (cp[..., kd:] != 0).flatten(2).any(-1)[
        ..., None]
    r, c, s_ = (int(v) for v in (applied & live).nonzero()[0])
    dropped = masked[r, c].clone()
    dropped[s_, :, kd:] = 0
    wrong = tu.trailing_update(x0[r, c].clone(), cp[r, c].contiguous(), dropped,
                               tu.CHOLESKY_SUBSCRIPTS, tier)
    torch.cuda.synchronize()
    rejects = not torch.equal(_bits(wrong), _bits(want[r, c]))
    bitwise = torch.equal(_bits(xk), _bits(want))
    differ = 0 if bitwise else int((_bits(xk) != _bits(want)).sum())
    del want, wrong, masked, dropped
    problems = [f"{label}: {p}" for p, bad in (
        (f"the bitwise check accepts B3 at {tier} with the last k16 slice of one applied slot "
         "dropped", not rejects),
        (f"x not bit for bit B3 at {tier} on the merged, masked panel ({differ} elements "
         "differ)", not bitwise)) if bad]
    return {"bitwise_vs_b3": bitwise, "b3_tier": tier, "elements_differing_vs_b3": differ,
            "dropped_slice_rejected": rejects, "applied_slots": int(applied.sum()),
            "problems": problems}


def consume_phases(stamp: dict, bound, timed_ms, a_glob, only=CONSUME_KERNELS,
                   digests: bool = False) -> dict:
    """Phase 2c: B6, B8 and B9 against their twins at the paths' shapes
    (f32, a 2x4 grid of rank threads on the card; the twins run on a CPU
    grid of the same shape), with their times.  The inputs of B6 and B8 are
    step 0 of the paths that launch them, on the main path's matrix (panel
    0 made by B7): B6 at M5's nb=192 on its padded geometry, and again at
    M4's nb=512 as B8's consume part; B8 on M4's, so that it factors a
    positive definite tile.  B9's are standard normal, at path I's widest
    step; its FMA body is also held bit for bit to the reference kernel (the
    first body) on every rank, the check first shown to reject the reference
    with its last k slice dropped, and timed in turns with it.  ``only``
    picks the kernels to check (the planted-fault runs of
    scripts/planted_faults.py take one).  B6 (at both steps 0 and on the
    ring of 4) and B8 are also held bit for bit to B3 on the merged panel
    they return, masked to the slots they apply (:func:`b3_bitwise_verdict`),
    and B6 is run and timed with every slot suppressed (the ring alone: the
    transport, the merges and the waits, x untouched).  ``digests`` adds
    sha256 digests of their outputs to the records (scripts/consume_ab.py
    compares two checkouts by them).  Returns their report entries."""
    import torch

    from dlaf_tpu_torch import tune
    from dlaf_tpu_torch.algorithms import _spmd
    from dlaf_tpu_torch.algorithms import cholesky as chol
    from dlaf_tpu_torch.comm import collectives as coll
    from dlaf_tpu_torch.comm.grid import Grid
    from dlaf_tpu_torch.ops import panel_exchange as px
    from dlaf_tpu_torch.ops import trailing_update as tu
    from dlaf_tpu_torch.testing import tol_for

    dev = torch.device("cuda")
    pr, pc = GRID_M
    ranks = pr * pc
    gpu, cpu = Grid.create(GRID_M, device=dev), Grid.create(GRID_M, device="cpu")
    report, bad = {}, []
    tune.initialize(**PATH_M4)
    k, k1 = 0, 1
    to_cpu = lambda ts: [t.cpu() for t in ts]  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def step0(nb):
        """Step 0 at block size nb (``_step0``)."""
        return _step0(gpu, a_glob, nb, k)

    def b6_work(g, nb, have, supp):
        """B6's work at step 0: the slots held somewhere on each rank's ring
        over 'r', without the suppressed one, every rank; its bytes."""
        tile = nb * nb * 4
        applied = int((have.any(dim=0, keepdim=True).expand_as(have) & ~supp).sum())
        flops = 2.0 * nb ** 3 * g.ltr * applied
        nbytes = ranks * (2 * g.ltr * g.ltc * tile + g.ltr * tile + 2 * g.ltc * tile)
        return applied, flops, nbytes

    def b6(x, tk, hv, c, z):
        _, y, h = tu.dma_ring_consume(x, tk, hv.to(torch.int32).reshape(-1, 1), c,
                                      z.to(torch.int32).reshape(-1, 1), "r")
        return y, h

    def b6_check(path, role, nb, g, x0, cp, taken, have, supp):
        """B6 over 'r' on step 0 of ``path``: yf and h bitwise and the
        applied update within tol_for(f32, nb) against the twin on a CPU
        grid, x bit for bit B3 on the merged, masked panel, a skewed run
        bitwise the unskewed one, the ring alone (every slot suppressed),
        its time, bound and yardstick.  Emits and returns its record."""
        tol = tol_for("float32", nb)
        applied, flops, nbytes = b6_work(g, nb, have, supp)
        x_cpu0 = x0.to("cpu", copy=True)
        xk = x0.clone()
        got = on_ranks(gpu, b6, [xk, taken, have, cp, supp])
        torch.cuda.synchronize()
        held = have.any(dim=0, keepdim=True).expand_as(have)
        b3 = b3_bitwise_verdict(f"dma_ring_consume on step 0 of {path}", xk, x0, cp, got[0],
                                held & ~supp)
        bad.extend(b3.pop("problems"))
        outs = {"x": digest(xk), "yf": digest(got[0]), "h": digest(got[1])} if digests else None
        xt = x0.to("cpu", copy=True)
        t0 = time.perf_counter()
        ref = on_ranks(cpu, lambda x, tk, hv, c, z: tu.dma_ring_consume_plain(
            x, tk, hv.to(torch.int32).reshape(-1, 1), c, z.to(torch.int32).reshape(-1, 1), "r")[1:],
            [xt] + to_cpu([taken, have, cp, supp]))
        plain_ms = (time.perf_counter() - t0) * 1e3
        same = all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))
        err_abs, rel = _rel_frob(xk.cpu() - x_cpu0, xt - x_cpu0)
        del xt, ref, x_cpu0
        # skewed run: rank (0, 1) sleeps 50 ms before each launch; the kernel's
        # result is deterministic, so its x must be the unskewed run's, bitwise
        xs = x0.clone()
        px.launch_delay_s[(0, 1)] = 0.05
        try:
            got_s = on_ranks(gpu, b6, [xs, taken, have, cp, supp])
            torch.cuda.synchronize()
        finally:
            px.launch_delay_s.clear()
        skew_ok = torch.equal(xs, xk) and all(torch.equal(a, b) for a, b in zip(got_s, got))
        del got_s
        # the ring alone: every slot suppressed, so nothing is applied and x
        # stays as it was, bitwise, and the panel and have are the same
        ring_args = [xs, taken, have, cp, torch.ones_like(supp)]
        xs.copy_(x0)
        got_r = on_ranks(gpu, b6, ring_args)
        torch.cuda.synchronize()
        ring_ok = torch.equal(_bits(xs), _bits(x0)) and all(
            torch.equal(a, b) for a, b in zip(got_r, got))
        del got_r
        same = same and torch.equal(got[1].reshape(pr, pc, -1) != 0, held)
        b_ms, b_by = bound(flops, nbytes)
        span_ms, enq_ms = grid_span_ms(gpu, b6, [xk, taken, have, cp, supp], 3)
        ring_ms, _ = grid_span_ms(gpu, b6, ring_args, 3)
        del xs, ring_args
        # yardstick: B5's copy_ of the exchanged panel into every rank's buffer,
        # and one baddbmm_ per rank over the same tile pairs
        union = got[0].reshape(ranks, -1)
        src = union[0].clone()
        a_exp = cp[0, 0].unsqueeze(1).expand(g.ltr, g.ltc, nb, nb).reshape(-1, nb, nb)
        b_exp = taken[0, 0].transpose(-1, -2).unsqueeze(0).expand(g.ltr, g.ltc, nb, nb).reshape(
            -1, nb, nb)
        xv = xk[0, 0].reshape(-1, nb, nb)

        def library():
            union.copy_(src.expand_as(union))
            for _ in range(ranks):
                xv.baddbmm_(a_exp, b_exp, alpha=-1)

        lib_ms = timed_ms(library, 3)
        del union, src, a_exp, b_exp, xv, xk, got
        torch.cuda.empty_cache()
        rec = {"kernel": "dma_ring_consume", "step0_of": path, "role": role, "nb": nb,
               "mt": g.mt, "shape": {"x": [g.ltr, g.ltc, nb, nb], "yf": [g.ltc, nb, nb]},
               "ranks": ranks, "ring": "r", "ring_length": pr, "applied_slots": applied,
               "bitwise_vs_plain_yf_h": same, "max_abs_err": err_abs, "rel_err": rel, "tol": tol,
               "vs": "the plain twin on a CPU grid (the applied update x' - x)", **b3,
               "b3_check": "x bit for bit B3 ('default') on the merged panel, the slots not "
                           "applied zero",
               "skewed_run_bitwise": skew_ok, "kernel_ms": span_ms, "enqueue_ms_of_3_calls": enq_ms,
               "ring_alone_ms": ring_ms, "ring_alone_share": ring_ms / span_ms,
               "ring_alone_x_untouched": ring_ok,
               "plain_ms": plain_ms, "plain_on": "cpu (the twin's ring is host objects)",
               "library_ms": lib_ms,
               "library_call": "B5's copy_ of the panel to every rank plus one baddbmm_ per rank",
               "bound_ms": b_ms, "bound_by": b_by,
               "bound_counts": "2 nb^3 per applied (i, j) pair; bytes: x read and written, cp, "
                               "the panel read and the merged panel written, every rank", **stamp}
        if outs is not None:
            rec["digests"] = outs
        emit(rec)
        if not (same and rel <= tol and skew_ok and ring_ok):
            bad.append(f"dma_ring_consume on step 0 of {path}: yf/h bitwise {same}, rel err "
                       f"{rel:.3e} (tol {tol:.3e}), skewed run bitwise {skew_ok}, ring alone "
                       f"leaves x and the panel as they were {ring_ok}")
        return rec

    if "dma_ring_consume" in only:
        # ---- B6 on step 0 of M5, the path that launches it (nb=192, padded)
        g5, *s5 = step0(NB_M5)
        report["dma_ring_consume"] = b6_check("M5", "the two-piece path's update", NB_M5, g5,
                                              *s5[:5])
        del g5, s5
        torch.cuda.empty_cache()

        # ---- B6 on a ring of 4 ('c', 3 hops: the capacity acks are in use)
        nb, tol = NB, tol_for("float32", NB)
        ltr4, slots4 = 4, 8
        xc = torch.randn(pr, pc, ltr4, slots4, nb, nb, generator=gen, device=dev)
        cc = torch.randn(pr, pc, ltr4, nb, nb, generator=gen, device=dev)
        yc = torch.randn(pr, pc, slots4, nb, nb, generator=gen, device=dev)
        hc = torch.zeros(pr, pc, slots4, dtype=torch.bool, device=dev)
        for s_ in range(slots4 - 1):  # one contributor per slot, the last slot none
            hc[:, s_ % pc, s_] = True
        zc = torch.zeros_like(hc)
        zc[:, 2, 6] = True

        def b6c(x, tk, hv, c, z):
            _, y, h = tu.dma_ring_consume(x, tk, hv.to(torch.int32).reshape(-1, 1), c,
                                          z.to(torch.int32).reshape(-1, 1), "c")
            return y, h

        xk = xc.clone()
        got = on_ranks(gpu, b6c, [xk, yc, hc, cc, zc])
        b3_4 = b3_bitwise_verdict("dma_ring_consume on a ring of 4", xk, xc, cc, got[0],
                                  hc.any(dim=1, keepdim=True).expand_as(hc) & ~zc)
        bad.extend(b3_4.pop("problems"))
        xt = xc.to("cpu", copy=True)
        ref = on_ranks(cpu, lambda x, tk, hv, c, z: tu.dma_ring_consume_plain(
            x, tk, hv.to(torch.int32).reshape(-1, 1), c, z.to(torch.int32).reshape(-1, 1), "c")[1:],
            [xt] + to_cpu([yc, hc, cc, zc]))
        torch.cuda.synchronize()
        same4 = all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))
        err4, rel4 = _rel_frob(xk.cpu() - xc.cpu(), xt - xc.cpu())
        ring4 = {"axis": "c", "x": [ltr4, slots4, nb, nb], "bitwise_vs_plain_yf_h": same4,
                 "max_abs_err": err4, "rel_err": rel4, **b3_4}
        if digests:
            ring4["digests"] = {"x": digest(xk), "yf": digest(got[0]), "h": digest(got[1])}
        report["dma_ring_consume"]["ring_of_4"] = ring4
        emit({"kernel": "dma_ring_consume", "ring_of_4": ring4, **stamp})
        if not (same4 and rel4 <= tol):
            bad.append(f"dma_ring_consume on a ring of 4: yf/h bitwise {same4}, rel err {rel4:.3e}")
        del xc, cc, yc, hc, zc, xk, xt, got, ref
        torch.cuda.empty_cache()

    if "dma_ring_consume" in only or "fused_step" in only:
        # ---- step 0 of M4: B6 as B8's consume part, then B8
        nb, tol = NB, tol_for("float32", NB)
        g, x0, cp, taken, have, supp, below1 = step0(nb)
        params = (k1 % g.pc, k1 % g.pr, k1 // g.pc, k1 // g.pr, k1 // g.pc)
        if "dma_ring_consume" in only:
            report["dma_ring_consume"]["at_M4"] = b6_check(
                "M4", "B8's consume part (M4 runs B6's body inside B8)", nb, g, x0, cp, taken,
                have, supp)

        # ---- B8: step 0 of M4, against its twin and the card's two-piece step
        if "fused_step" in only:
            def b8(x, tk, hv, c, z, bl):
                return tu.fused_step(x, tk, hv, z, c, bl, params)[1:]

            def two_piece(x, tk, hv, c, z, bl):
                myr, myc = coll.my_rank()
                gi = _spmd.local_row_tiles(g, myr, x.device)
                _, rp = tu.fused_transpose_update(x, c, tk, hv, z, "r")
                l_next = params[2]
                if myc == params[0]:
                    xc1 = x[:, l_next]
                    xc1 -= torch.einsum("iab,cb->iac", c, rp[l_next])
                d1 = _spmd.bcast_diag_tile(x, k1, g, myr, myc)
                lkk1, cp1 = chol._fused_panel_bcast(d1, x[:, l_next], gi > k1, params[0])
                return rp, lkk1, cp1, d1

            _, flops, nbytes = b6_work(g, nb, have, supp)
            tile = nb * nb * 4
            x_cpu0 = x0.to("cpu", copy=True)
            args = [taken, have, cp, supp, below1]
            xk, xu = x0.clone(), x0.clone()
            got = on_ranks(gpu, b8, [xk] + args)
            unf = on_ranks(gpu, two_piece, [xu] + args)
            torch.cuda.synchronize()
            xt = x0.to("cpu", copy=True)
            t0 = time.perf_counter()
            ref = on_ranks(cpu, b8, [xt] + to_cpu(args))
            plain_ms = (time.perf_counter() - t0) * 1e3
            names = ("rp", "lkk1", "cp1", "d1")
            errs = {"x": _rel_frob(xk.cpu() - x_cpu0, xt - x_cpu0)}
            errs.update({nm: _rel_frob(a, b) for nm, a, b in zip(names, got, ref)})
            errs_unf = {"x": _rel_frob(xk - x0, xu - x0)}
            errs_unf.update({nm: _rel_frob(a, b) for nm, a, b in zip(names, got, unf)})
            rp_same = torch.equal(got[0].cpu(), ref[0])
            # x bit for bit B3 on the merged panel, masked to B8's applied slots:
            # those held on the ring over 'r' and not suppressed, and slot l_next
            # on the ranks of column k+1 (the narrow update)
            held = have.any(dim=0, keepdim=True).expand_as(have)
            narrow = torch.zeros_like(supp)
            narrow[:, params[0], params[2]] = True
            b3_8 = b3_bitwise_verdict("fused_step's consume phase on step 0 of M4", xk, x0, cp,
                                      got[0], held & (~supp | narrow))
            bad.extend(b3_8.pop("problems"))
            worst_twin = worst(e[1] for e in errs.values())
            worst_unf = worst(e[1] for e in errs_unf.values())
            rows_solved = int(below1[:, params[0]].sum()) * nb  # once a ring over 'c'
            flops8 = flops + ranks * nb ** 3 / 3 + rows_solved * nb * nb
            nbytes8 = nbytes + ranks * 3 * tile + pr * g.ltr * tile + ranks * g.ltr * tile
            b_ms8, b_by8 = bound(flops8, nbytes8)
            outs8 = ({nm: digest(t) for nm, t in zip(("x",) + names, [xk] + list(got))}
                     if digests else None)
            span8, enq8 = grid_span_ms(gpu, b8, [xk] + args, 3)
            span_unf, enq_unf = grid_span_ms(gpu, two_piece, [xu] + args, 3)
            rec = {"kernel": "fused_step",
                   "shape": {"x": [g.ltr, g.ltc, nb, nb], "cp": [g.ltr, nb, nb]},
                   "ranks": ranks, "step": k, "rel_err": {nm: e[1] for nm, e in errs.items()},
                   "max_abs_err": worst(e[0] for e in errs.values()),
                   "rp_bitwise_vs_plain": rp_same, **b3_8,
                   "tol": tol, "vs": "the plain twin on a CPU grid (x as the applied update)",
                   "rel_err_vs_two_piece": {nm: e[1] for nm, e in errs_unf.items()},
                   "two_piece": "dma_ring_consume -> narrow einsum -> bcast_diag_tile -> "
                                "fused_factor_bcast (B6, B5, B7) on the card",
                   "kernel_ms": span8, "two_piece_ms": span_unf,
                   "enqueue_ms_of_3_calls": {"fused_step": enq8, "two_piece": enq_unf},
                   "plain_ms": plain_ms, "plain_on": "cpu (the twin's rings are host objects)",
                   "library_ms": None, "library_call": "none: no single PyTorch call computes it",
                   "bound_ms": b_ms8, "bound_by": b_by8,
                   "bound_counts": "B6's, plus potrf nb^3/3 on every rank and the solve "
                                   "rows*nb^2 once a ring over 'c'; bytes: B6's, d, lkk and "
                                   "the diagonal tile per rank, the root's panel column once "
                                   "a ring, cp1 per rank",
                   "ptxas": {f"fused_step_kernel<float, {ns}>":
                             _ptxas_of(f"fused_step_kernel<float, {ns}>") for ns in (0, 2, 3)},
                   "body": "dlaf_tpu_torch/csrc/consume_gemm.cuh; the tail "
                           "dlaf_tpu_torch/csrc/factor_send.cuh", **stamp}
            if outs8 is not None:
                rec["digests"] = outs8
            # the inputs' lifetime: every rank overwrites its trailing stack and
            # its cp1 with NaN right after its launch, on its stream; the tail
            # reads the owner's diagonal tile, the root's column k+1 and the
            # other ranks' cp1 where they lie, so only B8's exit barrier keeps
            # an overwrite behind the last reader (the overwritten cp1 stays
            # allocated until the check, as in fused_phase)
            held = []

            def b8_then_nan(x, tk, hv, c, z, bl):
                res = tu.fused_step(x, tk, hv, z, c, bl, params)
                out = [t.clone() for t in res[1:]]
                x.fill_(float("nan"))
                res[3].fill_(float("nan"))
                held.append(res)
                return out

            life = on_ranks(gpu, b8_then_nan, [x0.clone()] + args)
            torch.cuda.synchronize()
            rec["input_lifetime_bitwise"] = all(torch.equal(a, b) for a, b in zip(life, got))
            del life, held
            if not rec["input_lifetime_bitwise"]:
                bad.append("fused_step: its outputs differ when every rank overwrites its stack "
                           "right after its launch")
            emit(rec)
            if not (worst_twin <= tol and rp_same and worst_unf <= tol):
                bad.append(f"fused_step: rel err vs twin {worst_twin:.3e}, vs the two-piece step "
                           f"{worst_unf:.3e} (tol {tol:.3e}), rp bitwise {rp_same}")
            report["fused_step"] = rec
            del xk, xu, xt, got, unf, ref
        del x0, cp, taken, have, supp, below1
    torch.cuda.empty_cache()

    # ---- B9: path I's widest step, both forms, all ranks at once
    if "panel_contract" in only:
        nb, tol = NB, tol_for("float32", NB)
        big = torch.randn(pr, pc, 16, 8, nb, nb, generator=gen, device=dev)
        small_l = torch.randn(pr, pc, 8, nb, nb, generator=gen, device=dev)
        small_u = torch.randn(pr, pc, 16, nb, nb, generator=gen, device=dev)
        forms = {}
        kd = _k_dropped(nb)
        for sub, ops_ in ((tu.TRTRI_LOWER_SUBSCRIPTS, [big, small_l]),
                          (tu.TRTRI_UPPER_SUBSCRIPTS, [small_u, big])):
            fn = lambda a, b, sub=sub: (tu.panel_contract(a, b, sub),)  # noqa: E731
            fn_ref = lambda a, b, sub=sub: (tu.panel_contract_reference(a, b, sub),)  # noqa: E731
            got = on_ranks(gpu, fn, ops_)[0]
            # before/after: the reference kernel (the first body) on the same
            # operands, and with its last k slice dropped (a [..., K], b [..., K, N])
            before = on_ranks(gpu, fn_ref, ops_)[0]
            dropped = on_ranks(gpu, fn_ref, [ops_[0][..., :kd].contiguous(),
                                             ops_[1][..., :kd, :].contiguous()])[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = on_ranks(cpu, fn, to_cpu(ops_))[0]
            plain_ms = (time.perf_counter() - t0) * 1e3
            verdict = fma_verdict(f"panel_contract[{sub}]", got, before, dropped, ref.to(dev), tol)
            bad += verdict.pop("problems")
            del before, dropped
            err_abs, rel = _rel_frob(got, ref)
            turns = [grid_span_ms(gpu, fn_ref, ops_, 5), grid_span_ms(gpu, fn, ops_, 5),
                     grid_span_ms(gpu, fn, ops_, 5), grid_span_ms(gpu, fn_ref, ops_, 5)]
            span, enq = (turns[1][0] + turns[2][0]) / 2, turns[1][1]
            a0, b0 = ops_[0][0, 0], ops_[1][0, 0]
            lib_ms = timed_ms(lambda: [torch.einsum(sub, a0, b0) for _ in range(ranks)], 3)
            flops9 = ranks * 2.0 * 16 * 8 * nb ** 3
            small = ops_[1 if sub == tu.TRTRI_LOWER_SUBSCRIPTS else 0]
            nbytes9 = ranks * (big[0, 0].numel() + small[0, 0].numel() + got[0, 0].numel()) * 4
            b9, by9 = bound(flops9, nbytes9)
            vec = _vec_copies(ops_[0], ops_[1], nb, nb)
            forms[sub] = {"shape": {"a": list(ops_[0].shape[2:]), "b": list(ops_[1].shape[2:])},
                          "max_abs_err": err_abs, "rel_err": rel, "tol": tol, "kernel_ms": span,
                          "reference_ms": (turns[0][0] + turns[3][0]) / 2,
                          "turns_ms": {"reference": [turns[0][0], turns[3][0]],
                                       "fma_body": [turns[1][0], turns[2][0]]},
                          **{k: verdict[k] for k in ("bitwise_vs_reference", "elements_differing",
                                                     "dropped_slice_rejected")},
                          "copies": "16-byte" if vec else "element",
                          "ptxas": _fma_ptxas("panel_contract_fma_kernel", "float",
                                              0 if sub == tu.TRTRI_LOWER_SUBSCRIPTS else 1, vec),
                          "enqueue_ms_of_5_calls": enq, "plain_ms": plain_ms, "library_ms": lib_ms,
                          "bound_ms": b9, "bound_by": by9}
            emit({"kernel": "panel_contract", "subscripts": sub, "ranks": ranks, **forms[sub],
                  "plain_on": "cpu (torch.einsum per rank)",
                  "library_call": "torch.einsum, one per rank", **stamp})
            if not rel <= tol:
                bad.append(f"panel_contract[{sub}]: rel err {rel:.3e} > {tol:.3e}")
            del got, ref
        report["panel_contract"] = {**forms[tu.TRTRI_LOWER_SUBSCRIPTS], "forms": forms}
        del big, small_l, small_u
        torch.cuda.empty_cache()
    if bad:
        fail("ring consumers and panel contraction vs their plain versions: " + "; ".join(bad))
    return report


def path_fused(stamp: dict, a_glob, factor_residual, res_tol, kept: dict) -> dict:
    """Phase 5d: the fused trailing-update tier on the 2x4 grid: M4
    (lookahead Cholesky, B8 per step), its info on a non-SPD input against
    the 'xla' tier's, M5 (nb=192: B6 per step, B7 per panel), S6 (M5 under
    bf16x3: B6's split body per step), S7 (float64 at N_TIERS: B8's and B6's
    split bodies at bf16x6, and 'auto', which splits B8 and not B6), path I
    (triangular_inverse of M4's factor: B9 per step) and S4 (path I under
    bf16x3: B9's split body per step; then POTRI at N_TIERS), each residual
    first shown to reject a wrong answer.  Returns each run's launch
    counts."""
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import ops, tune
    from dlaf_tpu_torch.matrix import layout
    from dlaf_tpu_torch.testing import tol_for

    n = N
    grid = dtt.Grid.create(GRID_M)
    ranks = grid.size
    gflop = n ** 3 / 3 / 1e9
    counts_by = {}

    def timed(fn):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, launch_counts()

    def factor(a, nb, **kw):
        mat = dtt.DistributedMatrix.from_global(grid, a, (nb, nb))
        return dtt.cholesky_factorization("L", mat, backend="distributed", **kw)

    def rel_f(got, want):
        d = torch.linalg.matrix_norm(got.double() - want.double())
        return (d / torch.linalg.matrix_norm(want.double())).item()

    # ---- M4: lookahead Cholesky, fused tier, nb = NB
    tune.initialize(**PATH_M4)
    factor(a_glob, NB)  # warm-up: the ring states are made here
    fac4, wall, counts = timed(lambda: factor(a_glob, NB))
    res = factor_residual(fac4)
    low4 = torch.tril(layout.unpack(fac4.data, fac4.dist)[:n, :n])
    vs_m2 = rel_f(low4, kept["M2"])
    wrong = rel_f(torch.tril(a_glob), kept["M2"])  # the check rejects A's own lower triangle
    del kept["M2"]
    mt = -(-n // NB)
    counts_by["M4"] = counts
    emit({"phase": "path_M4", "config": "lookahead, trailing_update_impl=fused, "
          "collectives_impl=pallas, panel_trsm_pallas=1", "grid": list(GRID_M), "n": n, "nb": NB,
          "mt": mt, "wall_s": wall, "gflops": gflop / wall, "factor_residual": res,
          "rel_err_vs_M2_factor": vs_m2, "rel_err_vs_M2_of_tril_A": wrong, "tol": res_tol,
          "launches": counts, "launches_per_rank": {k_: v / ranks for k_, v in counts.items()},
          **stamp})
    if not (res <= res_tol and vs_m2 <= res_tol < wrong):
        fail(f"path M4 residual {res:.3e}, vs M2 {vs_m2:.3e}, wrong answer {wrong:.3e} "
             f"(tol {res_tol:.3e})")
    if counts["fused_step"] != ranks * (mt - 1) or counts["fused_factor_bcast"] != ranks \
            or counts["trailing_update"] or counts["dma_ring_consume"]:
        fail(f"path M4 launched B8 {counts['fused_step']} times (want {ranks * (mt - 1)}), "
             f"B7 {counts['fused_factor_bcast']} (want {ranks}): {counts}")
    del low4
    torch.cuda.empty_cache()

    # ---- the info of a non-SPD input at N_TIERS: a negative pivot in tile
    # 3, owned by rank (1, 3), as the 'xla' tier finds it
    bad = a_glob[:N_TIERS, :N_TIERS].clone()
    piv = 3 * NB + 5
    bad[piv, piv] = -50.0
    infos = {}
    for label, knobs in (("xla", PATH_M2), ("fused", PATH_M4)):
        tune.initialize(**knobs)
        infos[label] = int(factor(bad, NB, return_info=True)[1])
    spd_info = int(factor(a_glob[:N_TIERS, :N_TIERS].clone(), NB, return_info=True)[1])
    emit({"phase": "path_M4_info", "n": N_TIERS, "nb": NB, "planted_pivot": piv + 1,
          "info": infos, "info_of_the_spd_input": spd_info, **stamp})
    if not (infos["fused"] == infos["xla"] == piv + 1 and spd_info != infos["xla"]):
        fail(f"path M4 info on a non-SPD input {infos}, want {piv + 1} (SPD input: {spd_info})")
    del bad

    # ---- M5: the same knobs at nb = NB_M5 (the two-piece path: B6, B7)
    factor(a_glob, NB_M5)  # warm-up
    fac5, wall, counts = timed(lambda: factor(a_glob, NB_M5))
    res = factor_residual(fac5)
    del fac5
    torch.cuda.empty_cache()
    mt5 = -(-n // NB_M5)
    counts_by["M5"] = counts
    emit({"phase": "path_M5", "config": "lookahead, trailing_update_impl=fused, "
          "collectives_impl=pallas, panel_trsm_pallas=1", "grid": list(GRID_M), "n": n,
          "nb": NB_M5, "mt": mt5, "padded_n": mt5 * NB_M5, "wall_s": wall, "gflops": gflop / wall,
          "factor_residual": res, "tol": res_tol, "launches": counts,
          "launches_per_rank": {k_: v / ranks for k_, v in counts.items()}, **stamp})
    if not res <= res_tol:
        fail(f"path M5 residual {res:.3e} > {res_tol:.3e}")
    if counts["dma_ring_consume"] != ranks * (mt5 - 1) or counts["fused_step"] \
            or counts["fused_factor_bcast"] != ranks * mt5:
        fail(f"path M5 launched B6 {counts['dma_ring_consume']} times (want "
             f"{ranks * (mt5 - 1)}), B8 {counts['fused_step']}, B7 "
             f"{counts['fused_factor_bcast']} (want {ranks * mt5}): {counts}")

    # ---- S6: M5 under bf16x3 (B6's split body per step and rank)
    tune.initialize(**PATH_S6)
    fac6, wall, counts = timed(lambda: factor(a_glob, NB_M5))
    res = factor_residual(fac6)
    del fac6
    torch.cuda.empty_cache()
    counts_by["S6"] = counts
    emit({"phase": "path_S6", "config": "M5 (nb=192) under gemm_precision=bf16x3: lookahead, "
          "trailing_update_impl=fused, collectives_impl=pallas, panel_trsm_pallas=1",
          "grid": list(GRID_M), "n": n, "nb": NB_M5, "wall_s": wall, "gflops": gflop / wall,
          "factor_residual": res, "tol": res_tol, "launches": counts,
          "launches_per_rank": {k_: v / ranks for k_, v in counts.items()}, **stamp})
    if not res <= res_tol:
        fail(f"path S6 residual {res:.3e} > {res_tol:.3e}")
    if not (counts["dma_ring_consume"] == counts["dma_ring_consume_split"] == ranks * (mt5 - 1)
            and counts["fused_step"] == 0):
        fail(f"path S6 launched B6 {counts['dma_ring_consume']} times, its split body "
             f"{counts['dma_ring_consume_split']} (want {ranks * (mt5 - 1)} each): {counts}")

    # ---- S7: float64 at N_TIERS under the fused tier: bf16x6 at NB (B8's
    # split body, 3 slices) and at NB_M5 (B6's), then 'auto' at both, which
    # splits B8 (K = 512: bf16x6) and not B6 (K = 192)
    a64 = a_glob[:N_TIERS, :N_TIERS].double()  # a_glob is stored in full

    def residual64(fac):
        lo = torch.tril(layout.unpack(fac.data, fac.dist)[:N_TIERS, :N_TIERS])
        return (torch.linalg.matrix_norm(a64 - lo @ lo.T) / torch.linalg.matrix_norm(a64)).item()

    tol32, tol64 = tol_for("float32", N_TIERS), tol_for("float64", N_TIERS)
    low64 = torch.tril(a64)
    wrong = (torch.linalg.matrix_norm(a64 - low64 @ low64.T)
             / torch.linalg.matrix_norm(a64)).item()  # the check rejects L = tril(A)
    del low64
    s7 = {}
    for label, tier, nb_, kernel, split in (("bf16x6_nb512", "bf16x6", NB, "fused_step", True),
                                            ("bf16x6_nb192", "bf16x6", NB_M5, "dma_ring_consume",
                                             True),
                                            ("auto_nb512", "auto", NB, "fused_step", True),
                                            ("auto_nb192", "auto", NB_M5, "dma_ring_consume",
                                             False)):
        tune.initialize(**PATH_M4, gemm_precision=tier)
        fac, wall, counts = timed(lambda nb_=nb_: factor(a64, nb_))
        res = residual64(fac)
        del fac
        steps = ranks * (-(-N_TIERS // nb_) - 1)
        counts_by[f"S7_{label}"] = counts
        # a split factor is float32 class, far above the float64 rounding
        # of the 'default' tier's (whose residual must then be float64 class)
        ok = res <= tol32 and res > tol64 if split else res <= tol64
        s7[label] = {"tier": tier, "nb": nb_, "wall_s": wall, "factor_residual": res,
                     "launches": counts, "ok": ok, "launches_ok": (
                         counts[kernel] == steps
                         and counts[f"{kernel}_split"] == (steps if split else 0))}
    emit({"phase": "path_S7", "config": "float64 Cholesky, lookahead, trailing_update_impl=fused, "
          "collectives_impl=pallas, panel_trsm_pallas=1", "grid": list(GRID_M), "n": N_TIERS,
          "runs": s7, "tol_split_float32_class": tol32, "tol_default_float64": tol64,
          "factor_residual_of_tril_a": wrong, **stamp})
    if not (all(r["ok"] and r["launches_ok"] for r in s7.values()) and wrong > tol32):
        fail(f"path S7: {s7} (tril(A): {wrong:.3e})")
    del a64
    torch.cuda.empty_cache()

    # ---- path I: triangular_inverse of M4's factor, then the upper form
    tune.initialize(**PATH_I)

    def inverse(uplo, src):
        return dtt.triangular_inverse(uplo, "N", dtt.DistributedMatrix(src.dist, grid,
                                                                       src.data.clone()))

    def inv_residual(x, f):
        """||X F - I||_F / (||X||_F ||F||_F), and ||X F - I||_F / ||I||_F: the
        first shrinks like 1 / sqrt(N) for any X of F's scale (X = L gives
        6e-3 at N=16384, under tol_for(f32, N)), so both are held."""
        eye = torch.eye(x.shape[0], dtype=torch.float64, device=x.device)
        r = torch.linalg.matrix_norm(x @ f - eye)
        del eye
        scaled = r / (torch.linalg.matrix_norm(x) * torch.linalg.matrix_norm(f))
        return {"scaled": scaled.item(), "vs_identity": (r / x.shape[0] ** 0.5).item()}

    inverse("L", fac4)  # warm-up
    inv, wall, counts = timed(lambda: inverse("L", fac4))
    ell = torch.tril(layout.unpack(fac4.data, fac4.dist)[:n, :n]).double()
    x = torch.tril(layout.unpack(inv.data, inv.dist)[:n, :n]).double()
    del inv
    got, wrong = inv_residual(x, ell), inv_residual(ell, ell)
    del x
    torch.cuda.empty_cache()
    counts_by["I"] = counts
    emit({"phase": "path_I", "config": "triangular_inverse(L, N), trailing_update_impl=fused, "
          "collectives_impl=pallas", "grid": list(GRID_M), "n": n, "nb": NB, "wall_s": wall,
          "inverse_residual": got, "inverse_residual_of_x_eq_l": wrong, "tol": res_tol,
          "launches": counts, "launches_per_rank": {k_: v / ranks for k_, v in counts.items()},
          **stamp})
    if not worst(got.values()) <= res_tol < worst(wrong.values()):
        fail(f"path I residuals {got}, of X = L {wrong} (tol {res_tol:.3e})")
    if counts["panel_contract"] != ranks * mt or counts["trailing_update"] \
            or counts["panel_contract_split"]:
        fail(f"path I launched B9 {counts['panel_contract']} times (want {ranks * mt}, none "
             f"split), B3 {counts['trailing_update']}: {counts}")

    # ---- S4: path I's inverse under bf16x3 (B9's split body per step and
    # rank), then POTRI of the leading N_TIERS block of M4's factor
    tune.initialize(**PATH_S4)
    inv, wall, counts = timed(lambda: inverse("L", fac4))
    x = torch.tril(layout.unpack(inv.data, inv.dist)[:n, :n]).double()
    del inv
    got = inv_residual(x, ell)
    del x
    torch.cuda.empty_cache()
    counts_by["S4_inverse"] = counts
    l4 = dtt.DistributedMatrix.from_global(grid, ell[:N_TIERS, :N_TIERS].float().contiguous(),
                                           (NB, NB))
    ainv, wall_p, counts_p = timed(lambda: dtt.inverse_from_cholesky_factor("L", l4))
    counts_by["S4_potri"] = counts_p
    a4 = a_glob[:N_TIERS, :N_TIERS].double()
    eye4 = torch.eye(N_TIERS, dtype=torch.float64, device=a4.device)

    def potri_residual(xinv):
        return (torch.linalg.matrix_norm(a4 @ xinv - eye4) / N_TIERS ** 0.5).item()

    potri = potri_residual(layout.unpack(ainv.data, ainv.dist)[:N_TIERS, :N_TIERS].double())
    potri_wrong = potri_residual(a4)  # the check rejects X = A
    tol4 = tol_for("float32", N_TIERS)
    del ainv, l4, a4, eye4
    emit({"phase": "path_S4", "config": "triangular_inverse(L, N) of M4's factor, then "
          "inverse_from_cholesky_factor(L) of its leading block; gemm_precision=bf16x3, "
          "trailing_update_impl=fused, collectives_impl=pallas", "grid": list(GRID_M), "n": n,
          "nb": NB, "inverse_wall_s": wall, "inverse_residual": got,
          "inverse_residual_of_x_eq_l": wrong, "tol": res_tol, "inverse_launches": counts,
          "potri_n": N_TIERS, "potri_wall_s": wall_p, "potri_residual": potri,
          "potri_residual_of_x_eq_a": potri_wrong, "potri_tol": tol4,
          "potri_launches": counts_p, **stamp})
    if not (worst(got.values()) <= res_tol < worst(wrong.values())
            and potri <= tol4 < potri_wrong):
        fail(f"path S4: inverse residuals {got} (of X = L {wrong}; tol {res_tol:.3e}), POTRI "
             f"{potri:.3e} (of X = A {potri_wrong:.3e}; tol {tol4:.3e})")
    if counts["panel_contract_split"] != ranks * mt or counts["panel_contract"] != ranks * mt \
            or counts_p["panel_contract_split"] != ranks * (N_TIERS // NB):
        fail(f"path S4 launched B9's split body {counts['panel_contract_split']} times (want "
             f"{ranks * mt}) and {counts_p['panel_contract_split']} in POTRI (want "
             f"{ranks * (N_TIERS // NB)}): {counts}, {counts_p}")
    tune.initialize(**PATH_I)
    up = ell[:N_TIERS, :N_TIERS].T.float().contiguous()
    del ell, fac4
    torch.cuda.empty_cache()
    mat_u = dtt.DistributedMatrix.from_global(grid, up, (NB, NB))
    inv, wall, counts = timed(lambda: inverse("U", mat_u))
    x = torch.triu(layout.unpack(inv.data, inv.dist)[:N_TIERS, :N_TIERS]).double()
    tol_u = tol_for("float32", N_TIERS)
    got, wrong = inv_residual(x, up.double()), inv_residual(up.double(), up.double())
    counts_by["I_upper"] = counts
    emit({"phase": "path_I_upper", "config": "triangular_inverse(U, N) of L^T's leading block",
          "n": N_TIERS, "nb": NB, "wall_s": wall, "inverse_residual": got,
          "inverse_residual_of_x_eq_u": wrong, "tol": tol_u, "launches": counts, **stamp})
    if not worst(got.values()) <= tol_u < worst(wrong.values()):
        fail(f"path I (upper) residuals {got}, of X = U {wrong} (tol {tol_u:.3e})")
    if counts["panel_contract"] != ranks * (N_TIERS // NB):
        fail(f"path I (upper) launched B9 {counts['panel_contract']} times: {counts}")
    return counts_by

#: the k slice of B3's and B9's bodies: the before/after checks' wrong
#: answer is the reference with its last slice dropped
KBK_FMA = 16


def _k_dropped(k: int) -> int:
    """The depth left when the last (possibly partial) k slice is dropped."""
    return (k - 1) // KBK_FMA * KBK_FMA


def _fma_ptxas(kernel: str, dtype_name: str, *flags: bool) -> dict:
    """ptxas's registers and spills of one instantiation of the FMA body's
    kernels (``trailing_update_fma_kernel<float, true, true>``, ...)."""
    args = ", ".join([dtype_name] + [str(f).lower() if isinstance(f, bool) else str(f)
                                      for f in flags])
    return _ptxas_of(f"{kernel}<{args}>")


def _vec_copies(a, b, lda: int, ldb: int) -> bool:
    """Whether B3's / B9's launcher takes the 16-byte copies (its
    ``rows_aligned16``): both bases and both row lengths on 16 bytes."""
    e = a.element_size()
    return (a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0 and lda * e % 16 == 0
            and ldb * e % 16 == 0)


def fma_verdict(label: str, new, ref, dropped, plain, tol: float, base=None,
                dropped_what: str = "its last k slice") -> dict:
    """The before/after checks of one B3 or B9 case (and of B2's): ``new``
    (the new body) bit for bit ``ref`` (the first body on the same inputs),
    the same check first shown to reject ``dropped`` (the reference with
    ``dropped_what`` dropped), and ``new`` within ``tol`` of ``plain``
    (relative Frobenius; B3 compares the applied updates, ``x - base``)."""
    import torch

    rejects = not torch.equal(_bits(dropped), _bits(ref))
    bitwise = torch.equal(_bits(new), _bits(ref))
    differ = 0 if bitwise else int((_bits(new) != _bits(ref)).sum())
    if base is not None:
        new, plain = new - base, plain - base
    err_abs, rel = _rel_dev(new, plain)
    problems = []
    if not rejects:
        problems.append(f"the bitwise check accepts the reference with {dropped_what} dropped")
    if not bitwise:
        problems.append(f"not bit for bit the reference ({differ} of {ref.numel()} elements "
                        "differ)")
    if not rel <= tol:
        problems.append(f"rel err vs plain {rel:.3e} > tol {tol:.3e}")
    return {"bitwise_vs_reference": bitwise, "elements_differing": differ,
            "dropped_slice_rejected": rejects, "max_abs_err": err_abs, "rel_err": rel, "tol": tol,
            "problems": [f"{label}: {p}" for p in problems]}


def secular_tables(kgen, gen, kk: int, ss: int) -> dict:
    """B10's two tables at K = kk rows of S = ss poles, as (dw, z2, rho,
    anchor, lo0, hi0) with the rows the bracket budget holds.  "mu": true
    secular equations shaped like the D&C's: increasing poles d in [1, 5]
    (a jittered grid, so no two coincide and every bracket is wider than
    2 / S), weights z2 > 0 summing to about 1 per row, rho in [0.1, 1.6];
    row r anchors at pole j = r mod (S - 1) with the bracket (0, d[j+1] -
    d[j]), which holds exactly one root (f rises from -inf to +inf); drawn
    from ``kgen`` as the phase always drew it.  "mixed": the same poles,
    weights and rho, the even rows mu brackets and the odd rows nu ones
    ((-gap, 0), anchored at pole j + 1, the D&C's second bisection); rows
    r mod 8 < 2 give their anchor pole a weight of B10_NEAR_POLE of the
    row's mean weight, so that where the other poles' terms do not change
    sign in the bracket (in most mu rows here) the root sits next to that
    pole and needs every round; row K - 2 has a zero gap (the bracket
    (0, 0): its anchor pole's gap to mid is 0 in every round, FLT_MIN in
    its place) and row K - 1 a NaN weight (drawn from ``gen``), both left
    out of the budget."""
    import torch

    dev = kgen.device
    jitter = torch.rand(ss, generator=kgen, device=dev)
    poles = 1 + 4 * (torch.arange(ss, device=dev) + 0.25 + 0.5 * jitter) / ss
    dw = poles.expand(kk, ss).contiguous()
    z2 = (torch.rand(kk, ss, generator=kgen, device=dev) + 0.01) * (2.0 / ss)
    rho = torch.rand(kk, generator=kgen, device=dev) * 1.5 + 0.1
    rows = torch.arange(kk, device=dev)
    jj = rows % (ss - 1)
    width = (poles[jj + 1] - poles[jj]).contiguous()
    zero = torch.zeros(kk, device=dev)
    every = torch.ones(kk, dtype=torch.bool, device=dev)
    mu = (dw, z2, rho, poles[jj].contiguous(), zero, width)

    nu = rows % 2 == 1
    a_idx = jj + nu.long()
    near = rows % 8 < 2
    z2m = z2.clone()
    z2m[rows[near], a_idx[near]] = B10_NEAR_POLE * z2[near].mean(dim=1)
    z2m[kk - 1, int(torch.randint(ss, (1,), generator=gen, device=dev))] = float("nan")
    lo0 = torch.where(nu, -width, zero)
    hi0 = torch.where(nu, zero, width)
    lo0[kk - 2] = hi0[kk - 2] = 0.0
    budget = every.clone()
    budget[kk - 2:] = False
    mixed = (dw, z2m, rho, poles[a_idx].contiguous(), lo0, hi0)
    return {"mu": (mu, every), "mixed": (mixed, budget)}


def secular_phase(stamp: dict, bound, timed_ms, kgen) -> dict:
    """B10's phase: the secular bisection at path H's shapes, K_B10 rows of
    S poles, S one merge level's subproblem size, and at B10_STREAM (rows
    streamed from device memory every round), on both tables of
    ``secular_tables``, and at B10_H2 (path H2's per-rank shape at its top
    level) on the mu table.  The body (stops each row at its bracket's fixed
    point, one barrier a round) bit for bit its first body (the reference
    kernel, every round), by digests of every output, the check first
    shown to reject the reference's output with one bit flipped; within
    its bracket budget of the plain version (tol_for(f32, S) relative to
    the bracket width, S the length of the row sums) on the budget rows,
    whose plain roots must lie inside their brackets; the rounds each row
    needs (``secular_rounds_plain``) as a histogram, and the bound counted
    from them beside the 42-round one; times of the body and the reference
    in turns (reference, body, body, reference) and of the plain version;
    ptxas's registers and spills of every instantiation of both bodies,
    and the blocks an SM holds of the instantiation each S takes.
    Every S and table is checked before any failure stops the script.
    Returns the report entry (the mu table at the largest S first)."""
    import torch

    from dlaf_tpu_torch.ops import _build, secular
    from dlaf_tpu_torch.testing import tol_for

    dev = kgen.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    iters = ITERS_B10
    lib = _build.lib()
    ptxas = {f"{body}<{e}>": _ptxas_of(f"{body}<{e}>")
             for body in ("first::secular_bisect_kernel", "namespace)::secular_bisect_kernel")
             for e in (1, 2, 4, 8, 16, 32, 0)}
    # blocks an SM holds of the instantiation each of the phase's S takes
    occupancy = {ss: {"body": lib.dlaf_secular_blocks_per_sm(ss, 0),
                      "reference": lib.dlaf_secular_blocks_per_sm(ss, 1)}
                 for ss in S_B10 + (B10_STREAM[1],)}
    emit({"phase": "secular_ptxas", "kernels": ptxas, "blocks_per_sm": occupancy, **stamp})
    shapes, bad = {}, []
    for kk, ss in [(K_B10, s) for s in S_B10] + [B10_STREAM, B10_H2]:
        tol = tol_for("float32", ss)
        tables = {}
        # the streaming shape and H2's draw from gen, so that kgen's later
        # draws (the next phases' inputs) stay as they were
        drawn = secular_tables(kgen if kk == K_B10 else gen, gen, kk, ss)
        for label, (args, budget) in drawn.items():
            if (kk, ss) == B10_H2 and label != "mu":
                continue
            b10 = (*args, iters)
            lo0, hi0 = args[4], args[5]
            new, ref = secular.secular_bisect(*b10), secular.secular_bisect_reference(*b10)
            plain = secular.secular_bisect_plain(*b10)
            need = secular.secular_rounds_plain(*b10)
            torch.cuda.synchronize()
            flipped = ref.clone()
            flipped.view(torch.int32)[kk // 3] ^= 1
            bitwise = digest(new) == digest(ref)
            rejects = digest(flipped) != digest(ref)
            width = (hi0 - lo0)[budget]
            err = ((new - plain).abs()[budget] / width).max().item()
            err_abs = (new - plain).abs()[budget].max().item()
            inside = bool(((plain > lo0) & (plain < hi0))[budget].all())
            b_ms, b_by = bound(4.0 * ss * need.sum().item(), (2 * kk * ss + 5 * kk) * 4)
            b42_ms, _ = bound(4.0 * iters * kk * ss, (2 * kk * ss + 5 * kk) * 4)
            turns = [timed_ms(lambda: secular.secular_bisect_reference(*b10), 10),
                     timed_ms(lambda: secular.secular_bisect(*b10), 10),
                     timed_ms(lambda: secular.secular_bisect(*b10), 10),
                     timed_ms(lambda: secular.secular_bisect_reference(*b10), 10)]
            hist = torch.bincount(need, minlength=iters + 1).tolist()
            rec = {"kernel": "secular_bisect", "shape": [kk, ss], "table": label,
                   "iters": iters, "bitwise_vs_reference": bitwise,
                   "elements_differing": int((new.view(torch.int32)
                                              != ref.view(torch.int32)).sum()),
                   "flipped_bit_rejected": rejects,
                   "digests": {"kernel": digest(new), "reference": digest(ref)},
                   "max_abs_err": err_abs, "max_err_rel_to_bracket": err, "tol": tol,
                   "plain_roots_inside_brackets": inside, "budget_rows": int(budget.sum()),
                   "rounds_needed": {"mean": need.double().mean().item(),
                                     "min": int(need.min()), "max": int(need.max()),
                                     "share_needing_all": hist[iters] / kk,
                                     "histogram": hist},
                   "kernel_ms": (turns[1] + turns[2]) / 2,
                   "reference_ms": (turns[0] + turns[3]) / 2,
                   "turns_ms": {"reference": [turns[0], turns[3]], "kernel": turns[1:3]},
                   "plain_ms": timed_ms(lambda: secular.secular_bisect_plain(*b10), 3),
                   "library_ms": None,
                   "library_call": "none: no single PyTorch call computes it",
                   "bound_ms": b_ms, "bound_by": b_by, "bound_42_rounds_ms": b42_ms,
                   "bound_counts": "4 flops per element and round (sub, IEEE div as 1, FMA as "
                                   "2) over the rounds each row needs (the 42-round bound "
                                   "beside it); bytes 2*K*S*4 + 5*K*4", **stamp}
            emit(rec)
            tables[label] = rec
            problems = []
            if not rejects:
                problems.append("the digest check accepts a flipped bit")
            if not bitwise:
                problems.append(f"not bit for bit the reference ({rec['elements_differing']} "
                                f"of {kk} rows differ)")
            if not (err <= tol and inside):
                problems.append(f"max err / bracket {err:.3e} (tol {tol:.3e}), plain roots "
                                f"inside their brackets: {inside}")
            bad += [f"{kk}x{ss} {label}: {p}" for p in problems]
            del b10, args, new, ref, plain, need, flipped
        del drawn
        shapes[f"{kk}x{ss}"] = {**tables["mu"], "tables": tables}
    torch.cuda.empty_cache()
    if bad:
        fail("secular_bisect vs its reference and plain version: " + "; ".join(bad))
    every = [tb for s in shapes.values() for tb in s["tables"].values()]
    return {**shapes[f"{K_B10}x{max(S_B10)}"],
            "max_abs_err": worst(r["max_abs_err"] for r in every),
            "shapes": shapes, "ptxas": ptxas, "blocks_per_sm": occupancy}


def trailing_update_phase(stamp: dict, bound, timed_ms, kgen) -> dict:
    """Phase 2b: B3 at the 'default' tier, the FMA body of csrc/fma_gemm.cuh,
    in both lookahead forms at path B's shapes (32 x 32 and 32 x 1 pairs of
    512^2 tiles) and at red2band's (16 x 16, K = band = 128), f32, and in
    f64 at 8 x 8 x 512^2: bit for bit the reference kernel (the first body,
    ``trailing_update_reference``) on the same inputs, the bitwise check
    first shown to reject the reference with its last k slice dropped,
    and the applied update within tol_for(dtype, K) of the plain version;
    times (CUDA events) of the kernel and the reference in turns (ref, new,
    new, ref), the plain version, the yardstick (one in-place ``baddbmm_``
    over the pair batch, operands expanded beforehand), the bound, and
    ptxas's registers and spills of the instantiation.  Standard normal
    operands.  Returns the report entry (path B's 32 x 32 form first)."""
    import torch

    from dlaf_tpu_torch.ops import trailing_update as tu
    from dlaf_tpu_torch.testing import tol_for

    dev = kgen.device
    mt = N // NB
    cases = [  # (label, subscripts, L, C, M, N, K, dtype, iters)
        (tu.CHOLESKY_SUBSCRIPTS, tu.CHOLESKY_SUBSCRIPTS, mt, mt, NB, NB, NB, torch.float32, 5),
        (tu.TRSM_SUBSCRIPTS, tu.TRSM_SUBSCRIPTS, mt, 1, NB, NB, NB, torch.float32, 50),
        (f"{tu.CHOLESKY_SUBSCRIPTS} (red2band, K=128)", tu.CHOLESKY_SUBSCRIPTS, NH // NBH,
         NH // NBH, NBH, NBH, 128, torch.float32, 20),
        (f"{tu.CHOLESKY_SUBSCRIPTS} (f64)", tu.CHOLESKY_SUBSCRIPTS, 8, 8, NB, NB, NB,
         torch.float64, 5),
    ]
    forms, bad = {}, []
    for label, sub, L, C, M, N_, K, dtype, iters in cases:
        nk = sub == tu.CHOLESKY_SUBSCRIPTS
        kd = _k_dropped(K)
        x0 = torch.randn(L, C, M, N_, generator=kgen, device=dev, dtype=dtype)
        a_op = torch.randn(L, M, K, generator=kgen, device=dev, dtype=dtype)
        b_op = torch.randn(*((C, N_, K) if nk else (C, K, N_)), generator=kgen, device=dev,
                           dtype=dtype)
        a_d = a_op[..., :kd].contiguous()
        b_d = (b_op[..., :kd] if nk else b_op[:, :kd]).contiguous()
        xk = tu.trailing_update(x0.clone(), a_op, b_op, sub)
        xr = tu.trailing_update_reference(x0.clone(), a_op, b_op, sub)
        xd = tu.trailing_update_reference(x0.clone(), a_d, b_d, sub)
        xp = tu.trailing_update_plain(x0.clone(), a_op, b_op, sub)
        torch.cuda.synchronize()
        verdict = fma_verdict(f"trailing_update[{label}]", xk, xr, xd, xp,
                              tol_for(str(dtype).replace("torch.", ""), K), base=x0)
        bad += verdict.pop("problems")
        del xr, xd, xp, a_d, b_d, x0
        vec = _vec_copies(a_op, b_op, K, K if nk else N_)
        a_exp = a_op.unsqueeze(1).expand(L, C, M, K).reshape(L * C, M, K)
        b_kn = b_op.transpose(-1, -2) if nk else b_op
        b_exp = b_kn.unsqueeze(0).expand(L, C, K, N_).reshape(L * C, K, N_)
        xv = xk.view(L * C, M, N_)
        b_ms, b_by = bound(2.0 * L * C * M * N_ * K,
                           (2 * L * C * M * N_ + L * M * K + C * N_ * K) * a_op.element_size())
        new = lambda: tu.trailing_update(xk, a_op, b_op, sub)  # noqa: E731
        old = lambda: tu.trailing_update_reference(xk, a_op, b_op, sub)  # noqa: E731
        turns = [timed_ms(old, iters), timed_ms(new, iters), timed_ms(new, iters),
                 timed_ms(old, iters)]
        forms[label] = {
            "shape": {"x": [L, C, M, N_], "a": list(a_op.shape), "b": list(b_op.shape)},
            "dtype": str(dtype).replace("torch.", ""), **verdict,
            "kernel_ms": (turns[1] + turns[2]) / 2, "reference_ms": (turns[0] + turns[3]) / 2,
            "turns_ms": {"reference": [turns[0], turns[3]], "fma_body": [turns[1], turns[2]]},
            "copies": "16-byte" if vec else "element",
            "ptxas": _fma_ptxas("trailing_update_fma_kernel",
                                "float" if dtype == torch.float32 else "double", nk, vec),
            "plain_ms": timed_ms(lambda: tu.trailing_update_plain(xk, a_op, b_op, sub), iters),
            "library_ms": timed_ms(lambda: xv.baddbmm_(a_exp, b_exp, alpha=-1), iters),
            "library_call": "torch.Tensor.baddbmm_", "bound_ms": b_ms, "bound_by": b_by,
        }
        emit({"kernel": "trailing_update", "subscripts": label, **forms[label], **stamp})
        del xk, xv, a_op, b_op, a_exp, b_exp
        torch.cuda.empty_cache()
    if bad:
        fail("trailing_update (the FMA body): " + "; ".join(bad))
    return {**forms[tu.CHOLESKY_SUBSCRIPTS], "forms": forms}


#: the ragged shapes of B3's and B9's FMA body (L, C, M, N, K): M and N off
#: the 128 tile, K off the 16 slice (130: element copies) and on it (128:
#: 16-byte copies, N = 200 a multiple of 4)
FMA_EDGE_SHAPES = ((3, 2, 200, 192, 130), (2, 3, 192, 200, 128), (2, 2, 200, 200, 132))


def fma_edge_phase(stamp: dict, timed_ms, kgen) -> dict:
    """Phase 2b': B3 (both forms) and B9 (both forms) at the ragged shapes
    FMA_EDGE_SHAPES, in f32 and f64: bit for bit the reference kernels, the
    check first shown to reject the reference with its last k slice
    dropped, and within tol_for(dtype, depth) of the plain versions.  Also
    B9 in f64 at form 0, 4 x 8 slots of 512^2 (timed in turns with the
    reference).  Returns the cases' records."""
    import torch

    from dlaf_tpu_torch.ops import trailing_update as tu
    from dlaf_tpu_torch.testing import tol_for

    dev = kgen.device
    cases, bad = {}, []

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=kgen, device=dev, dtype=dtype)

    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).replace("torch.", "")
        for L, C, M, N_, K in FMA_EDGE_SHAPES:
            kd = _k_dropped(K)
            for sub in (tu.CHOLESKY_SUBSCRIPTS, tu.TRSM_SUBSCRIPTS):
                nk = sub == tu.CHOLESKY_SUBSCRIPTS
                x0, a_op = randn(L, C, M, N_, dtype=dtype), randn(L, M, K, dtype=dtype)
                b_op = randn(*((C, N_, K) if nk else (C, K, N_)), dtype=dtype)
                b_d = (b_op[..., :kd] if nk else b_op[:, :kd]).contiguous()
                label = f"trailing_update[{sub}] {dname} {[L, C, M, N_, K]}"
                v = fma_verdict(
                    label, tu.trailing_update(x0.clone(), a_op, b_op, sub),
                    tu.trailing_update_reference(x0.clone(), a_op, b_op, sub),
                    tu.trailing_update_reference(x0.clone(), a_op[..., :kd].contiguous(), b_d,
                                                 sub),
                    tu.trailing_update_plain(x0.clone(), a_op, b_op, sub), tol_for(dname, K),
                    base=x0)
                bad += v.pop("problems")
                cases[label] = {**v, "copies": "16-byte" if _vec_copies(
                    a_op, b_op, K, K if nk else N_) else "element"}
            for sub in (tu.TRTRI_LOWER_SUBSCRIPTS, tu.TRTRI_UPPER_SUBSCRIPTS):
                if sub == tu.TRTRI_LOWER_SUBSCRIPTS:  # a [L, C, M, K], b [C, K, N]
                    a_op, b_op = randn(L, C, M, K, dtype=dtype), randn(C, K, N_, dtype=dtype)
                else:  # a [L, M, K], b [L, C, K, N]
                    a_op, b_op = randn(L, M, K, dtype=dtype), randn(L, C, K, N_, dtype=dtype)
                a_d = a_op[..., :kd].contiguous()
                b_d = b_op[..., :kd, :].contiguous()
                label = f"panel_contract[{sub}] {dname} {[L, C, M, N_, K]}"
                depth = (C if sub == tu.TRTRI_LOWER_SUBSCRIPTS else L) * K
                v = fma_verdict(label, tu.panel_contract(a_op, b_op, sub),
                                tu.panel_contract_reference(a_op, b_op, sub),
                                tu.panel_contract_reference(a_d, b_d, sub),
                                tu.panel_contract_plain(a_op, b_op, sub), tol_for(dname, depth))
                bad += v.pop("problems")
                cases[label] = {**v, "copies": "16-byte" if _vec_copies(a_op, b_op, K, N_)
                                else "element"}
    torch.cuda.synchronize()
    # B9 in f64 at a table-like shape, timed in turns with the reference
    sub, L, C, nb = tu.TRTRI_LOWER_SUBSCRIPTS, 4, 8, NB
    a_op, b_op = randn(L, C, nb, nb, dtype=torch.float64), randn(C, nb, nb, dtype=torch.float64)
    kd = _k_dropped(nb)
    label = f"panel_contract[{sub}] float64 {[L, C, nb, nb, nb]}"
    v = fma_verdict(label, tu.panel_contract(a_op, b_op, sub),
                    tu.panel_contract_reference(a_op, b_op, sub),
                    tu.panel_contract_reference(a_op[..., :kd].contiguous(),
                                                b_op[:, :kd].contiguous(), sub),
                    tu.panel_contract_plain(a_op, b_op, sub), tol_for("float64", C * nb))
    bad += v.pop("problems")

    new = lambda: tu.panel_contract(a_op, b_op, sub)  # noqa: E731
    old = lambda: tu.panel_contract_reference(a_op, b_op, sub)  # noqa: E731
    turns = [timed_ms(old, 5), timed_ms(new, 5), timed_ms(new, 5), timed_ms(old, 5)]
    cases[label] = {**v, "copies": "16-byte", "kernel_ms": (turns[1] + turns[2]) / 2,
                    "reference_ms": (turns[0] + turns[3]) / 2,
                    "turns_ms": {"reference": [turns[0], turns[3]],
                                 "fma_body": [turns[1], turns[2]]},
                    "ptxas": _fma_ptxas("panel_contract_fma_kernel", "double", 0, True)}
    for label, rec in cases.items():
        emit({"kernel": "fma_body_edges", "case": label, **rec, **stamp})
    del a_op, b_op
    torch.cuda.empty_cache()
    if bad:
        fail("the FMA body of B3 and B9 at ragged shapes and in f64: " + "; ".join(bad))
    return cases


SPLIT_KERNELS = ("trailing_update_split", "panel_contract_split")


def _rel_dev(got, want) -> tuple[float, float]:
    """Max abs error and relative Frobenius error of ``got`` against
    ``want``, in float64 on the card (NaN propagates)."""
    import torch

    d = got.double() - want.double()
    den = torch.linalg.vector_norm(want.double()).item()
    return d.abs().max().item(), torch.linalg.vector_norm(d).item() / (den if den > 0 else 1.0)


def _term01(sub, a, b):
    """The (0, 1) product of the split of ``contract(sub, a, b)``: a's head
    slice times b's first residual slice, in float32."""
    import torch

    from dlaf_tpu_torch.ops import tile

    sa, sb = tile._bf16_slices(a, 2), tile._bf16_slices(b, 2)
    return torch.einsum(sub, sa[0].float(), sb[1].float()).to(a.dtype)


def split_phase(stamp: dict, timed_ms, kgen, only=SPLIT_KERNELS) -> dict:
    """Phase 2d: B3 and B9 under the split tiers against their plain
    versions (``tile.contract`` at the tier, on the card): B3 at path B's
    two shapes and red2band's (K = 128) in f32 at bf16x3 and at 16 x 16 x
    512^2 in f64 at bf16x6; B9 in both forms at path I's widest step on the
    2x4 grid, f32 at bf16x3.  Two checks, each first shown to reject wrong
    answers:

    - standard normal operands: within tol_for(f32, K) of the plain split
      (K: B3's depth; nb for B9, as its default-tier check), which rejects
      the plain split with its (0, 1) product dropped;
    - the split probe: the same shapes with b cut to one non-zero per
      output column, so that every output is one product and float32
      accumulation adds no rounding: the kernel must give the plain split's
      bits and differ from the 'default' product by more than 1e-6
      (f32; 1e-10 in f64, far above its rounding).  It rejects the
      default-tier kernel's output and the dropped product.  (On normal
      operands at B9's depth, 4096 products a sum, float32 accumulation
      noise is as large as the split's own truncation, so distances there
      cannot tell the two apart.)

    Times: the kernel (a call: the pre-pass that cuts both operands into
    their bf16 planes, then the body), each of its two kernels alone
    (``cut_ms``, ``body_ms``; ``cut_share`` the pre-pass's part of their
    sum), the default-tier kernel (in the same call), the plain version and
    the yardstick ``tile.contract`` at the tier (no single PyTorch call
    computes a split product); bounds at the bf16 tensor cores' rate, with
    each input read and each output written once (the planes' traffic is
    the design's own cost)."""
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch.comm import collectives as coll
    from dlaf_tpu_torch.ops import tile
    from dlaf_tpu_torch.ops import trailing_update as tu
    from dlaf_tpu_torch.testing import tol_for

    dev = kgen.device
    report, bad = {}, []

    def parts_ms(cut_ms, body_ms):
        return {"cut_ms": cut_ms, "body_ms": body_ms, "cut_share": cut_ms / (cut_ms + body_ms)}

    def bound16(flops, nbytes):
        t_ops, t_bytes = flops / BF16_PEAK * 1e3, nbytes / HBM_RATE * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    def probe(sub, b):
        """``b`` with one non-zero per output column of ``sub``: every output
        element is then a single product."""
        keep = torch.zeros(b.shape, dtype=torch.bool, device=b.device)
        if sub in (tu.CHOLESKY_SUBSCRIPTS, tu.TRSM_SUBSCRIPTS):  # [C, N, K] / [C, K, N]
            C, K = b.shape[0], (b.shape[2] if sub == tu.CHOLESKY_SUBSCRIPTS else b.shape[1])
            n_ = b.shape[1] if sub == tu.CHOLESKY_SUBSCRIPTS else b.shape[2]
            j = torch.arange(C, device=b.device)[:, None]
            c = torch.arange(n_, device=b.device)[None, :]
            k = (7 * c + j) % K
            if sub == tu.CHOLESKY_SUBSCRIPTS:
                keep[j, c, k] = True
            else:
                keep[j, k, c] = True
        elif sub == tu.TRTRI_LOWER_SUBSCRIPTS:  # [C, K, N]: sum over (j, b) per c
            C, K, n_ = b.shape
            c = torch.arange(n_, device=b.device)
            keep[c % C, (7 * c) % K, c] = True
        else:  # [L, C, K, N]: sum over (i, b) per (j, c)
            L, C, K, n_ = b.shape
            j = torch.arange(C, device=b.device)[:, None]
            c = torch.arange(n_, device=b.device)[None, :]
            keep[(c + j) % L, j, (7 * c + j) % K, c] = True
        return torch.where(keep, b, torch.zeros((), dtype=b.dtype, device=b.device))

    def checked(label, got, plain, wrongs, ok):
        """``ok(candidate) -> (passes, metrics)`` on every wrong answer (each
        must fail), then on the kernel's output (which must pass)."""
        rejected = {w: ok(c)[0] for w, c in wrongs.items()}
        passes, metrics = ok(got)
        if any(rejected.values()):
            bad.append(f"{label}: the check accepts a wrong answer: {rejected}")
        if not passes:
            bad.append(f"{label}: {metrics}")
        return metrics, rejected

    def both_checks(label, sub, tol, f64, run, a, b, per_rank=lambda f, a, b: f(a, b)):
        """``run(kernel, tier, b)`` gives an output or applied update (the
        negated contraction for B3: ``sign`` = -1); both checks on it.
        ``per_rank(f, a, b)`` applies ``f`` to each rank's operands (B9's
        are stacked over the grid)."""
        sign = -1.0 if sub in (tu.CHOLESKY_SUBSCRIPTS, tu.TRSM_SUBSCRIPTS) else 1.0
        tier = "bf16x6" if f64 else "bf16x3"
        got, plain = run(True, tier, b), run(False, tier, b)
        default = run(False, "default", b)
        err_abs, _ = _rel_dev(got, plain)
        _, vs_default = _rel_dev(got, default)
        del default

        def within(c):
            e = _rel_dev(c, plain)[1]
            return e <= tol, {"rel_err_vs_plain": e, "tol": tol}

        normal, rej_n = checked(f"{label} (normal operands)", got, plain,
                                {"term_0_1_dropped": plain - sign * per_rank(
                                    lambda a_, b_: _term01(sub, a_, b_), a, b)}, within)
        del got, plain
        bp = per_rank(lambda a_, b_: probe(sub, b_), a, b)
        got, plain = run(True, tier, bp), run(False, tier, bp)
        default = run(False, "default", bp)
        floor = 1e-10 if f64 else 1e-6

        def split(c):
            same, e = bool(torch.equal(c, plain)), _rel_dev(c, default)[1]
            return same and e > floor, {"probe_bitwise_vs_plain": same,
                                        "probe_rel_err_vs_default": e, "probe_floor": floor}

        probed, rej_p = checked(f"{label} (split probe)", got, plain,
                                {"default_tier_kernel": run(True, "default", bp),
                                 "term_0_1_dropped": plain - sign * per_rank(
                                     lambda a_, b_: _term01(sub, a_, b_), a, bp)}, split)
        return {"max_abs_err": err_abs, **normal, "rel_err_vs_default": vs_default, **probed,
                "wrong_answers_pass": {"normal": rej_n, "split_probe": rej_p}}

    if "trailing_update_split" in only:
        f32, f64 = torch.float32, torch.float64
        mt, hb = N // NB, NH // NBH
        cases = (("iab,jcb->ijac", tu.CHOLESKY_SUBSCRIPTS, mt, mt, NB, f32, 5),
                 ("iab,jbc->ijac", tu.TRSM_SUBSCRIPTS, mt, 1, NB, f32, 20),
                 ("iab,jcb->ijac (red2band, K=128)", tu.CHOLESKY_SUBSCRIPTS, hb, hb, 128, f32, 10),
                 ("iab,jcb->ijac (f64, bf16x6)", tu.CHOLESKY_SUBSCRIPTS, 16, 16, NB, f64, 5))
        forms = {}
        for label, sub, L, C, K, dt, iters in cases:
            M = N_ = NB
            tier = "bf16x6" if dt == f64 else "bf16x3"
            b_shape = (C, N_, K) if sub == tu.CHOLESKY_SUBSCRIPTS else (C, K, N_)
            x0 = torch.randn(L, C, M, N_, generator=kgen, device=dev, dtype=dt)
            a = torch.randn(L, M, K, generator=kgen, device=dev, dtype=dt)
            b = torch.randn(*b_shape, generator=kgen, device=dev, dtype=dt)

            def update(kernel, t_, b_):
                x = x0.clone()
                (tu.trailing_update if kernel else tu.trailing_update_plain)(x, a, b_, sub, t_)
                return x.sub_(x0)

            before = tu.split_launches
            rec = both_checks(f"trailing_update[{label}]", sub, tol_for("float32", K),
                              dt == f64, update, a, b)
            torch.cuda.synchronize()
            if tu.split_launches - before != 2:
                bad.append(f"trailing_update[{label}]: {tu.split_launches - before} split "
                           "launches, want 2 (normal operands, probe)")
            xk = x0.clone()
            cut, body = tu.split_parts(a, b, sub, tier, x=xk)
            nterms = len(tile.split_terms(tile.SPLIT_SLICES[tier]))
            b_ms, b_by = bound16(nterms * 2.0 * L * C * M * N_ * K,
                                 (2 * L * C * M * N_ + L * M * K + C * N_ * K) * x0.element_size())
            forms[label] = {
                "shape": {"x": [L, C, M, N_], "a": list(a.shape), "b": list(b.shape)},
                "dtype": str(dt).replace("torch.", ""), "tier": tier, "products": nterms, **rec,
                "kernel_ms": timed_ms(lambda: tu.trailing_update(xk, a, b, sub, tier), iters),
                **parts_ms(timed_ms(cut, iters), timed_ms(body, iters)),
                "default_tier_kernel_ms": timed_ms(
                    lambda: tu.trailing_update(xk, a, b, sub, "default"), iters),
                "plain_ms": timed_ms(lambda: tu.trailing_update_plain(xk, a, b, sub, tier),
                                     max(2, iters // 2)),
                "yardstick_ms": timed_ms(lambda: tile.contract(sub, a, b, tier),
                                         max(2, iters // 2)),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            emit({"kernel": "trailing_update_split", "subscripts": label, **forms[label],
                  "library_call": "none: no single PyTorch call computes a split product",
                  "yardstick": "tile.contract at the tier (bf16 slices upcast, one float32 "
                               "einsum per product)",
                  "bound_counts": f"{nterms} bf16 products at {BF16_PEAK:.3g} FLOP/s; x read and "
                                  "written, a and b read once", **stamp})
            del x0, a, b, xk, cut, body
            torch.cuda.empty_cache()
        first = forms[cases[0][0]]
        report["trailing_update_split"] = {**first, "forms": forms,
                                           "max_abs_err": worst(f["max_abs_err"]
                                                                for f in forms.values())}

    if "panel_contract_split" in only:
        # path I's widest step on the 2x4 grid, all ranks at once
        pr, pc = GRID_M
        ranks, nb, tier = pr * pc, NB, "bf16x3"
        gpu = dtt.Grid.create(GRID_M, device=dev)
        big = torch.randn(pr, pc, 16, 8, nb, nb, generator=kgen, device=dev)
        small_l = torch.randn(pr, pc, 8, nb, nb, generator=kgen, device=dev)
        small_u = torch.randn(pr, pc, 16, nb, nb, generator=kgen, device=dev)
        forms = {}
        for sub, ops_ in ((tu.TRTRI_LOWER_SUBSCRIPTS, [big, small_l]),
                          (tu.TRTRI_UPPER_SUBSCRIPTS, [small_u, big])):
            def run(kernel, t_, sub=sub):
                fn = tu.panel_contract if kernel else tu.panel_contract_plain
                return lambda a, b: (fn(a, b, sub, t_),)

            def on_grid(kernel, t_, b_, sub=sub, ops_=ops_):
                return on_ranks(gpu, run(kernel, t_), [ops_[0], b_])[0]

            before = tu.split_contract_launches
            rec = both_checks(f"panel_contract[{sub}]", sub, tol_for("float32", nb), False,
                              on_grid, ops_[0], ops_[1],
                              lambda f, a, b: on_ranks(gpu, lambda a_, b_: (f(a_, b_),), [a, b])[0])
            torch.cuda.synchronize()
            if tu.split_contract_launches - before != 2 * ranks:
                bad.append(f"panel_contract[{sub}]: {tu.split_contract_launches - before} split "
                           f"launches, want {2 * ranks}")
            small = ops_[1 if sub == tu.TRTRI_LOWER_SUBSCRIPTS else 0]
            out_numel = (16 if sub == tu.TRTRI_LOWER_SUBSCRIPTS else 8) * nb * nb
            b9, by9 = bound16(ranks * 3 * 2.0 * 16 * 8 * nb ** 3,
                              ranks * (big[0, 0].numel() + small[0, 0].numel() + out_numel) * 4)
            span, _ = grid_span_ms(gpu, run(True, tier), ops_, 5)
            parts = {}

            def prepare(a_, b_, sub=sub):
                parts[coll.my_rank()] = tu.split_parts(a_, b_, sub, tier)

            coll.spmd(gpu, prepare, *ops_)
            span_cut, _ = grid_span_ms(gpu, lambda *_: parts[coll.my_rank()][0](), ops_, 5)
            span_body, _ = grid_span_ms(gpu, lambda *_: parts[coll.my_rank()][1](), ops_, 5)
            del parts
            span_def, _ = grid_span_ms(gpu, run(True, "default"), ops_, 5)
            span_plain, _ = grid_span_ms(gpu, run(False, tier), ops_, 2)
            forms[sub] = {"shape": {"a": list(ops_[0].shape[2:]), "b": list(ops_[1].shape[2:])},
                          "dtype": "float32", "tier": tier, "products": 3, **rec,
                          "kernel_ms": span, **parts_ms(span_cut, span_body),
                          "default_tier_kernel_ms": span_def,
                          "plain_ms": span_plain, "yardstick_ms": span_plain, "library_ms": None,
                          "bound_ms": b9, "bound_by": by9}
            emit({"kernel": "panel_contract_split", "subscripts": sub, "ranks": ranks,
                  **forms[sub], "plain_on": "the card, tile.contract at the tier per rank "
                  "(which is also the yardstick)",
                  "library_call": "none: no single PyTorch call computes a split product",
                  **stamp})
        report["panel_contract_split"] = {**forms[tu.TRTRI_LOWER_SUBSCRIPTS], "forms": forms,
                                          "max_abs_err": worst(f["max_abs_err"]
                                                               for f in forms.values())}
        del big, small_l, small_u
        torch.cuda.empty_cache()
    if bad:
        fail("split-tier kernels vs their plain versions: " + "; ".join(bad))
    return report


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _step0(grid, a, nb, k=0):
    """Step ``k`` of lookahead Cholesky of ``a`` at block size ``nb`` on the
    2x4 ``grid`` (collectives 'pallas'): the geometry, the stacked local
    matrix, panel k made by B7 and its row-panel parts, the narrow column's
    slot mask (the slot of column k + 1) and the tiles below step k + 1."""
    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch.algorithms import _spmd
    from dlaf_tpu_torch.comm import collectives as coll
    from dlaf_tpu_torch.ops import panel_exchange as px

    mat = dtt.DistributedMatrix.from_global(grid, a, (nb, nb))
    g = _spmd.Geometry.of(mat.dist)

    def panel(x):
        myr, myc = coll.my_rank()
        gi = _spmd.local_row_tiles(g, myr, x.device)
        gj = _spmd.local_col_tiles(g, myc, x.device)
        d = _spmd.bcast_diag_tile(x, k, g, myr, myc)
        _, cp = px.fused_factor_bcast(d, x[:, k // g.pc].contiguous(), gi > k, k % g.pc, "c")
        taken, have = coll.transpose_panel_parts(cp, g.mt, g.ltc)
        return cp, taken, have, gj == k + 1, gi > k + 1

    return (g, mat.data) + tuple(on_ranks(grid, panel, [mat.data]))


def _ptxas_of(kernel: str) -> dict:
    """What ptxas said of one kernel instantiation in this run's build
    (empty when the library was not built in this process)."""
    from dlaf_tpu_torch.ops import _build

    for e in _build.ptxas_report:
        if kernel in e["kernel"]:
            return {k: e.get(k) for k in ("registers", "stack", "spill_stores", "spill_loads")}
    return {}


CONSUME_SPLIT_KERNELS = ("dma_ring_consume_split", "fused_step_split")


def _split_b6_body(x, y, have, supp, cp):
    """One rank's B6 call of a split case (``x`` updated in place)."""
    import torch

    from dlaf_tpu_torch.ops import trailing_update as tu

    _, yy, hh = tu.dma_ring_consume(x, y, have.to(torch.int32).reshape(-1, 1), cp,
                                    supp.to(torch.int32).reshape(-1, 1), "r")
    return yy, hh


def _split_b6_post(outs, rest):
    """B6's merged panel masked to the slots it applied (held after the
    ring and not suppressed), those slots, its bitwise outputs, and none
    held within tolerance."""
    import torch

    yy, hh = outs
    applied = (hh.reshape(hh.shape[:3]) != 0) & ~rest[1].to(hh.device)
    zero = torch.zeros((), dtype=yy.dtype, device=yy.device)
    return torch.where(applied[..., None, None], yy, zero), applied, [yy, hh], []


def consume_split_cases(gpu, a_glob, only=CONSUME_SPLIT_KERNELS):
    """The cases of B6's and B8's split bodies on the 2x4 card grid ``gpu``
    (:func:`consume_split_phase`, ``scripts/consume_ab.py``), made and
    yielded one at a time, each a dict: ``kernel``, ``key``, ``label``,
    ``body(x, y, *rest)`` (one rank's call, ``x`` updated in place),
    ``post(outs, rest)`` (the merged panel masked to the applied slots, the
    applied slots [Pr, Pc, slots], the outputs held bit for bit and those
    held within tolerance), ``x0``, ``y``, ``rest``, ``cp``, ``flops`` (of
    the split products' GEMM shape), ``other_flops``, ``nbytes`` and
    ``iters``.  B6 at step 0 of M5, at red2band's first window (K = 128)
    and in float64 at step 0 of the leading N_TIERS block at NB_M5; B8 at
    step 0 of M4 and in float64 at step 0 of the leading N_TIERS block.
    The caller drops a case before asking for the next."""
    import torch

    from dlaf_tpu_torch.ops import trailing_update as tu

    dev = a_glob.device
    pr, pc = GRID_M
    ranks = pr * pc

    def b6(key, label, x0, cp, taken, have, supp, iters):
        nb, k_ = x0.shape[-1], taken.shape[-1]
        ltr, ltc = x0.shape[2], x0.shape[3]
        esz = x0.element_size()
        applied = int((have.any(dim=0, keepdim=True).expand_as(have) & ~supp).sum())
        return {"kernel": "dma_ring_consume_split", "key": key, "label": label,
                "body": _split_b6_body, "post": _split_b6_post, "x0": x0, "y": taken,
                "rest": [have, supp, cp], "cp": cp,
                "flops": 2.0 * x0.shape[-2] * nb * k_ * ltr * applied, "other_flops": 0.0,
                "nbytes": ranks * (2 * ltr * ltc * nb * nb + ltr * nb * k_ + 2 * ltc * nb * k_)
                * esz, "iters": iters}

    if "dma_ring_consume_split" in only:
        # ---- M5's step 0 (nb = NB_M5 on its padded geometry), f32
        _, x5, cp5, tk5, hv5, sp5, _ = _step0(gpu, a_glob, NB_M5)
        yield b6("M5_step0", "step 0 of M5", x5, cp5, tk5, hv5, sp5, 2)
        del x5, cp5, tk5, hv5, sp5
        # ---- red2band's first window at path H's geometry on 2x4: L = ltr,
        # C = ltc, K = 128, the transposed W2 panel's parts
        nbh, band = NBH, 128
        mth = NH // NBH
        L, C = mth // pr, mth // pc
        gen = torch.Generator(device=dev).manual_seed(SEED_H)
        xw = torch.randn(pr, pc, L, C, nbh, nbh, generator=gen, device=dev)
        vr = torch.randn(pr, pc, L, nbh, band, generator=gen, device=dev)
        w2 = torch.randn(pr, pc, L, nbh, band, generator=gen, device=dev)

        def parts(w):
            from dlaf_tpu_torch.comm import collectives as coll

            _, myc = coll.my_rank()
            gj = torch.arange(C, device=w.device) * pc + myc
            taken, have = coll.transpose_panel_windowed_parts(w, gj, 0, mth)
            return taken, have, torch.zeros_like(have)

        tkw, hvw, spw = on_ranks(gpu, parts, [w2])
        del w2
        yield b6("red2band_window", f"red2band's first window, K={band}", xw, vr, tkw, hvw, spw,
                 3)
        del xw, vr, tkw, hvw, spw
        # ---- float64: step 0 of the leading N_TIERS block at NB_M5
        a64 = a_glob[:N_TIERS, :N_TIERS].double()
        _, x6, cp6, tk6, hv6, sp6, _ = _step0(gpu, a64, NB_M5)
        del a64
        yield b6("f64_step0", f"float64, step 0 at N={N_TIERS}, nb={NB_M5}", x6, cp6, tk6, hv6,
                 sp6, 3)
        del x6, cp6, tk6, hv6, sp6

    if "fused_step_split" in only:
        for key, label, iters in (("M4_step0", "step 0 of M4", 2),
                                  ("f64_step0", f"float64, step 0 at N={N_TIERS}, nb={NB}", 3)):
            a = a_glob if key == "M4_step0" else a_glob[:N_TIERS, :N_TIERS].double()
            g, x0, cp, taken, have, supp, below1 = _step0(gpu, a, NB)
            del a
            k1 = 1
            params = (k1 % g.pc, k1 % g.pr, k1 // g.pc, k1 // g.pr, k1 // g.pc)

            def b8_body(x, y, hv, z, c, bl, params=params):
                return tu.fused_step(x, y, hv, z, c, bl, params)[1:]

            def b8_post(outs, rest, params=params):
                # B8 applies the slots held on the ring over 'r' and not
                # suppressed, and on column k+1's ranks the narrow slot
                rp, lkk1, cp1, d1 = outs
                hv, sp = (t.to(rp.device) for t in rest[:2])
                narrow = torch.zeros_like(sp)
                narrow[:, params[0], params[2]] = True
                applied = hv.any(dim=0, keepdim=True).expand_as(hv) & (~sp | narrow)
                return rp, applied, [rp], [lkk1, cp1, d1]

            nb, esz = NB, x0.element_size()
            applied = int(have.any(dim=0, keepdim=True).expand_as(have).sum())
            rows_solved = int(below1[:, params[0]].sum()) * nb
            tile_b = nb * nb * esz
            yield {"kernel": "fused_step_split", "key": key, "label": label, "body": b8_body,
                   "post": b8_post, "x0": x0, "y": taken, "rest": [have, supp, cp, below1],
                   "cp": cp, "flops": 2.0 * nb ** 3 * g.ltr * applied,
                   "other_flops": ranks * nb ** 3 / 3 + rows_solved * nb * nb,
                   "nbytes": (ranks * (2 * g.ltr * g.ltc + g.ltr + 2 * g.ltc) * tile_b
                              + ranks * 3 * tile_b + pr * g.ltr * tile_b
                              + ranks * g.ltr * tile_b), "iters": iters}
            del g, x0, cp, taken, have, supp, below1


def consume_split_phase(stamp: dict, timed_ms, a_glob, only=CONSUME_SPLIT_KERNELS) -> dict:
    """Phase 2e: B6's and B8's split bodies (gemm_precision bf16x3 on f32,
    bf16x6 on f64) against their twins at the tier on a CPU grid of the
    same shape (2x4).  B6 at step 0 of M5 (nb = NB_M5), at red2band's first
    window of path H's geometry on 2x4 (x [8, 4, 512, 512], cp [8, 512,
    128], K = band = 128) and in float64 at step 0 of the leading N_TIERS
    block at NB_M5; B8 at step 0 of M4 and in float64 at step 0 of the
    leading N_TIERS block.  Each case has two checks, each first shown to
    reject the 'default'-tier kernel's output and the twin's with the
    split's (0, 1) product dropped:

    - normal operands: the applied update within tol_for(f32, K) of the
      twin's (a split tier is float32 class); the merged panel (and have)
      bit for bit;
    - the split probe: the row panel cut to one non-zero per row, so that
      every output is one product (B8's narrow update of column k+1
      included): x bit for bit the twin's, and farther than 1e-6 (f32;
      1e-10 in f64) from the 'default'-tier kernel's.

    On normal operands x is also bit for bit B3-split at the tier applied
    once on every rank to the merged panel masked to the slots the kernel
    applies (:func:`b3_bitwise_verdict`, first shown to reject B3-split
    with the last k16 slice of one applied slot dropped).

    B8's factor, new panel and diagonal tile are held to the twin's within
    tol_for(dtype, nb).  Every launch of the checks must run the split
    instantiation.  Times: the kernel and the 'default'-tier kernel in the
    same call, the twin (CPU), and the yardstick ``tile.contract`` at the
    tier, one per rank on the card; bounds with the split products at the
    bf16 tensor cores' rate.  Returns the report entries."""
    import torch

    from dlaf_tpu_torch import tune
    from dlaf_tpu_torch.comm.grid import Grid
    from dlaf_tpu_torch.ops import _build, tile
    from dlaf_tpu_torch.ops import trailing_update as tu
    from dlaf_tpu_torch.testing import tol_for

    dev = a_glob.device
    pr, pc = GRID_M
    ranks = pr * pc
    gpu, cpu = Grid.create(GRID_M, device=dev), Grid.create(GRID_M, device="cpu")
    tune.initialize(**PATH_M4)
    report, bad = {}, []
    sub = tu.CHOLESKY_SUBSCRIPTS
    zero_of = lambda t: torch.zeros((), dtype=t.dtype, device=t.device)  # noqa: E731

    def per_rank(fn, *stacked):
        """``fn`` on each rank's views of stacked tensors, restacked."""
        return torch.stack([torch.stack([fn(*(t[r, c] for t in stacked)) for c in range(pc)])
                            for r in range(pr)])

    def term01(cp, ymask):
        """The (0, 1) product of every rank's update cp[i] @ ymask[j]^T."""
        return per_rank(lambda a, b: _term01(sub, a, b), cp, ymask)

    def probe(y):
        """Stacked row-panel parts [..., slots, rows, K] with one non-zero
        left per row, at column (7 row + 3 slot) mod K."""
        s_, n_, k_ = y.shape[-3:]
        j = torch.arange(s_, device=y.device)[:, None].expand(s_, n_)
        c = torch.arange(n_, device=y.device)[None, :].expand(s_, n_)
        keep = torch.zeros((s_, n_, k_), dtype=torch.bool, device=y.device)
        keep[j, c, (7 * c + 3 * j) % k_] = True
        return torch.where(keep, y, zero_of(y))

    def checked(label, got, wrongs, ok):
        """``ok(candidate) -> (passes, metrics)``: every wrong answer must
        fail it, then the kernel's output must pass."""
        rejected = {w: ok(c)[0] for w, c in wrongs.items()}
        passes, metrics = ok(got)
        if any(rejected.values()):
            bad.append(f"{label}: the check accepts a wrong answer: {rejected}")
        if not passes:
            bad.append(f"{label}: {metrics}")
        return metrics, rejected

    def case(kernel, label, body, x0, y, rest, post, flops, other_flops, nbytes, iters):
        """The checks and the times of one case.  ``body(x, y, *rest)`` is
        one rank's call of the wrapper (the kernel on the card grid, its
        twin on the CPU grid), updating ``x`` in place; ``post(outs, rest)``
        gives the merged panel masked to the applied slots, the applied
        slots ([Pr, Pc, slots] bool), the outputs that must be bitwise and
        those held within tolerance."""
        f64 = x0.dtype == torch.float64
        tier = "bf16x6" if f64 else "bf16x3"
        tol = tol_for("float32", y.shape[-1])
        cp = rest[-1] if kernel.startswith("dma") else rest[2]
        rest_c = [t.cpu() for t in rest]
        x0c = x0.to("cpu", copy=True)

        def card(tier_, y_):
            x = x0.clone()
            with tune.gemm_precision_scope(tier_):
                outs = on_ranks(gpu, body, [x, y_] + rest)
            _sync()
            return x, post(outs, rest)

        def twin(y_):
            x = x0c.clone()
            t0 = time.perf_counter()
            with tune.gemm_precision_scope(tier):
                outs = on_ranks(cpu, body, [x, y_.cpu()] + rest_c)
            ms = (time.perf_counter() - t0) * 1e3
            _, _, same, near = post(outs, rest_c)
            return x.to(dev), [t.to(dev) for t in same], [t.to(dev) for t in near], ms

        before = tu.consume_split_launches + tu.fused_step_split_launches
        # normal operands
        xk, (ymask, applied_k, same_k, near_k) = card(tier, y)
        b3 = b3_bitwise_verdict(f"{kernel} [{label}]", xk, x0, cp, ymask, applied_k, tier)
        bad.extend(b3.pop("problems"))
        xt, same_t, near_t, plain_ms = twin(y)
        bitwise = all(torch.equal(a, b) for a, b in zip(same_k, same_t))
        near = {nm: _rel_dev(a, b)[1] for nm, a, b in zip(("lkk1", "cp1", "d1"), near_k, near_t)}
        upd_t = xt - x0
        err_abs = _rel_dev(xk - x0, upd_t)[0]

        def within(c):
            e = _rel_dev(c - x0, upd_t)[1]
            return e <= tol, {"rel_err_vs_plain": e, "tol": tol}

        normal, rej_n = checked(f"{kernel} [{label}] (normal operands)", xk,
                                {"term_0_1_dropped": xt + term01(cp, ymask)}, within)
        vs_default = _rel_dev(xk - x0, card("default", y)[0] - x0)[1]
        del xk, xt, upd_t
        # the split probe
        yp = probe(y)
        xk_p, (ymask_p, _, same_kp, _) = card(tier, yp)
        xt_p, same_tp, _, _ = twin(yp)
        xd_p, _ = card("default", yp)
        bitwise = bitwise and all(torch.equal(a, b) for a, b in zip(same_kp, same_tp))
        floor = 1e-10 if f64 else 1e-6

        def split(c):
            same, e = bool(torch.equal(c, xt_p)), _rel_dev(c - x0, xd_p - x0)[1]
            return same and e > floor, {"probe_bitwise_vs_plain": same,
                                        "probe_rel_err_vs_default": e, "probe_floor": floor}

        probed, rej_p = checked(f"{kernel} [{label}] (split probe)", xk_p,
                                {"default_tier_kernel": xd_p,
                                 "term_0_1_dropped": xt_p + term01(cp, ymask_p)}, split)
        del xk_p, xt_p, xd_p, yp
        split_runs = tu.consume_split_launches + tu.fused_step_split_launches - before
        if not bitwise:
            bad.append(f"{kernel} [{label}]: merged panel or have not bitwise the twin's")
        # B8's factor, panel and tile come from a split update: float32 class
        tol_near = tol_for("float32", x0.shape[-1])
        if not all(v <= tol_near for v in near.values()):
            bad.append(f"{kernel} [{label}]: factor, panel or tile vs twin {near} > {tol_near}")
        if dev.type == "cuda" and split_runs != 2 * ranks:  # the normal and the probe run
            bad.append(f"{kernel} [{label}]: {split_runs} split launches, want {2 * ranks}")
        # times: the kernel and the 'default'-tier kernel in turns, the yardstick
        xs = x0.clone()
        spans = {}
        for t_ in (tier, "default", "default", tier):
            with tune.gemm_precision_scope(t_):
                spans.setdefault(t_, []).append(grid_span_ms(gpu, body, [xs, y] + rest, iters)[0])
        pairs = [(cp[r, c], ymask[r, c]) for r in range(pr) for c in range(pc)]
        yard_ms = timed_ms(lambda: [tile.contract(sub, a, b, tier) for a, b in pairs], 2)
        del xs, pairs
        ns = tile.SPLIT_SLICES[tier]
        nterms = len(tile.split_terms(ns))
        t_ops = (nterms * flops / BF16_PEAK + other_flops / FP32_PEAK) * 1e3
        t_bytes = nbytes / HBM_RATE * 1e3
        b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        t_name = "double" if f64 else "float"
        b6 = kernel.startswith("dma")
        inst = (f"consume_kernel<{t_name}, {ns}>" if b6
                else f"fused_step_kernel<{t_name}, {ns}>")
        per_sm = (_build.lib().dlaf_ring_consumer_blocks_per_sm(
            0 if b6 else 1, int(f64), ns, int(x0.shape[2]), int(y.shape[-3]),
            int(x0.shape[-1]), int(y.shape[-1]),
            torch.cuda.get_device_properties(dev).multi_processor_count // ranks)
                  if dev.type == "cuda" else None)
        rec = {"kernel": kernel, "case": label, "dtype": "float64" if f64 else "float32",
               "tier": tier, "nslices": ns, "products": nterms,
               "shape": {"x": list(x0.shape[2:]), "cp": list(cp.shape[2:]),
                         "y": list(y.shape[2:])}, "ranks": ranks,
               "bitwise_vs_plain_panel_have": bitwise, "max_abs_err": err_abs, **normal,
               "rel_err_vs_default": vs_default, **probed, **b3, "rel_err_vs_plain_outputs": near,
               "wrong_answers_pass": {"normal": rej_n, "split_probe": rej_p},
               "kernel_ms": min(spans[tier]), "default_tier_kernel_ms": min(spans["default"]),
               "spans_ms_in_turns": {"split": spans[tier], "default": spans["default"]},
               "plain_ms": plain_ms, "plain_on": "cpu, at the tier (the twin's rings are host "
                                                 "objects)",
               "yardstick_ms": yard_ms,
               "yardstick": "tile.contract at the tier, one per rank on the card (bf16 slices "
                            "upcast, one float32 einsum per product)",
               "library_ms": None,
               "library_call": "none: no single PyTorch call computes a split product",
               "bound_ms": b_ms, "bound_by": b_by,
               "bound_counts": f"{nterms} bf16 products per applied tile pair at "
                               f"{BF16_PEAK:.3g} FLOP/s (B8: its factor and solve at "
                               f"{FP32_PEAK:.3g}); bytes: x read and written, cp, the panel "
                               "read and the merged panel written, every rank",
               "instantiation": inst, "ptxas": _ptxas_of(inst), "blocks_per_sm": per_sm,
               **stamp}
        emit(rec)
        return rec

    for spec in consume_split_cases(gpu, a_glob, only):
        report.setdefault(spec["kernel"], {})[spec["key"]] = case(
            spec["kernel"], spec["label"], spec["body"], spec["x0"], spec["y"], spec["rest"],
            spec["post"], spec["flops"], spec["other_flops"], spec["nbytes"], spec["iters"])
        del spec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for kernel, first in (("dma_ring_consume_split", "M5_step0"),
                          ("fused_step_split", "M4_step0")):
        if kernel in report:
            recs = report[kernel]
            report[kernel] = {**recs[first], "cases": recs,
                              "max_abs_err": worst(r["max_abs_err"] for r in recs.values())}
    if bad:
        fail("B6's and B8's split bodies vs their twins: " + "; ".join(bad))
    return report


class _RefineProbe:
    """Records the RefineInfo of every ``refine.residual_refine`` call made
    while it is active (the solvers do not return it)."""

    def __enter__(self):
        from dlaf_tpu_torch.algorithms import refine

        self.mod, self.inner, self.infos = refine, refine.residual_refine, []

        def wrapped(*args, **kw):
            x, info = self.inner(*args, **kw)
            self.infos.append(info)
            return x, info

        refine.residual_refine = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.residual_refine = self.inner


def _backward_err(a, x, b) -> float:
    """||B - A X||_max / (||X||_max ||A||_max), float64 on the card."""
    r = (b.double() - a.double() @ x.double()).abs().max()
    return (r / (x.double().abs().max() * a.double().abs().max())).item()


def path_split(stamp: dict, a_glob, rhs, solve_err, res_tol, by_path: dict) -> dict:
    """Phase 5e: the split-GEMM solvers at N, NB.  S1, POSV with
    refine_to='input' on 1x1 under path B's knobs and bf16x3 (B1, B2 and B3's
    split body in the factor); S2, the same call on the 2x4 grid with the
    'xla' bulk update (products split in tile.contract, the residual a
    SUMMA hermitian_multiplication over B5 under the 'default' scope: every
    rank thread's residual contractions at 'default', none split); S5, S2's
    call under the fused tier (B8's split body on every step and rank, the
    residual still at 'default'); S3,
    positive_definite_solver_mixed on the 2x4 grid at the default tier, an
    f64 matrix factored in f32.  Each check is first shown to reject a wrong
    answer.  Returns each run's launch counts."""
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import ops, tune
    from dlaf_tpu_torch.algorithms import solver
    from dlaf_tpu_torch.matrix import layout
    from dlaf_tpu_torch.ops import tile
    from dlaf_tpu_torch.testing import tol_for

    n, nb = N, NB
    dev = a_glob.device
    counts_by = {}

    def posv(grid, refine):
        mat_a = dtt.DistributedMatrix.from_global(grid, a_glob, (nb, nb))
        mat_b = dtt.DistributedMatrix.from_global(grid, rhs.clone(), (nb, nb))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        tile.contract_counts.clear()
        with _RefineProbe() as probe:
            t0 = time.perf_counter()
            x, info = dtt.positive_definite_solver("L", mat_a, mat_b, return_info=True,
                                                   refine_to="input" if refine else None)
            info = int(info)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        x = layout.unpack(x.data, x.dist)[:n, :nb]
        return x, info, wall, launch_counts(), dict(tile.contract_counts), probe.infos

    def refine_record(infos):
        return [{"sweeps": i.sweeps, "converged": i.converged, "residual": i.residual,
                 "backward_error": i.backward_error} for i in infos]

    be_wrong = _backward_err(a_glob, rhs, rhs)  # the backward-error check rejects X = B

    # ---- S1: 1x1, path B's knobs, bf16x3: the factor's B3 in its split body
    tune.initialize(**PATH_S1)
    grid1 = dtt.Grid.create()
    x0, info0, wall0, _, _, _ = posv(grid1, False)
    err0 = solve_err(x0)
    del x0
    x1, info1, wall1, counts, contracts, infos = posv(grid1, True)
    err1, be1 = solve_err(x1), _backward_err(a_glob, x1, rhs)
    del x1
    torch.cuda.empty_cache()
    counts_by["S1"] = counts
    ri = refine_record(infos)
    emit({"phase": "path_S1", "config": "positive_definite_solver(return_info=True, "
          "refine_to='input'), gemm_precision=bf16x3, lookahead, trailing_update_impl=fused, "
          "panel_trsm_pallas=1", "grid": [1, 1], "n": n, "nrhs": nb, "wall_s": wall1,
          "info": info1, "refine": ri, "solve_forward_err": err1, "backward_err": be1,
          "backward_err_of_x_eq_b": be_wrong, "unrefined": {"wall_s": wall0, "info": info0,
                                                             "solve_forward_err": err0},
          "tol": res_tol, "launches": counts,
          "contracts_by_thread_and_tier": {f"{k[0]}:{k[1]}": v for k, v in contracts.items()},
          "split_launches_of_path_B_factor": by_path["B_factor"]["trailing_update_split"],
          **stamp})
    if not (info0 == info1 == 0 and len(ri) == 1 and ri[0]["converged"]
            and err1 <= res_tol and be1 <= res_tol < be_wrong):
        fail(f"path S1: info {info1}, refine {ri}, forward error {err1:.3e}, backward error "
             f"{be1:.3e} (of X = B {be_wrong:.3e}; tol {res_tol:.3e})")
    if counts["trailing_update_split"] <= 0 or by_path["B_factor"]["trailing_update_split"] \
            or min(counts["potrf"], counts["panel_trsm"]) <= 0:
        fail(f"path S1 did not launch B3's split body (path B, default tier: "
             f"{by_path['B_factor']['trailing_update_split']}), B1 and B2: {counts}")

    # ---- S2: 2x4, the 'xla' update, bf16x3; the residual under 'default'
    tune.initialize(**PATH_S2)
    grid = dtt.Grid.create(GRID_M)
    ranks = [f"dlaf-rank-{r}-{c}" for r in range(GRID_M[0]) for c in range(GRID_M[1])]
    residual_counts = []
    inner = solver.hermitian_multiplication

    def counted(*args, **kw):
        before = dict(tile.contract_counts)
        out = inner(*args, **kw)
        residual_counts.append({k: v - before.get(k, 0) for k, v in tile.contract_counts.items()
                                if v != before.get(k, 0)})
        return out

    def unsplit_everywhere(diff) -> bool:
        return all(diff.get((r, "default"), 0) > 0 and not any(
            diff.get((r, s), 0) for s in tile.SPLIT_SLICES) for r in ranks)

    solver.hermitian_multiplication = counted
    try:
        x2, info2, wall2, counts, contracts, infos = posv(grid, True)
        # the same residual outside the scope, under the ambient bf16x3: the
        # check must reject it
        mat_a = dtt.DistributedMatrix.from_global(grid, a_glob, (nb, nb))
        mat_x = dtt.DistributedMatrix.from_global(grid, x2.contiguous(), (nb, nb))
        mat_c = dtt.DistributedMatrix.from_global(grid, rhs.clone(), (nb, nb))
        solver.hermitian_multiplication("Left", "L", -1.0, mat_a, mat_x, 1.0, mat_c)
        unscoped = residual_counts.pop()
        del mat_a, mat_x, mat_c
    finally:
        solver.hermitian_multiplication = inner
    err2, be2 = solve_err(x2), _backward_err(a_glob, x2, rhs)
    del x2
    torch.cuda.empty_cache()
    counts_by["S2"] = counts
    ri = refine_record(infos)
    split_in_ranks = {r: sum(contracts.get((r, s), 0) for s in tile.SPLIT_SLICES) for r in ranks}
    emit({"phase": "path_S2", "config": "positive_definite_solver(return_info=True, "
          "refine_to='input'), gemm_precision=bf16x3, lookahead, trailing_update_impl=xla, "
          "collectives_impl=pallas, panel_trsm_pallas=1", "grid": list(GRID_M), "n": n,
          "nrhs": nb, "wall_s": wall2, "info": info2, "refine": ri,
          "solve_forward_err": err2, "backward_err": be2, "tol": res_tol, "launches": counts,
          "split_contracts_by_rank_thread": split_in_ranks,
          "residual_contracts": [{f"{k[0]}:{k[1]}": v for k, v in d.items()}
                                 for d in residual_counts],
          "residual_unsplit_in_every_rank_thread": [unsplit_everywhere(d)
                                                    for d in residual_counts],
          "unscoped_residual_passes_the_check": unsplit_everywhere(unscoped), **stamp})
    if not (info2 == 0 and len(ri) == 1 and ri[0]["converged"] and err2 <= res_tol
            and be2 <= res_tol):
        fail(f"path S2: info {info2}, refine {ri}, forward error {err2:.3e}, backward error "
             f"{be2:.3e} (tol {res_tol:.3e})")
    if unsplit_everywhere(unscoped) or not residual_counts \
            or not all(unsplit_everywhere(d) for d in residual_counts):
        fail(f"path S2: a residual was split in a rank thread, or the check does not reject "
             f"an unscoped one: {residual_counts}, unscoped {unscoped}")
    if min(split_in_ranks.values()) <= 0 or counts["ring_exchange"] <= 0:
        fail(f"path S2: the factor and solves did not split in every rank thread "
             f"({split_in_ranks}) or B5 did not run: {counts}")

    # ---- S5: S2's call under the fused tier: B8's split body per step and
    # rank; the residual under the 'default' scope in every rank thread
    tune.initialize(**PATH_S5)
    residual_counts.clear()
    solver.hermitian_multiplication = counted
    try:
        x5, info5, wall5, counts, contracts, infos = posv(grid, True)
    finally:
        solver.hermitian_multiplication = inner
    err5, be5 = solve_err(x5), _backward_err(a_glob, x5, rhs)
    del x5
    torch.cuda.empty_cache()
    counts_by["S5"] = counts
    ri = refine_record(infos)
    steps = len(ranks) * (n // nb - 1)
    emit({"phase": "path_S5", "config": "positive_definite_solver(return_info=True, "
          "refine_to='input'), gemm_precision=bf16x3, lookahead, trailing_update_impl=fused, "
          "trsm_lookahead, collectives_impl=pallas, panel_trsm_pallas=1", "grid": list(GRID_M),
          "n": n, "nrhs": nb, "wall_s": wall5, "info": info5, "refine": ri,
          "solve_forward_err": err5, "backward_err": be5, "tol": res_tol, "launches": counts,
          "launches_per_rank": {k_: v / len(ranks) for k_, v in counts.items()},
          "residual_contracts": [{f"{k[0]}:{k[1]}": v for k, v in d.items()}
                                 for d in residual_counts],
          "residual_unsplit_in_every_rank_thread": [unsplit_everywhere(d)
                                                    for d in residual_counts], **stamp})
    if not (info5 == 0 and len(ri) == 1 and ri[0]["converged"] and err5 <= res_tol
            and be5 <= res_tol < be_wrong):
        fail(f"path S5: info {info5}, refine {ri}, forward error {err5:.3e}, backward error "
             f"{be5:.3e} (tol {res_tol:.3e})")
    if not residual_counts or not all(unsplit_everywhere(d) for d in residual_counts):
        fail(f"path S5: a residual was split in a rank thread: {residual_counts}")
    if not (counts["fused_step"] == counts["fused_step_split"] == steps
            and counts["dma_ring_consume"] == counts["dma_ring_consume_split"]):
        fail(f"path S5 launched B8 {counts['fused_step']} times, its split body "
             f"{counts['fused_step_split']} (want {steps} each; B6 all split): {counts}")

    # ---- S3: the mixed-precision solver, 2x4, default tier
    tune.initialize(**PATH_M1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    g = torch.randn(n, n, generator=gen, device=dev, dtype=torch.float64)
    a64 = g @ g.T / n
    del g
    a64.diagonal().add_(1.0)
    b64 = torch.randn(n, nb, generator=gen, device=dev, dtype=torch.float64)
    x_ref64 = torch.cholesky_solve(b64, torch.linalg.cholesky(a64))
    torch.cuda.empty_cache()
    mat_a = dtt.DistributedMatrix.from_global(grid, a64, (nb, nb))
    mat_b = dtt.DistributedMatrix.from_global(grid, b64, (nb, nb))
    del a64
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    x3, info3 = dtt.positive_definite_solver_mixed("L", mat_a, mat_b)
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    counts = launch_counts()
    counts_by["S3"] = counts
    x3 = layout.unpack(x3.data, x3.dist)[:n, :nb]

    def err64(x):
        return (torch.linalg.matrix_norm(x.double() - x_ref64)
                / torch.linalg.matrix_norm(x_ref64)).item()

    tol64 = tol_for("float64", n)
    e3, e3_f32 = err64(x3), err64(x3.float())  # the check rejects an f32-class solution
    del mat_a, mat_b, x3, x_ref64, b64
    torch.cuda.empty_cache()
    emit({"phase": "path_S3", "config": "positive_definite_solver_mixed, float64 A and B, "
          "factor float32, collectives_impl=pallas, panel_trsm_pallas=1", "grid": list(GRID_M),
          "n": n, "nrhs": nb, "wall_s": wall3, "iters": info3.iters,
          "converged": info3.converged, "fallback": info3.fallback,
          "backward_error": info3.backward_error, "forward_err_f64": e3,
          "forward_err_of_the_solution_in_f32": e3_f32, "tol": tol64, "launches": counts,
          **stamp})
    if not (info3.converged and not info3.fallback and e3 <= tol64 < e3_f32):
        fail(f"path S3: converged {info3.converged}, fallback {info3.fallback}, forward error "
             f"{e3:.3e} (of its f32 rounding {e3_f32:.3e}; tol {tol64:.3e})")
    if min(counts[k] for k in ("potrf", "panel_trsm", "ring_exchange")) <= 0:
        fail(f"path S3 did not launch B1, B2 and B5: {counts}")
    return counts_by


def path_red2band(stamp: dict, dev) -> dict:
    """Phase 5f: reduction_to_band of path H's matrix (NH, NBH, band 128,
    seed SEED_H, f32) on the 2x4 grid under PATH_R: R1 at the 'default'
    tier (B3 for the first addend and B6 for the second, once per panel and
    rank), R2 under bf16x3 (both split bodies).  Checks, in float64 on the
    card, each relative to ||A||_2 and held to tol_for(f32, NH):

    - zero outside the band: C = Q^H A Q, Q rebuilt from the stored
      reflectors and taus (compact WY per panel, T from the UT relation
      T^-1 = diag(1 / tau) + striu(V^H V)), has no entry above rounding
      more than ``band`` off the diagonal;
    - C's band is the band the reduction stored;
    - the band's eigenvalues are A's.

    Each check is first shown to reject a wrong band: the same reduction
    on the 1x1 grid with the second addend of one panel dropped.  The
    distance of each band to the 1x1 grid's (path H's first stage) is
    reported, of the entries and of their magnitudes (the band is defined
    up to the signs of its rows and columns).  Returns each run's launch
    counts."""
    import numpy as np
    import torch

    import dlaf_tpu_torch as dtt
    from dlaf_tpu_torch import ops, tune
    from dlaf_tpu_torch.algorithms.reduction_to_band import get_band_size
    from dlaf_tpu_torch.matrix import layout
    from dlaf_tpu_torch.ops import trailing_update as tu
    from dlaf_tpu_torch.testing import random_hermitian_pd, tol_for

    n, nb = NH, NBH
    a_np = random_hermitian_pd(n, np.float32, seed=SEED_H)
    a_low = torch.from_numpy(np.tril(a_np)).to(dev)
    a64 = torch.from_numpy(a_np).to(dev).double()
    del a_np
    band = get_band_size(nb, dev)
    n_panels = (n - 1) // band
    w_ref = torch.linalg.eigvalsh(a64)
    norm2 = w_ref.abs().max().item()
    tol = tol_for("float32", n)
    idx = torch.arange(n, device=dev)
    off = idx[:, None] - idx[None, :]
    in_band = (off >= 0) & (off <= band)
    grid = dtt.Grid.create(GRID_M, device=dev)
    ranks = grid.size

    def reduce(grid_, tier):
        tune.initialize(**PATH_R, gemm_precision=tier)
        mat = dtt.DistributedMatrix.from_global(grid_, a_low, (nb, nb))
        _sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out, taus = dtt.reduction_to_band(mat, band=band)
        _sync()
        wall = time.perf_counter() - t0
        g = layout.unpad_global(layout.unpack(out.data, out.dist), out.dist)
        return torch.where(in_band, g, torch.zeros((), dtype=g.dtype, device=dev)), g, taus, \
            wall, launch_counts()

    def qhaq(g, taus):
        """Q^H A Q in float64, Q = Q_0 Q_1 ... from the reflectors below the
        band (unit heads on the band's last sub-diagonal) and the taus."""
        c = a64.clone()
        for p in range(n_panels):
            s = (p + 1) * band
            t = taus[p].double()
            v = torch.tril(g[s:, p * band:(p + 1) * band].double(), -1)
            v = v + torch.eye(n - s, band, dtype=torch.float64, device=dev)
            v = torch.where(t[None, :] != 0, v, torch.zeros((), dtype=v.dtype, device=dev))
            tinv = torch.triu(v.T @ v, 1) + torch.diag(torch.where(t != 0, 1.0 / t, 1.0))
            tm = torch.linalg.solve_triangular(tinv, torch.eye(band, dtype=torch.float64,
                                                               device=dev), upper=True)
            tm = torch.where(t[None, :] != 0, tm, torch.zeros((), dtype=tm.dtype, device=dev))
            c[s:, :] -= v @ (tm.T @ (v.T @ c[s:, :]))
            c[:, s:] -= (c[:, s:] @ v) @ tm @ v.T
        return c

    def checks(lb, g, taus):
        c = qhaq(g, taus)
        outside = (c.abs() * (off.abs() > band)).max().item() / norm2
        band_vs_c = ((c - lb.double()) * in_band).abs().max().item() / norm2
        del c
        b = lb.double()
        b = b + torch.tril(b, -1).T
        eig = ((torch.linalg.eigvalsh(b) - w_ref).abs().max() / norm2).item()
        return {"outside_band_of_QhAQ": outside, "band_vs_QhAQ": band_vs_c, "eig_err": eig}

    # the 1x1 grid's band, and a wrong one: panel 5's second addend dropped
    ref_lb, _, _, wall_1x1, _ = reduce(dtt.Grid.create(device=dev), "default")
    inner, calls = tu.fused_transpose_update, []

    def drop_one(x, cp, taken, have, suppress, axis="r"):
        calls.append(None)
        if len(calls) == 6:
            return x, None
        return inner(x, cp, taken, have, suppress, axis)

    tu.fused_transpose_update = drop_one
    try:
        bad_lb, bad_g, bad_taus, _, _ = reduce(dtt.Grid.create(device=dev), "default")
    finally:
        tu.fused_transpose_update = inner
    wrong = checks(bad_lb, bad_g, bad_taus)
    del bad_lb, bad_g, bad_taus
    counts_by, runs = {}, {}
    for label, tier in (("R1", "default"), ("R2", "bf16x3")):
        lb, g, taus, wall, counts = reduce(grid, tier)
        got = checks(lb, g, taus)
        # the band is defined up to signs (D B D, D = diag(+-1): a reflector
        # whose head is near zero may flip), so magnitudes are compared too
        vs_1x1 = ((lb - ref_lb).abs().max() / norm2).item()
        vs_1x1_mag = ((lb.abs() - ref_lb.abs()).abs().max() / norm2).item()
        del lb, g, taus
        counts_by[label] = counts
        want = ranks * n_panels
        split = tier != "default"
        launches_ok = (counts["trailing_update"] == counts["dma_ring_consume"] == want
                       and counts["trailing_update_split"] == (want if split else 0)
                       and counts["dma_ring_consume_split"] == (want if split else 0))
        runs[label] = {"tier": tier, "wall_s": wall, "checks": got, "launches": counts,
                       "launches_ok": launches_ok}
        emit({"phase": f"path_{label}", "config": f"reduction_to_band, gemm_precision={tier}, "
              + ", ".join(f"{k}={v}" for k, v in PATH_R.items()), "grid": list(GRID_M), "n": n,
              "nb": nb, "band": band, "panels": n_panels, "seed": SEED_H, "wall_s": wall,
              "checks": got, "tol": tol, "wrong_band_checks": wrong,
              "wrong_band": "1x1 grid, the second addend of panel 5 dropped",
              "max_abs_vs_1x1_band_over_norm2": vs_1x1,
              "max_abs_vs_1x1_band_magnitudes_over_norm2": vs_1x1_mag, "wall_s_1x1": wall_1x1,
              "launches": counts, "launches_per_rank": {k: v / ranks for k, v in counts.items()},
              **stamp})
    del a64, a_low, ref_lb
    if not all(v > tol for v in wrong.values()):
        fail(f"path R: a check accepts the band with one panel's second addend dropped: {wrong}")
    for label, r in runs.items():
        if not (all(v <= tol for v in r["checks"].values()) and r["launches_ok"]):
            fail(f"path {label}: checks {r['checks']} (tol {tol:.3e}), launches {r['launches']} "
                 f"(want B3 and B6 {ranks * n_panels} times{', all split' if label == 'R2' else ''})")
    return counts_by


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "dlaf_tpu_torch")):
        print("chip_smoke: dlaf_tpu_torch/ is not beside this script", flush=True)
        return 2
    sys.path.insert(0, HERE)
    # imported before torch touches the card: the package asks CUDA for
    # what its ring kernels need (dlaf_tpu_torch/__init__.py)
    import dlaf_tpu_torch as dtt
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", flush=True)
        return 2

    from dlaf_tpu_torch import native, ops, tune
    from dlaf_tpu_torch.matrix import layout
    from dlaf_tpu_torch.ops import _build, potrf, secular, trailing_update
    from dlaf_tpu_torch.testing import tol_for

    n, nb = N, NB
    dev = torch.device("cuda")
    card = card_line()
    stamp = {"card": card}

    # ---- 0. header
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; N={n} nb={nb} seed={SEED}",
          flush=True)

    # ---- 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    t1 = time.perf_counter()
    chase_path = native.build()
    native.lib()
    emit({"phase": "build", "library": os.path.relpath(lib_path, HERE),
          "nvcc_s": round(_build.build_seconds, 3),
          "build_and_load_s": round(t1 - t0, 3),
          "sources": [os.path.relpath(p, HERE) for p in _build.sources()],
          "chase_library": os.path.relpath(chase_path, HERE),
          "chase_build_and_load_s": round(time.perf_counter() - t1, 3),
          "chase_source": os.path.relpath(native.SOURCE, HERE)})
    # registers and spills of the ring consumers', the split bodies' (B3's
    # and B9's pre-pass and body at <float|double, 2|3> slices, subtracting
    # or writing; B6's and B8's) and the FMA body's instantiations
    # (-Xptxas -v)
    emit({"phase": "ptxas", "kernels": [e for e in _build.ptxas_report
                                        if "consume_kernel" in e["kernel"]
                                        or "fused_step_kernel" in e["kernel"]
                                        or "fused_kernel" in e["kernel"]
                                        or "potrf" in e["kernel"]
                                        or e.get("device_function")
                                        or "split_gemm_kernel" in e["kernel"]
                                        or "split_cut_kernel" in e["kernel"]
                                        or "_fma_kernel" in e["kernel"]
                                        or "panel_trsm" in e["kernel"]
                                        or "merge" in e["kernel"]]})

    # B7's and B8's residency on this card (csrc/factor_send.cuh): every
    # rank's G blocks spin at once, so each block must fit an SM alone;
    # cudaOccupancyMaxActiveClusters of B1's cluster of 8 at the same tile
    # is what a cluster design would have had on an empty card
    emit(residency_record())

    def rel_err(got, ref) -> tuple[float, float]:
        """Max abs error, and the Frobenius norm of the error over ref's."""
        diff = got.double() - ref.double()
        rel = torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(ref.double())
        return diff.abs().max().item(), rel.item()

    # ---- 2. kernels vs plain versions (f32, main-path shapes)
    # Inputs of their own, from seed SEED + 1: the main path's matrix is
    # diagonally dominant, so against it a kernel that drops a few terms
    # would still agree within the tolerance.  Each tolerance is
    # tol_for(f32, k) with k the length of the kernel's inner sums (nb).
    kgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    report = {}

    # B1 potrf: the cluster kernel against its plain version and against the
    # one-block kernel it replaced, timed in turns with it
    report["potrf"], ell = potrf_phase(stamp, bound, timed_ms, kgen)

    # B2 panel TRSM: the Hopper body against its reference (the first body)
    # on that factor and at the sweep's heights, f64 and ragged shapes
    report["panel_trsm"] = panel_trsm_phase(stamp, bound, timed_ms, kgen, ell)
    del ell

    # B3 in both lookahead forms and at red2band's shapes, and in f64: the
    # FMA body against the reference kernel (the first body) in turns
    report["trailing_update"] = trailing_update_phase(stamp, bound, timed_ms, kgen)
    # B3 and B9 at ragged shapes and in f64, bit for bit their reference kernels
    report["fma_body_edges"] = fma_edge_phase(stamp, timed_ms, kgen)

    # B3 and B9 under the split tiers, at the same shapes
    report.update(split_phase(stamp, timed_ms, kgen))

    # B10 secular bisection at path H's shapes, bit for bit its first body
    report["secular_bisect"] = secular_phase(stamp, bound, timed_ms, kgen)
    torch.cuda.empty_cache()

    # B4, B5 and B7 at path M's shapes, on a 2x4 grid of rank threads
    report.update(ring_phases(stamp, bound, kgen))

    # the main path's matrix and right-hand side
    a_glob, rhs = make_inputs(dev)
    torch.cuda.synchronize()

    # B6, B8 and B9 at the fused paths' shapes (B8 on step 0 of M4)
    report.update(consume_phases(stamp, bound, timed_ms, a_glob))

    # B6's and B8's split bodies at the same steps, red2band's window and f64
    report.update(consume_split_phase(stamp, timed_ms, a_glob))

    # small ragged input: the port's factor (kernels on) vs torch.linalg.cholesky
    ns = 2 * nb + nb // 2 + 8
    tune.initialize(cholesky_lookahead=True, trailing_update_impl="fused", panel_trsm_pallas=True)
    small = a_glob[:ns, :ns].double()
    mat = dtt.DistributedMatrix.from_global(dtt.Grid.create(), a_glob[:ns, :ns].clone(), (nb, nb))
    fac = dtt.cholesky_factorization("L", mat, backend="distributed")
    got = torch.tril(torch.from_numpy(fac.to_global()).to(dev).double())
    ref = torch.linalg.cholesky(small)
    _, err = rel_err(got, ref)
    tol = tol_for("float32", ns)
    emit({"phase": "small_reference", "n": ns, "nb": nb, "rel_err_vs_torch_cholesky": err,
          "tol": tol, "finite": bool(torch.isfinite(got).all())})
    if not (err <= tol and torch.isfinite(got).all()):
        fail(f"small ragged factor vs torch.linalg.cholesky: {err:.3e} > {tol:.3e}")
    del small, mat, fac, got, ref

    def factor_residual(data_mat) -> float:
        lo = torch.tril(layout.unpack(data_mat.data, data_mat.dist)[:n, :n].double())
        a64 = a_glob.double()
        r = (torch.linalg.matrix_norm(a64 - lo @ lo.T) / torch.linalg.matrix_norm(a64)).item()
        del lo, a64
        return r

    res_tol = tol_for("float32", n)

    # the reference solution, float64 on the card; solutions are held to it
    # by their relative forward error (cond(A) <= 5, so a correct f32 solve
    # lands orders below res_tol)
    a64 = a_glob.double()
    x_ref = torch.cholesky_solve(rhs.double(), torch.linalg.cholesky(a64))
    del a64
    torch.cuda.empty_cache()

    def solve_err(x) -> float:
        return (torch.linalg.matrix_norm(x.double() - x_ref)
                / torch.linalg.matrix_norm(x_ref)).item()

    not_solved = solve_err(rhs)
    emit({"phase": "solve_check", "forward_err_of_x_eq_b": not_solved, "tol": res_tol})
    if not not_solved > res_tol:
        fail(f"the solve check accepts X = B ({not_solved:.3e} <= {res_tol:.3e})")

    def factor_run(backend="distributed"):
        mat = dtt.DistributedMatrix.from_global(dtt.Grid.create(), a_glob, (nb, nb))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fac = dtt.cholesky_factorization("L", mat, backend=backend)
        torch.cuda.synchronize()
        return fac, time.perf_counter() - t0, launch_counts()

    gflop = n ** 3 / 3 / 1e9
    by_path = {}

    # ---- 3. path A: the headline configuration
    os.environ["DLAF_TPU_PANEL_TRSM_PALLAS"] = "1"
    tune.initialize(**PATH_A)
    factor_run()  # warm-up (allocator, library handles), as bench.py discards its first run
    fac, wall, counts = factor_run()
    res = factor_residual(fac)
    del fac
    emit({"phase": "path_A", "config": "bucketed, panel_trsm_pallas=1", "n": n, "nb": nb,
          "wall_s": wall, "gflops": gflop / wall, "factor_residual": res, "tol": res_tol,
          "launches": counts, **stamp})
    by_path["A_factor"] = counts
    if not res <= res_tol:
        fail(f"path A residual {res:.3e} > {res_tol:.3e}")
    if counts["potrf"] <= 0 or counts["panel_trsm"] <= 0 \
            or counts["potrf_cluster"] != counts["potrf"]:
        fail(f"path A did not launch potrf (all on the cluster) and panel_trsm: {counts}")
    torch.cuda.empty_cache()

    # ---- 4. path B: lookahead, fused trailing-update tier
    tune.initialize(**PATH_B)
    factor_run()  # warm-up
    fac, wall, counts = factor_run()
    res = factor_residual(fac)
    by_path["B_factor"] = counts
    mat_b = dtt.DistributedMatrix.from_global(dtt.Grid.create(), rhs.clone(), (nb, nb))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    x = dtt.cholesky_solver("L", fac, mat_b, backend="distributed")
    torch.cuda.synchronize()
    wall_solve = time.perf_counter() - t0
    solve_counts = launch_counts()
    by_path["B_solve"] = solve_counts
    serr = solve_err(layout.unpack(x.data, x.dist)[:n, :nb])
    del fac, mat_b, x
    emit({"phase": "path_B", "config": "lookahead, trailing_update_impl=fused, panel_trsm_pallas=1",
          "n": n, "nb": nb, "factor_wall_s": wall, "factor_gflops": gflop / wall,
          "factor_residual": res, "solve_wall_s": wall_solve, "solve_forward_err": serr,
          "tol": res_tol, "factor_launches": counts, "solve_launches": solve_counts, **stamp})
    if not (res <= res_tol and serr <= res_tol):
        fail(f"path B factor residual {res:.3e} / solve error {serr:.3e} > {res_tol:.3e}")
    if min(counts["potrf"], counts["panel_trsm"], counts["trailing_update"]) <= 0 \
            or counts["potrf_cluster"] != counts["potrf"] or solve_counts["trailing_update"] <= 0:
        fail(f"path B did not launch every kernel: factor {counts}, solve {solve_counts}")
    torch.cuda.empty_cache()

    # ---- 5. POSV through the public entry point (panel TRSM env still on)
    tune.initialize()
    mat_a = dtt.DistributedMatrix.from_global(dtt.Grid.create(), a_glob, (nb, nb))
    mat_b = dtt.DistributedMatrix.from_global(dtt.Grid.create(), rhs.clone(), (nb, nb))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    x, info = dtt.positive_definite_solver("L", mat_a, mat_b, return_info=True)
    info = int(info)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    by_path["posv"] = counts
    serr = solve_err(layout.unpack(x.data, x.dist)[:n, :nb])
    del mat_a, mat_b, x
    emit({"phase": "posv", "config": "defaults + panel_trsm_pallas=1, return_info=True",
          "n": n, "nrhs": nb, "wall_s": wall, "info": info, "solve_forward_err": serr,
          "tol": res_tol, "launches": counts, **stamp})
    if info != 0 or not serr <= res_tol:
        fail(f"POSV info {info}, solve error {serr:.3e}")
    if counts["potrf"] <= 0 or counts["potrf_cluster"] != counts["potrf"]:
        fail(f"POSV did not launch potrf on the cluster: {counts}")

    # ---- 5b. the three collectives tiers on the 2x4 grid, bitwise
    tier_equality(stamp, a_glob)
    torch.cuda.empty_cache()

    # ---- 5c. path M: 2x4 grid of rank threads, the 'pallas' tier
    kept = {}
    by_path.update(path_m(stamp, a_glob, rhs, factor_residual, solve_err, res_tol, kept))
    # path MU: M3's call from the upper triangle, then shift recovery
    by_path.update(path_mu(stamp, a_glob, rhs, solve_err, res_tol))
    torch.cuda.empty_cache()

    # ---- 5d. the fused tier on the 2x4 grid: M4, M5, path I, S4
    by_path.update(path_fused(stamp, a_glob, factor_residual, res_tol, kept))
    torch.cuda.empty_cache()

    # ---- 5e. the split-GEMM solvers: S1, S2, S5, S3
    by_path.update(path_split(stamp, a_glob, rhs, solve_err, res_tol, by_path))

    # ---- 5g. path O2: M1's Cholesky at source rank (1, 2) and at the origin
    by_path.update(path_o2(stamp, a_glob))
    torch.cuda.empty_cache()

    # ---- 5h. general_sub_multiplication on the 2x4 grid
    by_path.update(sub_gemm_phase(stamp))

    del a_glob, rhs, x_ref
    torch.cuda.empty_cache()

    # ---- 5f. reduction_to_band on the 2x4 grid: R1, R2
    by_path.update(path_red2band(stamp, dev))
    torch.cuda.empty_cache()

    # ---- 6. path H: the HEEV pipeline
    kept_h = {}
    by_path["H_heev"] = path_h(stamp, kept_h)
    torch.cuda.empty_cache()

    # ---- 6b. path H2: the HEEV pipeline on the 2x4 grid of rank threads
    by_path["H2_heev"] = path_h2(stamp, kept_h)
    torch.cuda.empty_cache()

    # ---- 6c. path G2: the generalized eigensolver on the 2x4 grid
    by_path.update(path_g2(stamp))
    torch.cuda.empty_cache()

    # ---- 6d. path E2: the mixed-precision eigensolver on the 2x4 grid; 6e.
    # path EW, its narrow-window route; 6f. path P2, partial spectra and
    # eigenvalues only
    by_path["E2_mixed"] = path_e2(stamp, kept_h)
    torch.cuda.empty_cache()
    by_path["EW_window"] = path_ew(stamp, kept_h)
    del kept_h
    torch.cuda.empty_cache()
    by_path.update(path_p2(stamp))

    # ---- 7. summary
    meta = {
        "potrf": ("dlaf_tpu_torch/csrc/potrf.cu", "dlaf_tpu/ops/pallas_potrf.py:48"),
        "panel_trsm": ("dlaf_tpu_torch/csrc/panel_trsm.cu", "dlaf_tpu/ops/pallas_panel_trsm.py:90"),
        "trailing_update": ("dlaf_tpu_torch/csrc/trailing_update.cu",
                            "dlaf_tpu/ops/pallas_trailing_update.py:163"),
        "secular_bisect": ("dlaf_tpu_torch/csrc/secular.cu", "dlaf_tpu/ops/pallas_secular.py:57"),
        "merge_hop": ("dlaf_tpu_torch/csrc/panel_exchange.cu",
                      "dlaf_tpu/ops/pallas_panel_exchange.py:200"),
        "ring_exchange": ("dlaf_tpu_torch/csrc/panel_exchange.cu",
                          "dlaf_tpu/ops/pallas_panel_exchange.py:380"),
        "fused_factor_bcast": ("dlaf_tpu_torch/csrc/panel_exchange.cu",
                               "dlaf_tpu/ops/pallas_panel_exchange.py:533"),
        "dma_ring_consume": ("dlaf_tpu_torch/csrc/consume.cu",
                             "dlaf_tpu/ops/pallas_trailing_update.py:407"),
        "fused_step": ("dlaf_tpu_torch/csrc/consume.cu",
                       "dlaf_tpu/ops/pallas_trailing_update.py:651"),
        "panel_contract": ("dlaf_tpu_torch/csrc/trailing_update.cu",
                           "dlaf_tpu/ops/pallas_trailing_update.py:226"),
        "trailing_update_split": ("dlaf_tpu_torch/csrc/trailing_update.cu",
                                  "dlaf_tpu/ops/pallas_trailing_update.py:163"),
        "panel_contract_split": ("dlaf_tpu_torch/csrc/trailing_update.cu",
                                 "dlaf_tpu/ops/pallas_trailing_update.py:226"),
        "dma_ring_consume_split": ("dlaf_tpu_torch/csrc/consume.cu",
                                   "dlaf_tpu/ops/pallas_trailing_update.py:407"),
        "fused_step_split": ("dlaf_tpu_torch/csrc/consume.cu",
                             "dlaf_tpu/ops/pallas_trailing_update.py:651"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = report[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(c.get(name, 0) for c in by_path.values()),
            "launches_by_path": {p: c.get(name, 0) for p, c in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        if name in ("trailing_update", "panel_contract"):
            # the FMA body of csrc/fma_gemm.cuh; the first body (the reference
            # kernel, same bits) timed in turns with it in this run
            entry["body"] = "dlaf_tpu_torch/csrc/fma_gemm.cuh"
            entry["reference_ms"] = r["reference_ms"]
            entry["max_abs_err"] = max(f["max_abs_err"] for f in r["forms"].values())
            entry["forms"] = {s: {k: f[k] for k in ("kernel_ms", "reference_ms", "plain_ms",
                                                    "library_ms", "bound_ms", "max_abs_err",
                                                    "bitwise_vs_reference")}
                              for s, f in r["forms"].items()}
        if name == "panel_trsm":
            # the Hopper body; the first body (the reference kernel, same bits)
            # timed in turns with it in this run, and both summed over path A
            entry["reference_ms"] = r["reference_ms"]
            entry["path_a_launch_weighted_sum_ms"] = r["path_a"]["launch_weighted_sum_ms"]
            entry["shapes"] = {c: {k: f.get(k) for k in (
                "kernel_ms", "reference_ms", "library_ms", "bound_ms", "max_abs_err",
                "bitwise_vs_reference")} for c, f in r["cases"].items()}
        if name == "merge_hop":
            # the select's device time alone (L2 cold, the entry's ms, and hot)
            # and the host's per call, beside torch.where's
            entry.update({k: r[k] for k in ("device_hot_ms", "device_cold_ms",
                                            "host_ms_per_call")})
            entry["timings"] = r["timings"]
            # B4's select runs inside every B5 pull and every hop of B6, B7 and B8; its own
            # entry point is launched by its kernel phase only, as the JAX
            # package launches merge_hop only on its ring without remote copies
            entry["body_runs_in_launches"] = sum(
                c.get(k, 0) for c in by_path.values()
                for k in ("ring_exchange", "fused_factor_bcast", "dma_ring_consume", "fused_step"))
        if name == "potrf":
            # the one-block kernel the cluster kernel replaced, timed in turns
            # with it in this run
            entry["one_block_ms"] = r["one_block_ms"]
            entry["launches_on_the_cluster"] = sum(c.get("potrf_cluster", 0)
                                                   for c in by_path.values())
        if name == "ring_exchange":
            # the hop ring the pull replaced, timed in turns with it in this run
            entry["hop_ring_ms"] = r["hop_ring_ms"]
            entry["max_abs_err"] = worst(f["max_abs_err"] for f in r["shapes"].values())
            entry["shapes"] = {s: {k: f[k] for k in ("kernel_ms", "hop_ring_ms", "plain_ms",
                                                     "library_ms", "bound_ms", "max_abs_err")}
                               for s, f in r["shapes"].items()}
        if name == "fused_factor_bcast":
            # the factor-and-send body; the unfused composition (B1, B2, the
            # mask, B5) timed in turns with it in this run, at every shape
            entry["body"] = "dlaf_tpu_torch/csrc/factor_send.cuh"
            entry["unfused_ms"] = r["unfused_ms"]
            entry["shapes"] = {lab: {k: q[k] for k in (
                "dtype", "kernel_ms", "unfused_ms", "bound_ms", "bitwise_vs_unfused")}
                for lab, q in [("M", r)] + [(c[0], r[f"at_{c[0]}"]) for c in FUSED_CASES]}
        if name == "dma_ring_consume":
            # the record of the path that launches B6 (step 0 of M5) gives the
            # entry's numbers; step 0 of M4 is B8's consume part.  The body is
            # csrc/consume_gemm.cuh; the ring alone is B6 with every slot suppressed
            entry["body"] = "dlaf_tpu_torch/csrc/consume_gemm.cuh"
            entry["ring_alone_ms"] = r["ring_alone_ms"]
            entry["bitwise_vs_b3"] = all(q["bitwise_vs_b3"] for q in (r, r["at_M4"],
                                                                     r["ring_of_4"]))
            entry["shapes"] = {f"{q['step0_of']}_step0": {k: q[k] for k in (
                "nb", "shape", "kernel_ms", "ring_alone_ms", "plain_ms", "library_ms", "bound_ms",
                "max_abs_err", "bitwise_vs_b3")} for q in (r, r["at_M4"])}
        if name == "fused_step":
            entry["body"] = "dlaf_tpu_torch/csrc/consume_gemm.cuh"
            entry["max_abs_err"] = r["max_abs_err"]
            entry["two_piece_ms"] = r["two_piece_ms"]
            entry["bitwise_vs_b3"] = r["bitwise_vs_b3"]
        if name in SPLIT_KERNELS + CONSUME_SPLIT_KERNELS:
            # the split-tier bodies of B3 and B9 (csrc/split_gemm.cuh: a
            # pre-pass and a body a call, cut_ms and body_ms each alone) and
            # of B6 and B8 (csrc/consume_split.cuh), their launches a share of
            # theirs; the yardstick is tile.contract at the tier
            split_gemm = name in SPLIT_KERNELS
            entry["body"] = ("dlaf_tpu_torch/csrc/split_gemm.cuh" if split_gemm
                             else "dlaf_tpu_torch/csrc/consume_split.cuh")
            entry["yardstick_ms"] = r["yardstick_ms"]
            entry["default_tier_kernel_ms"] = r["default_tier_kernel_ms"]
            keys = ("tier", "kernel_ms", "default_tier_kernel_ms", "plain_ms", "yardstick_ms",
                    "bound_ms", "bound_by", "max_abs_err", "rel_err_vs_plain",
                    "rel_err_vs_default", "probe_bitwise_vs_plain", "probe_rel_err_vs_default")
            keys += ("cut_ms", "body_ms", "cut_share") if split_gemm else ()
            entry["forms"] = {s: {k: f[k] for k in keys}
                              for s, f in r.get("forms", r.get("cases", {})).items()}
            if split_gemm:
                sub = "true" if name == "trailing_update_split" else "false"
                entry["ptxas"] = {
                    f"{k}<{t_}, {ns}, {f}>": _ptxas_of(f"{k}<{t_}, {ns}, {f}>")
                    for t_ in ("float", "double") for ns in (2, 3)
                    for k, f in (("split_gemm_kernel", sub), ("split_cut_kernel", "false"),
                                 ("split_cut_kernel", "true"))}
        if name == "secular_bisect":
            # the body that stops at the fixed point; its first body (the
            # reference kernel, same bits) timed in turns with it in this run
            entry["reference_ms"] = r["reference_ms"]
            entry["bound_42_rounds_ms"] = r["bound_42_rounds_ms"]
            entry["shapes"] = {f"{s} {lab}": {k: f[k] for k in (
                "kernel_ms", "reference_ms", "plain_ms", "bound_ms", "bound_42_rounds_ms",
                "max_abs_err", "max_err_rel_to_bracket", "bitwise_vs_reference")}
                for s, q in r["shapes"].items() for lab, f in q["tables"].items()}
            entry["ptxas"] = r["ptxas"]
            entry["blocks_per_sm"] = r["blocks_per_sm"]
        kernels.append(entry)
    emit({"kernels": kernels})
    print(card, flush=True)  # as nvidia-smi prints it: name, power limit
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
