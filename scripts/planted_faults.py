#!/usr/bin/env python3
"""Plant one fault at a time in a copy of the port's CUDA sources and show
that chip_smoke.py's kernel phase of that kernel fails on it.

    python3 scripts/planted_faults.py [NAME ...]   # all faults by default

Each fault is an edit of one file of dlaf_tpu_torch/csrc/, made in a copy
of dlaf_tpu_torch/ and chip_smoke.py under _faults/<name>/ (listed in
.gitignore; the repository's own files are never edited).  The copy builds
its kernels at first use as the repository does, then runs chip_smoke.py's
kernel phase of the one kernel the fault is in (consume_phases for B6, B8,
their FMA body and B9, consume_split_phase for B6's and B8's split bodies
(csrc/consume_split.cuh),
pull_phase for B5 and the rings' merge, fused_phase for B7 (whose body,
csrc/factor_send.cuh, B8's tail shares: its faults run consume_phases'
B8 as well), potrf_phase for B1,
panel_trsm_phase for B2, merge_phase for B4, trailing_update_phase and
fma_edge_phase for B3's and B9's FMA body, split_phase for B3's and B9's
split body (csrc/split_gemm.cuh), secular_phase for B10), on the main
path's shapes, in a
process of its own; or ("split_tests") the CUDA tests that hold B6's and
B8's split bodies bit for bit to B3-split at ragged and deep shapes
(tests/test_torch_consume.py, copied with the package).
The script prints one JSON line per fault: whether the phase failed, as
it must, and the errors the phase measured.  Needs a CUDA device; it
exits non-zero if a fault that must fail went unseen (faults marked latent are run and reported, with the
reason no output check can see them).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "_faults")

_NO_SLICE_WAIT = ("      dlaf_fma::cp_async_wait<kStages - 3>();  // this thread's copies of slice "
                  "t + 1 have landed\n", "")

def _late_pulls(ms: int) -> tuple:
    """The delay that opens the exit barrier's race: the ranks at odd ring
    positions start pulling the other shares ``ms`` late (factor_send.cuh),
    long enough for the punctual ranks' threads to have queued their
    overwrites (eight rank threads queue a few operations each after their
    launch through one interpreter: several ms; 3 ms opened B7's race in
    one run of two)."""
    return ("factor_send.cuh",
            "  // 3. every other position's chunks, round j of each share in turn\n",
            "  if (s.me % 2 && tid == 0)\n"
            f"    for (int i = 0; i < {ms * 1000}; ++i) __nanosleep(1000);\n"
            "  __syncthreads();\n"
            "  // 3. every other position's chunks, round j of each share in turn\n")

#: name -> (file under dlaf_tpu_torch/csrc/, [(text, its replacement)],
#: kernel whose chip_smoke.py phase runs, what must happen).  A fault
#: marked "latent" cannot change what the phase compares, or changes it
#: only in a race the phase does not open every run (the reason is given);
#: it is run and reported all the same, and does not count as unseen.
FAULTS = {
    # B6: the capacity ack of landing slot s % 2 goes out before the hop's
    # update has read the slot (the ack is sent again after it, harmlessly)
    "b6_ack_before_update": (
        "ring.cuh",
        [("    hooks.after_merge(s, j);\n",
          "    if (s + 2 < nhops && tid == 0)\n"
          "      publish(&r.aflag[((long long)r.me * 2 + j) * G + b], r.epoch | (u64)(s + 1));\n"
          "    hooks.after_merge(s, j);\n")],
        "dma_ring_consume",
        "latent: in a one-contributor ring a slot's bytes never change once a rank holds it, "
        "so the writer's hop s + 2 copy rewrites the bytes being read with the same bytes"),
    # B6 (and every ring): a hop is merged and consumed without waiting for
    # its recv flag
    "b6_no_recv_wait": (
        "ring.cuh",
        [("      ok = wait_flag(&r.rflag[((long long)r.me * 2 + j) * G + b], r.epoch | (u64)(s + 1), r,\n"
          "                     kErrRecv);\n",
          "      ok = true;\n")],
        "dma_ring_consume", "fails"),
    # B5 (the pull): a reader copies from its peers without waiting for
    # their entry flags; the phase's late source fills its fresh input with
    # NaN and writes it only after a 100 ms sleep on its stream
    "b5_read_before_entry": (
        "panel_exchange.cu",
        [("    ok = barrier_all(p.entry, 1, p, kErrEntry);\n",
          "    publish(&p.entry[(long long)p.me * G + b], p.epoch | 1);\n")],
        "ring_exchange", "fails"),
    # B5 (the pull): a rank's kernel exits without waiting for its readers'
    # done flags, so its stream overwrites its input (with late readers, the
    # phase's source has its NaN fill queued behind its launch) while
    # readers still read it; the readers are made slow (2 ms between their
    # entry barrier and their copy), which opens the race on every run
    "b5_exit_before_readers_done": (
        "panel_exchange.cu",
        [("  if (threadIdx.x == 0) barrier_all(p.done, 2, p, kErrDone);\n",
          "  if (threadIdx.x == 0) publish(&p.done[(long long)p.me * G + b], p.epoch | 2);\n"),
         ("    if (b == 0) p.oh[s] = any;\n  }\n  __syncthreads();\n",
          "    if (b == 0) p.oh[s] = any;\n  }\n  __syncthreads();\n"
          "  if (threadIdx.x == 0 && sh_src[0] != p.me) {\n"
          "    const u64 t0 = globaltimer();\n"
          "    while (globaltimer() - t0 < 2000000ull) __nanosleep(1000);\n"
          "  }\n"
          "  __syncthreads();\n")],
        "ring_exchange", "fails"),
    # B1 (the cluster): the other blocks copy the diagonal block's factor
    # from block 0 without the cluster.sync() that follows its factoring
    "b1_drop_cluster_sync": (
        "potrf.cuh",
        [("      tm.sync();\n      // 2. the factor and its reciprocals from block 0\n",
          "      // 2. the factor and its reciprocals from block 0\n")],
        "potrf", "fails"),
    # B7 (csrc/factor_send.cuh): the solve starts without the barrier that
    # ends the factor, and every block but 0 writes its rows of the factor
    # 2 ms late; f64 at nb = 512 (block 0 alone factors, for ms) needs no
    # delay to show it
    "b7_solve_before_factor": (
        "factor_send.cuh",
        [("  return team_barrier(flags, gridDim.x, b, epoch | kReady, bd, dlaf_ring::kErrFactor);\n",
          "  return true;\n"),
         ("potrf.cuh", "  move_rows<T, false>(out, rows, n, nr, me, cs);\n  return true;\n",
          "  if (!kDsmem && me != 0)\n"
          "    for (int i = 0; i < 2000; ++i) __nanosleep(1000);\n"
          "  move_rows<T, false>(out, rows, n, nr, me, cs);\n  return true;\n")],
        "fused_factor_bcast", "fails"),
    # B7: a chunk is copied from the rank that solves it without waiting for
    # its flag; the solvers start each chunk 2 ms late
    "b7_pull_before_chunk_flag": (
        "factor_send.cuh",
        [("      if (!block_wait(s.chunk + k, epoch | 1, bd, dlaf_ring::kErrChunk)) return false;\n",
          ""),
         ("    const int i = sidx[k / runs], r0 = k % runs * C;\n    dlaf_panel_trsm::solve_rows",
          "    if (tid == 0) {\n"
          "      const unsigned long long t0 = dlaf_ring::globaltimer();\n"
          "      while (dlaf_ring::globaltimer() - t0 < 2000000ull) __nanosleep(1000);\n"
          "    }\n"
          "    __syncthreads();\n"
          "    const int i = sidx[k / runs], r0 = k % runs * C;\n    dlaf_panel_trsm::solve_rows")],
        "fused_factor_bcast", "fails"),
    # B7: a rank's kernel ends without B5's exit barrier, so its stream
    # overwrites its panel and its output (the phase's lifetime run) while
    # other ranks still read them; ranks at odd positions start pulling
    # the others' chunks late, which opens the race
    "b7_no_exit_barrier": (
        "panel_exchange.cu",
        [("  dlaf_fsend::team_barrier(a.done, a.s.P * G, a.s.me * G + b, a.epoch | 2, a.bd, kErrDone);\n",
          "  publish(a.done + a.s.me * G + b, a.epoch | 2);\n"),
         _late_pulls(30)],
        "fused_factor_bcast", "fails"),
    # B7 (and B1's cluster, the same body): the team gathers the panel's
    # rows without the sync that follows their publication
    "b7_drop_team_sync": (
        "potrf.cuh",
        [("    if (!tm.sync()) return false;\n    if (w < kPw || c0 + kPw >= n) break;",
          "    if (w < kPw || c0 + kPw >= n) break;")],
        "fused_factor_bcast", "fails"),
    # the same four in B8's tail (csrc/consume.cu, step_tail), at M4's step 0
    "b8_solve_before_factor": ("factor_send.cuh", None, "fused_step", "fails"),
    "b8_pull_before_chunk_flag": ("factor_send.cuh", None, "fused_step", "fails"),
    "b8_no_exit_barrier": (
        "consume.cu",
        [("  dlaf_fsend::team_barrier(a.done, a.ranks * G, (a.me_r * a.pc + a.me_c) * G + b, a.epoch | 2,\n"
          "                           a.bd, kErrDone);\n",
          "  publish(a.done + (a.me_r * a.pc + a.me_c) * G + b, a.epoch | 2);\n"),
         _late_pulls(30)],
        "fused_step", "fails"),
    "b8_drop_team_sync": ("potrf.cuh", None, "fused_step", "fails"),
    # B6's split body (csrc/consume_split.cuh, bf16x3) adds its terms
    # without the (0, 1) product
    "b6_split_drop_term01": (
        "consume_split.cuh",
        [("                [&](int q) { return acc[q][m0 + mi][ni][2 * hf + e]; });\n",
          "                [&](int q) { return NS == 2 && q == 0 ? 0.f : acc[q][m0 + mi][ni][2 * hf + e]; });\n")],
        "dma_ring_consume_split", "fails"),
    # the split body drops the last k16 chunk of one term (the first, (0, 1)
    # at bf16x3): the last chunk of a tile's last slice
    "b6_split_drop_last_k16_of_a_term": (
        "consume_split.cuh",
        [("                                              int ncols, int kt) {\n",
          "                                              int ncols, int kt, int nk_ = 0) {\n"),
         ("              dlaf_split::mma(acc[q][mi][ni], af, bf[dlaf_split::term_b(NS, q)][ni]);\n",
          "              if (q != 0 || kc == 0 || kt + 1 < nk_)\n"
          "                dlaf_split::mma(acc[q][mi][ni], af, bf[dlaf_split::term_b(NS, q)][ni]);\n"),
         ("      if (active()) compute_slice<T, NS>(acc, st0 + (t % kStages) * G::STAGE, sb, rp, ncols, kt);\n",
          "      if (active()) compute_slice<T, NS>(acc, st0 + (t % kStages) * G::STAGE, sb, rp, ncols, kt, ns);\n")],
        "dma_ring_consume_split", "fails"),
    # the split body cuts each part's first cp stage right after issuing its
    # copies, before any cp.async wait or barrier: the stage is read before
    # its copies (other threads') can have landed
    "b6_split_read_before_wait": (
        "consume_split.cuh",
        [("  for (int t = 0; t < kStages - 1; ++t) issue(t);\n",
          "  for (int t = 0; t < kStages - 1; ++t) issue(t);\n  cut_stage(0);\n"),
         ("  __syncthreads();  // and the segment's slices are visible to every part\n"
          "  cut_stage(0);\n",
          "  __syncthreads();  // and the segment's slices are visible to every part\n")],
        "dma_ring_consume_split", "fails"),
    # the split body's prologue waits for neither the segment's nor the first
    # stage's copies
    "b6_split_no_prologue_wait": (
        "consume_split.cuh",
        [("  dlaf_fma::cp_async_wait<kStages - 1>();  // the segment has landed\n",
          "  dlaf_fma::cp_async_wait<kStages>();\n"),
         ("  dlaf_fma::cp_async_wait<kStages - 2>();  // slice 0 has landed\n",
          "  dlaf_fma::cp_async_wait<kStages>();\n")],
        "dma_ring_consume_split",
        "latent: a race. The copies come from L2 and the block meets a barrier after issuing "
        "them and before the first cut; the phase passed with it in one of the two runs made "
        "(the first under the name b6_split_read_before_wait, which now names a fault the "
        "phase sees every run)"),
    # the split body's slice loop drops its cp.async wait: a part's barrier
    # no longer orders the cut of slice t + 1 after its copies (issued two
    # slices earlier) have landed.  At B8's shape of M4, where each part's
    # pipeline turns over thousands of times, and in the CUDA tests of the
    # split bodies, whose deep updates run passes of 2 to 8 columns: one
    # warp of a part computes, so a slice's turn is short
    "b8_split_no_slice_wait": (
        "consume_split.cuh", [_NO_SLICE_WAIT], "fused_step_split",
        "latent: a race. A slice's copies are issued two slices before its cut, and at M4's "
        "shape the part's barrier and products of those slices outlast them: the phase "
        "passed with it in the one run made"),
    "b6_split_no_slice_wait_deep": (
        "consume_split.cuh", [_NO_SLICE_WAIT], "split_tests", "fails"),
    # the split body's cut truncates to bf16 instead of rounding to nearest
    # (the split probe, one product per output, must see it)
    "b6_split_cut_truncates": (
        "split_gemm.cuh",
        [("  return __float22bfloat162_rn(make_float2(a, b));\n",
          "  return __halves2bfloat162(__float2bfloat16_rz(a), __float2bfloat16_rz(b));\n")],
        "dma_ring_consume_split", "fails"),
    # B8's split body leaves column k+1 out of the consume ring and applies
    # it after the ring with the 'default'-tier body (each block its own
    # segments of the merged panel's slot k+1)
    "b8_split_narrow_at_default": (
        "consume.cu",
        [("    sh_apply[i] = a.z[i] == 0 || (col1 && i == a.l_next);\n",
          "    sh_apply[i] = a.z[i] == 0;\n"),
         ("  if (!ring_hops(a.rc, sh_have, sh_hin, sh_ok, hooks)) return;\n",
          "  if (!ring_hops(a.rc, sh_have, sh_hin, sh_ok, hooks)) return;\n"
          "  if (col1) {\n"
          "    const long long w = a.rc.w, lo0 = (long long)a.l_next * w;\n"
          "    for (long long lo = (long long)b * a.rc.seg; lo < a.rc.total; lo += (long long)G * a.rc.seg)\n"
          "      if (lo >= lo0 && lo < lo0 + w)\n"
          "        apply_rows<T, 0>(a.p, reinterpret_cast<const T*>(a.rc.acc + lo), a.l_next,\n"
          "                         (int)((lo - lo0) / (long long)(sizeof(T) / sizeof(u32)) / a.p.K), work);\n"
          "  }\n")],
        "fused_step_split", "fails"),
    # the split body copies the segment (a landing slot's rows) with
    # cp.async.ca, through L1, instead of .cg
    "b6_split_landing_slot_through_l1": (
        "consume_split.cuh",
        [("    cp_async16(sb + r * rp + gi * G::GB + h * 16, ok ? seg + (long long)r * K + k : seg,\n"
          "               ok ? 16 : 0);\n",
          "    asm volatile(\"cp.async.ca.shared.global [%0], [%1], 16, %2;\\n\" ::\"r\"(\n"
          "                     sb + r * rp + gi * G::GB + h * 16),\n"
          "                 \"l\"(ok ? seg + (long long)r * K + k : seg), \"r\"(ok ? 16 : 0) : \"memory\");\n")],
        "dma_ring_consume_split",
        "latent: a block reads a landing slot's rows only for the slots fresh at that hop, and a "
        "slot is fresh at one hop only, so when landing slot s % 2 is rewritten for hop s + 2 "
        "the block reads other rows of it (other segments, whole 128-byte lines of one slot); "
        "a segment is read once a pass, and L1 holds nothing across launches"),
    # B3's and B9's split body (csrc/split_gemm.cuh) adds its terms without
    # the (0, 1) product (bf16x3)
    "split_gemm_drop_term01": (
        "split_gemm.cuh",
        [("              v.v[e] = term_sum<T, G::NS>([&](int q) { return acc[q][mi][ni][2 * h + e]; });\n",
          "              v.v[e] = term_sum<T, G::NS>(\n"
          "                  [&](int q) { return G::NS == 2 && q == 0 ? 0.f : acc[q][mi][ni][2 * h + e]; });\n")],
        "trailing_update_split", "fails"),
    # B9-split's slot chain of the lower form stops before its last slot
    "split_gemm_b9_drop_last_slot": (
        "trailing_update.cu",
        [("dlaf_split::Job{L, 1, C, 0, M, N, cm, 0, 0, 0, M, N, 0}",
          "dlaf_split::Job{L, 1, C - 1, 0, M, N, cm, 0, 0, 0, M, N, 0}")],
        "panel_contract_split", "fails"),
    # the split body drops the second k16 chunk of the (0, 1) term (bf16x3)
    # in each tile's last slice
    "split_gemm_drop_last_k16_of_a_term": (
        "split_gemm.cuh",
        [("__device__ __forceinline__ void compute_stage(Acc<G>& acc, uint32_t st) {\n",
          "__device__ __forceinline__ void compute_stage(Acc<G>& acc, uint32_t st, bool last_) {\n"),
         ("            for (int ni = 0; ni < G::NI; ++ni) mma(acc[q][mi][ni], af, bf[term_b(NS, q)][ni]);\n",
          "            for (int ni = 0; ni < G::NI; ++ni)\n"
          "              if (q != 0 || kc == 0 || !last_) mma(acc[q][mi][ni], af, bf[term_b(NS, q)][ni]);\n"),
         ("    compute_stage<G>(acc, sm + cring * G::STAGE);\n",
          "    compute_stage<G>(acc, sm + cring * G::STAGE, cs + 1 == per);\n")],
        "trailing_update_split", "fails"),
    # the split body reads a stage before its cp.async group has landed: the
    # wait lets one group more stay pending (at a block's first slice none
    # is waited for).  The phase sees it; the deep and nine-slot CUDA tests,
    # whose few tiles' copies land during the first barrier, did not
    "split_gemm_read_before_wait": (
        "split_gemm.cuh",
        [("    dlaf_fma::cp_async_wait<G::kStages - 2>();  // this thread's copies of slice t have landed\n",
          "    dlaf_fma::cp_async_wait<G::kStages - 1>();  // this thread's copies of slice t have landed\n")],
        "trailing_update_split", "fails"),
    # B3's and B9's pre-pass cuts by truncating to bf16 instead of rounding
    # to nearest (B6's and B8's cut, the same cut8, rounds): the split probe,
    # one product per output, must see it
    "split_gemm_prepass_truncates": (
        "split_gemm.cuh",
        [("template <typename T, int NS, typename Put>\n__device__ __forceinline__ void cut8(",
          "template <typename T, int NS, bool kRZ = false, typename Put>\n"
          "__device__ __forceinline__ void cut8("),
         ("          round2(static_cast<float>(v[2 * p]), static_cast<float>(v[2 * p + 1]));\n",
          "          kRZ ? __halves2bfloat162(__float2bfloat16_rz(static_cast<float>(v[2 * p])),\n"
          "                                   __float2bfloat16_rz(static_cast<float>(v[2 * p + 1])))\n"
          "              : round2(static_cast<float>(v[2 * p]), static_cast<float>(v[2 * p + 1]));\n"),
         ("  cut8<T, NS>(v, [&](int s, const uint32_t(&w)[4]) {\n    *reinterpret_cast<uint4*>",
          "  cut8<T, NS, true>(v, [&](int s, const uint32_t(&w)[4]) {\n    *reinterpret_cast<uint4*>")],
        "trailing_update_split", "fails"),
    # B9 (the FMA body): the lower form's sum over j drops the last slot
    "b9_drop_one_j": (
        "trailing_update.cu",
        [("dlaf_fma::gemm<T, false, kVec>(acc, a + o * C * mk, mk, K, b, kn, N, C, M, N, K,",
          "dlaf_fma::gemm<T, false, kVec>(acc, a + o * C * mk, mk, K, b, kn, N, C - 1, M, N, K,")],
        "panel_contract", "fails"),
    # B6's and B8's FMA body (csrc/consume_gemm.cuh) drops the last k slice
    # of every tile: ceil(K / 16) - 1 slices.  B3's bitwise check (and the
    # twin's tolerance) must see it
    "b6_body_drop_last_k_slice": (
        "consume_gemm.cuh",
        [("  const int nk = (K + kBK - 1) / kBK;  // the last slice's tail past K is zero-filled\n",
          "  const int nk = (K - 1) / kBK;\n")],
        "dma_ring_consume", "fails"),
    # the consumers' FMA body reads a stage before its cp.async group has
    # landed: the wait lets one group more stay pending (at a segment's
    # first slice none is waited for)
    "b6_body_read_before_wait": (
        "consume_gemm.cuh",
        [("      dlaf_fma::cp_async_wait<kStages - 2>();  // this thread's copies of slice t have landed\n",
          "      dlaf_fma::cp_async_wait<kStages - 1>();  // this thread's copies of slice t have landed\n")],
        "dma_ring_consume", "fails"),
    # the consumers' FMA body copies the segment (a landing slot's rows)
    # with cp.async.ca, through L1, instead of .cg
    "b6_body_landing_slot_through_l1": (
        "consume_gemm.cuh",
        [("    dlaf_fma::cp_async16(bs + r * G::LDK + kc, ok ? b + r * K + gk : b, ok ? 16 : 0);\n",
          "    asm volatile(\"cp.async.ca.shared.global [%0], [%1], 16, %2;\\n\" ::\"r\"(\n"
          "                     dlaf_fma::smem_addr(bs + r * G::LDK + kc)),\n"
          "                 \"l\"(ok ? b + r * K + gk : b), \"r\"(ok ? 16 : 0) : \"memory\");\n")],
        "dma_ring_consume",
        "latent: a block reads a landing slot's rows only for the slots fresh at that hop, and a "
        "slot is fresh at one hop only, so when landing slot s % 2 is rewritten for hop s + 2 "
        "the block reads other rows of it (other segments, whole 128-byte lines of one slot); "
        "its rereads of a segment within the hop see the same bytes, and L1 holds nothing "
        "across launches"),
    # the rings' merge (csrc/ring.cuh) decides a whole segment by the take of
    # its first word's slot: wrong where a segment crosses slots, as B5's hop
    # ring's segments do on the pull phase's small and ragged slots
    "ring_merge_first_slot": (
        "ring.cuh",
        [("      const long long b = min(hi, (slot + 1) * r.w);\n", "      const long long b = hi;\n")],
        "ring_exchange", "fails"),
    # B3's and B9's FMA body reads a stage before its cp.async group has
    # landed: the wait lets one group more stay pending (at slice 0 none is
    # waited for)
    "fma_read_before_wait": (
        "fma_gemm.cuh",
        [("    cp_async_wait<kStages - 2>();  // this thread's copies of slice t have landed\n",
          "    cp_async_wait<kStages - 1>();  // this thread's copies of slice t have landed\n")],
        "fma_body", "fails"),
    # the FMA body drops the ragged k tail: floor(K / 16) slices a slot
    "fma_drop_k_tail": (
        "fma_gemm.cuh",
        [("  const int nk = (K + kBK - 1) / kBK;", "  const int nk = K / kBK;")],
        "fma_body", "fails"),
    # the FMA body's mask on the N edge of a K x N operand is off by one
    # 16-byte chunk: the last chunk of every row of b reads as zero
    "fma_n_edge_mask": (
        "fma_gemm.cuh",
        [("        const bool ok = gk < K && gn < N;  // N is a multiple of V",
          "        const bool ok = gk < K && gn + V < N;  // N is a multiple of V")],
        "fma_body", "fails"),
    # B2 (the Hopper body): the substitution reads x[s] from its own lane,
    # before the shuffle that hands lane s's value to the warp
    "b2_x_before_shuffle": (
        "panel_trsm.cuh",
        [("        const T xs = __shfl_sync(0xffffffffu, v[q], s);\n",
          "        const T xs = v[q];\n")],
        "panel_trsm", "fails"),
    # B2 (the Hopper body): a slab is read before its cp.async group has
    # landed (the wait lets the one pending group, this slab's, stay pending)
    "b2_read_before_wait": (
        "panel_trsm.cuh",
        [("    dlaf_fma::cp_async_wait<0>();  // this thread's copies of slab g have landed\n",
          "    dlaf_fma::cp_async_wait<1>();  // this thread's copies of slab g have landed\n")],
        "panel_trsm",
        "latent: a race. A slab's copies are issued right after the barrier before the "
        "previous slab is used and first read after the next barrier, so they have the "
        "previous slab's substitution (and update) to land; at nb = 512 in f32 that outlasts "
        "a copy even in the last column block, with L out of L2 too, and at (1000, 160) f64 "
        "the phase failed in some runs and not in others"),
    # B2 (the Hopper body): no warp solves its rows again by the division
    # where a kept f32 quotient was under FLT_MIN, where the reciprocal's
    # product can miss a tie between subnormals (the case of L's diagonal 98)
    "b2_subnormal_unguarded": (
        "panel_trsm.cuh",
        [("    tiny = 2u * (unsigned)__double2hiint(p) - 0x00200000u < 0x70000000u;",
          "    tiny = false;")],
        "panel_trsm", "fails"),
    # B4 (the select): a slot whose take holds is read from y, not y_in
    "b4_y_where_take": (
        "panel_exchange.cu",
        [("  const u32* src = (hop_take(have, have_in) ? y_in : y) + base;\n",
          "  const u32* src = y + base;\n")],
        "merge_hop", "fails"),
    # B4 (the select): the tail words of a slot (a ragged w) are not written
    "b4_drop_ragged_tail": (
        "panel_exchange.cu",
        [("    if (t >= 0 && t < tail) dst[head + 4 * nvec + t]",
          "    if (t >= 0 && t < 0) dst[head + 4 * nvec + t]")],
        "merge_hop", "fails"),
    # B10: a row stops when mid equals an end of its bracket, before the
    # round's update, which could still set hi = lo: one round early
    "b10_stop_at_mid_end": (
        "secular.cu",
        [("    const bool neg = fm < 0.0f;\n",
          "    if (mid == lo || mid == hi) break;\n    const bool neg = fm < 0.0f;\n")],
        "secular_bisect",
        "latent: the answer 0.5 (lo + hi) is the expression mid is, so a row stopped where mid "
        "equals an end answers that mid, and so does the bracket the skipped round leaves "
        "(unchanged, or hi = lo = mid); only a bracket whose lo + hi overflows tells them apart"),
    # B10: each thread decides the exit from its own partial sum, not the
    # broadcast total, so the threads of a block may leave in different
    # rounds (the rest wait at a barrier the others never reach, or read
    # their stale sums)
    "b10_exit_on_own_partial": (
        "secular.cu",
        [("    const unsigned moved = __float_as_uint(neg ? lo : hi);\n",
          "    const unsigned moved =\n"
          "        __float_as_uint(__fadd_rn(1.0f, __fmul_rn(rh, acc)) < 0.0f ? lo : hi);\n")],
        "secular_bisect",
        "latent: a thread leaves early only where mid equals an end of the shared bracket, "
        "and thread 0's answer there is the one the full rule gives (as b10_stop_at_mid_end); "
        "the threads that stay meet barriers that count exited threads as arrived"),
    # B10: one buffer of warp sums under the one barrier a round: a warp
    # that runs ahead overwrites its sum before a slow warp has read it
    "b10_single_buffer": (
        "secular.cu",
        [("block_sum(acc, red[it & 1])", "block_sum(acc, red[0])")],
        "secular_bisect",
        "latent: the race needs a warp to reach its next round's store before another warp "
        "has read the eight sums after the barrier, a whole round of divisions behind"),
    # B10: the eight warp sums added in another order (neighbours first, as
    # a butterfly from offset 1 up would)
    "b10_warp_sums_reordered": (
        "secular.cu",
        [("  return __fadd_rn(__fadd_rn(__fadd_rn(a0, a4), __fadd_rn(a2, a6)),\n"
          "                   __fadd_rn(__fadd_rn(a1, a5), __fadd_rn(a3, a7)));\n",
          "  return __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3)),\n"
          "                   __fadd_rn(__fadd_rn(a4, a5), __fadd_rn(a6, a7)));\n")],
        "secular_bisect", "fails"),
}

for _b8, _b7 in (("b8_solve_before_factor", "b7_solve_before_factor"),
                 ("b8_pull_before_chunk_flag", "b7_pull_before_chunk_flag"),
                 ("b8_drop_team_sync", "b7_drop_team_sync")):
    FAULTS[_b8] = (FAULTS[_b7][0], FAULTS[_b7][1]) + FAULTS[_b8][2:]

_RUN = """
import sys, json
sys.path.insert(0, {copy!r})
import dlaf_tpu_torch  # before torch touches the card
import torch
import chip_smoke as cs

bound, timed_ms = cs.bound, cs.timed_ms
dev = torch.device("cuda")
stamp = {{"card": cs.card_line()}}
kernel = {kernel!r}
if kernel == "ring_exchange":
    from dlaf_tpu_torch.comm.grid import Grid
    kgen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    cs.pull_phase(stamp, bound, kgen, Grid.create(cs.GRID_M, device=dev),
                  Grid.create(cs.GRID_M, device="cpu"), timed_ms)
elif kernel == "fma_body":
    kgen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    cs.trailing_update_phase(stamp, bound, timed_ms, kgen)
    cs.fma_edge_phase(stamp, timed_ms, kgen)
elif kernel == "panel_trsm":
    kgen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    _, ell = cs.potrf_phase(stamp, bound, timed_ms, kgen)
    cs.panel_trsm_phase(stamp, bound, timed_ms, kgen, ell)
elif kernel == "merge_hop":
    cs.merge_phase(stamp, bound, torch.Generator(device=dev).manual_seed(cs.SEED + 1))
elif kernel == "fused_factor_bcast":
    from dlaf_tpu_torch.comm.grid import Grid
    kgen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    cs.fused_phase(stamp, bound, kgen, Grid.create(cs.GRID_M, device=dev),
                   Grid.create(cs.GRID_M, device="cpu"))
elif kernel == "potrf":
    cs.potrf_phase(stamp, bound, timed_ms, torch.Generator(device=dev).manual_seed(cs.SEED + 1))
elif kernel == "secular_bisect":
    cs.secular_phase(stamp, bound, timed_ms, torch.Generator(device=dev).manual_seed(cs.SEED + 1))
elif kernel in cs.SPLIT_KERNELS:
    cs.split_phase(stamp, timed_ms, torch.Generator(device=dev).manual_seed(cs.SEED + 1),
                   only=(kernel,))
elif kernel in cs.CONSUME_SPLIT_KERNELS:
    a_glob, _ = cs.make_inputs(dev)
    cs.consume_split_phase(stamp, timed_ms, a_glob, only=(kernel,))
else:
    a_glob, _ = cs.make_inputs(dev)
    cs.consume_phases(stamp, bound, timed_ms, a_glob, only=(kernel,))
print("PHASE PASSED")
"""


def plant(name: str) -> dict:
    fname, edits, kernel, expect = FAULTS[name]
    copy = os.path.join(WORK, name)
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "dlaf_tpu_torch"), os.path.join(copy, "dlaf_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copy)
    if kernel == "split_tests":
        os.makedirs(os.path.join(copy, "tests"))
        shutil.copy(os.path.join(ROOT, "tests", "test_torch_consume.py"),
                    os.path.join(copy, "tests"))
        shutil.copy(os.path.join(ROOT, "pyproject.toml"), copy)
    for edit in edits:  # (old, new) in fname, or (file, old, new)
        f, old, new = edit if len(edit) == 3 else (fname, *edit)
        src = os.path.join(copy, "dlaf_tpu_torch", "csrc", f)
        text = open(src).read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: a text to replace occurs {text.count(old)} times in {f}")
        open(src, "w").write(text.replace(old, new))
    cmd = ([sys.executable, "-m", "pytest", "tests/test_torch_consume.py", "--noconftest", "-m",
            "cuda", "-q", "-p", "no:cacheprovider", "-k", "split_is_b3_split"]
           if kernel == "split_tests" else
           [sys.executable, "-c", _RUN.format(copy=copy, kernel=kernel)])
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=copy)
    except subprocess.TimeoutExpired as e:  # a kernel that never ends (B10's barrier faults)
        proc = subprocess.CompletedProcess(cmd, None, e.stdout or "", e.stderr or "")
        proc.stdout = proc.stdout if isinstance(proc.stdout, str) else proc.stdout.decode()
        proc.stdout += "\nFAILED: the phase did not end within 900 s\n"
        proc.stderr = proc.stderr if isinstance(proc.stderr, str) else proc.stderr.decode()
    lines = proc.stdout.splitlines()
    measured = [json.loads(ln) for ln in lines if ln.startswith("{")]
    failed = [ln for ln in lines if "FAILED" in ln]
    return {"fault": name, "file": f"dlaf_tpu_torch/csrc/{fname}", "kernel_phase": kernel,
            "expect": expect, "phase_failed": proc.returncode is None or (proc.returncode != 0
                                                                          and bool(failed)),
            "rc": proc.returncode, "failure": failed[0] if failed else None,
            "measured": [{k: v for k, v in m.items() if k in (
                "kernel", "subscripts", "rel_err", "max_abs_err", "bitwise_vs_plain_yf_h",
                "rel_err_vs_plain", "probe_bitwise_vs_plain", "probe_rel_err_vs_default",
                "bitwise_vs_plain_panel_have",
                "skewed_run_bitwise", "rp_bitwise_vs_plain", "rel_err_vs_two_piece",
                "ring_of_4", "tol", "case", "bitwise_vs_plain", "bitwise_hop_ring_vs_plain",
                "skewed_run", "input_lifetime_bitwise_vs_plain", "input_lifetime_wrong_elements",
                "elements", "bitwise_vs_one_block", "bitwise_vs_reference", "elements_differing",
                "dropped_slice_rejected", "checks", "table", "shape",
                "max_err_rel_to_bracket", "flipped_bit_rejected")} for m in measured],
            "pytest": lines[-1] if kernel == "split_tests" and lines else None,
            "stderr_tail": proc.stderr[-600:] if proc.returncode and not failed else ""}


def main() -> int:
    names = sys.argv[1:] or list(FAULTS)
    unseen, latent_passed = [], []
    for name in names:
        res = plant(name)
        print(json.dumps(res), flush=True)
        if not res["phase_failed"]:
            (unseen if res["expect"] == "fails" else latent_passed).append(name)
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"faults": len(names), "unseen": unseen,
                      "latent_and_not_seen": latent_passed}), flush=True)
    return 1 if unseen else 0


if __name__ == "__main__":
    sys.exit(main())
