// The split-tier update body of the ring consumers B6 and B8
// (csrc/consume.cu), written for Hopper within the ring's limits: the
// counterpart of tile.contract's bf16 split (dlaf_tpu/ops/tile.py:197) as
// the TPU's _dma_ring_consume_kernel and _fused_step_kernel trace it in
// their update (dlaf_tpu/ops/pallas_trailing_update.py: _apply_update
// :265), under 'bf16x3' (NS = 2 bf16 slices per operand, 3 products) and
// 'bf16x6' (NS = 3, 6 products).
//
// It applies one ring segment: x[i, j][m, c0 + n] -= sum over the terms of
// sum over k of cp[i][m, k]_a * seg[n, k]_b for every i and m and the
// segment's n < ncols, with the bits of B3-split (csrc/split_gemm.cuh):
// every operand element cut by split_gemm.cuh's cut8 (the residual at
// the operand's type, a double rounded through float), one float32
// accumulator per term started at +0, mma.sync m16n8k16 (bf16 in, float32
// out) over k16 chunks in ascending order up to K rounded up to 32
// (split_gemm.cuh's slice), zero-filled past K, the terms added at T in
// split_terms order, then x - sum.  Each output of a consume update takes
// exactly one slot, so x after B6 is bit for bit B3-split applied once to
// the merged panel with the slots not applied set to zero (chip_smoke.py's
// check at the tier).
//
// The design:
// - each operand is cut once a segment: the segment (ncols rows of one
//   slot x K) lands by cp.async in a buffer kept for the whole segment and
//   is cut there in place by the whole block; every group of 8 k values
//   takes the 16 bytes a slice of one ldmatrix row needs, NS times (GB
//   bytes a group hold its landed values first);
// - the column panel cp [ltr][M][K] is one matrix of ltr * M rows, in
//   tiles of BM rows by the segment's 64 columns, streamed by 16-byte
//   cp.async.cg copies through rings of kStages stages of 32-deep k slices,
//   each landed slice cut in place one slice ahead of its products;
// - the block works as kParts = 4 parts of 4 warps, part p on the tiles p,
//   p + 4, ... with a ring of stages and a named barrier of its own: one
//   pipeline over its (tile, k slice) pairs, the next copies in flight
//   across a tile's end, one barrier a slice ordering the copies, the cut
//   and the products.  While one part waits, copies or cuts, the others'
//   products keep the tensor cores busy (one pipeline of the whole block
//   ran B8-split at M4's step 0 in 17.5 ms, two parts 15.8, four 15.2:
//   scripts/consume_variants.py);
// - a warp's tile is 32 x 16 (NS = 2; BM = 32) or 16 x 16 (NS = 3; BM =
//   16), 48 float32 accumulators a thread either way, within the 128
//   registers a thread of the ring's 512-thread blocks may use; fragments
//   by ldmatrix from rows padded to an odd number of 16-byte units (the 8
//   rows of a matrix hit 8 bank groups);
// - the epilogue reads and writes x in pairs of adjacent columns, every
//   pair loaded before any is stored, its lines prefetched to L2 at the
//   tile's first slice;
// - both operands through L2 only (cp.async.cg): the segment comes from a
//   landing slot that other ranks rewrite during the launch, and an L1
//   line of an earlier hop must never serve it.
// Where the segment's slices do not fit beside the stages (f64 at K = 512,
// or a large K), the segment runs in passes of fewer columns (pass_cols, 64
// down to 2): the warps past a pass's columns then skip their products, and
// in a pass of fewer than 16 columns the fragments of the columns past it
// repeat its last row (their products are never stored).  Each output's
// chain stays the same.  The caller has checked that x, cp, the segment and
// K * sizeof(T) lie on 16 bytes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fma_gemm.cuh"
#include "split_gemm.cuh"

namespace dlaf_consume_split {

using dlaf_split::cp_async16;
using dlaf_split::cut_group;
using dlaf_split::ldsm_x4;

constexpr int kThreads = 512;  // a ring kernel's block, 16 warps
constexpr int kParts = 4;      // parts of the block with a pipeline each
constexpr int kPart = kThreads / kParts;  // the threads of one part
constexpr int kWD = 16 / kParts / 4;      // a part's warps down a tile (4 across)
constexpr int kStages = 4;
constexpr int kBK = 32;         // K is rounded up to it: split_gemm.cuh's slice
constexpr int kBN = 64;         // a pass's columns at most (a segment's rows)
constexpr int kGK = 8;          // k values of a group: one 16-byte ldmatrix row a slice
constexpr int kGroups = kBK / kGK;

template <typename T, int NS>
struct Geom {
  static constexpr int MI = NS == 2 ? 2 : 1;  // m16 blocks a warp
  static constexpr int BM = kWD * 16 * MI;    // cp rows a part's tile
  // a group's bytes: its 8 landed values, then (in place) their NS slices
  static constexpr int GB = 8 * (int)sizeof(T) > 16 * NS ? 8 * (int)sizeof(T) : 16 * NS;
  static constexpr int CPG = 8 * (int)sizeof(T) / 16;  // 16-byte copies a group
  static constexpr int V = 16 / (int)sizeof(T);        // elements in 16 bytes
  // a stage's depth: 32 (two k16 chunks); 16 in f64 at bf16x3, whose
  // 32-deep stages would leave room at K = 512 for passes of 16 columns
  // only (16-deep stages give 32; in f32 at bf16x6 they would give 64, but
  // twice the barriers for the same products cost more than that saves)
  static constexpr int SK = sizeof(T) == 8 && NS == 2 ? 16 : 32;
  static constexpr int SG = SK / kGK;                  // groups of a stage row
  static constexpr int CPR = SG * CPG;                 // 16-byte copies of a stage row
  static constexpr int SP = SG * GB + 16;              // a stage row: an odd number of 16 bytes
  static constexpr int STAGE = BM * SP;
  static constexpr int STAGES = kParts * kStages * STAGE;  // each part's ring of stages
  static_assert(kPart % CPR == 0, "whole rows of copies a round");
  static_assert(BM * SG <= kPart, "one group a thread to cut");
};

// bytes of one segment row of slices (K rounded up to 32), an odd number
// of 16 bytes
template <typename T, int NS>
__host__ __device__ constexpr size_t seg_pitch(int K) {
  return (size_t)((K + kBK - 1) / kBK) * kGroups * Geom<T, NS>::GB + 16;
}

// shared memory of a pass of pw columns at depth K: the stages, then the
// segment's slices
template <typename T, int NS>
__host__ __device__ inline size_t smem_bytes(int K, int pw) {
  return (size_t)Geom<T, NS>::STAGES + (size_t)pw * seg_pitch<T, NS>(K);
}

// a pass's columns: the widest of 64, 32, ..., 2 that fits in `budget`
// bytes (0: none).  The buffer holds exactly pw segment rows: update_pass
// copies, cuts and reads no row past a pass's columns.
template <typename T, int NS>
__host__ __device__ inline int pass_cols(int K, size_t budget) {
  for (int pw = kBN; pw >= 2; pw /= 2)
    if (smem_bytes<T, NS>(K, pw) <= budget) return pw;
  return 0;
}

// Shared memory is addressed by 32-bit shared-window addresses throughout
// (ldmatrix, cp.async and the cut's 16-byte accesses): a generic 64-bit
// pointer a value would cost registers the ring's 128 do not have.
// threadIdx.x through a volatile move at each use (not hoisted): the
// offsets derived from it are then recomputed in the slice loop instead of
// held in registers across it, where the ring's own state must stay (held,
// they spill in B6; read from %tid.x at each use, B8-split at M4 took 4%
// longer, the move 2%: scripts/consume_variants.py)
__device__ __forceinline__ int tid_now() {
  int t;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(t) : "r"((int)threadIdx.x));
  return t;
}

// the barrier of one part of the block (ids from 1; __syncthreads is 0)
__device__ __forceinline__ void part_sync(int part) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + part), "n"(kPart) : "memory");
}

// the 16-column group of a part's tile that thread t's warp takes: warps
// (t % kPart) / 32 across, turned by the part, so that the warps of a
// narrow pass (the groups below live / 16) spread over the four SM
// sub-partitions
__device__ __forceinline__ int col_of(int t) {
  return ((t % kPart >> 5) / kWD + t / kPart) % 4;
}

// x's lines of the tile whose first flattened row is r0, columns [c0,
// c0 + ncols), to L2 by the threads of the part that takes the tile:
// issued at the tile's first slice, so that its epilogue's loads find them
// there
template <typename T, int NS>
__device__ __forceinline__ void prefetch_x(const T* __restrict__ x, int ltc, int j, int M, int N,
                                           int rows, int ncols, int c0, int r0) {
  using G = Geom<T, NS>;
  const int tid = tid_now() % kPart;
  const int bytes = ncols * (int)sizeof(T), lines = bytes / 128 + 1;  // a row may cross a line more
#pragma unroll 1
  for (int p = tid; p < G::BM * lines; p += kPart) {
    const int rr = p / lines, R = r0 + rr;
    if (R >= rows) break;
    const int ti = R / M;
    const char* a = reinterpret_cast<const char*>(
        x + (((long long)ti * ltc + j) * M + (R - ti * M)) * N + c0);
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a + min(128 * (p - rr * lines), bytes - 1)));
  }
}

template <typename T, int NS>
using Acc = float[dlaf_split::nterms(NS)][Geom<T, NS>::MI][2][4];

// acc += the products of a tile's slice kt (SK deep), its k16 chunks in
// order, every term into its own accumulator, from the cut cp slice in the
// stage at `st` and the segment's slices at `sb` (rows of rp bytes, the
// pass's ncols of them: a lane's row past them reads the last, for columns
// that are never stored).  The segment's fragments of a chunk are held for
// every m16 block, cp's one slice of one block at a time (the terms of that
// slice then), which keeps the fragments to 4 (NS + 1) registers.
template <typename T, int NS>
__device__ __forceinline__ void compute_slice(Acc<T, NS>& acc, uint32_t st, uint32_t sb, int rp,
                                              int ncols, int kt) {
  using G = Geom<T, NS>;
  const int t_ = tid_now(), tid = t_ % kPart, lane = tid & 31, warp = tid >> 5;
  const uint32_t a =
      st + ((warp % kWD) * 16 * G::MI + (lane & 15)) * G::SP + (lane >> 4) * G::GB;
  const int n = min(col_of(t_) * 16 + (lane & 7) + ((lane >> 4) << 3), ncols - 1);
  const uint32_t b = sb + n * rp + (kt * G::SG + ((lane >> 3) & 1)) * G::GB;
#pragma unroll
  for (int kc = 0; kc < G::SK / 16; ++kc) {
    uint32_t bf[NS][2][2];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      uint32_t r[4];
      ldsm_x4(r, b + 2 * kc * G::GB + 16 * s);
      bf[s][0][0] = r[0], bf[s][0][1] = r[1], bf[s][1][0] = r[2], bf[s][1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int sa = 0; sa < NS; ++sa) {
        uint32_t af[4];
        ldsm_x4(af, a + mi * 16 * G::SP + 2 * kc * G::GB + 16 * sa);
#pragma unroll
        for (int q = 0; q < dlaf_split::nterms(NS); ++q)
          if (dlaf_split::term_a(NS, q) == sa)
#pragma unroll
            for (int ni = 0; ni < 2; ++ni)
              dlaf_split::mma(acc[q][mi][ni], af, bf[dlaf_split::term_b(NS, q)][ni]);
      }
  }
}

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// x[i, j][m, c0 + n] -= the terms' sum (added at T in their order) for the
// warp's outputs of the tile whose first flattened row is r0 (row R of cp
// is m = R % M of tile i = R / M).  A thread's outputs come in pairs of
// adjacent columns, read and written as one 8- or 16-byte access (a quarter
// warp covers a row's 32 bytes); every x pair of the thread is loaded
// before any is stored (in f64, of one m16 block at a time, which keeps the
// pairs within the registers).  x lies on 16 bytes, N is a multiple of 8,
// c0 and ncols are even.
template <typename T, int NS>
__device__ __forceinline__ void store(T* __restrict__ x, int ltc, int j, int M, int N, int rows,
                                      int ncols, int c0, int r0, const Acc<T, NS>& acc) {
  using G = Geom<T, NS>;
  using P2 = typename Pair<T>::type;
  constexpr int MT = sizeof(T) == 8 ? 1 : G::MI;  // m16 blocks a round trip
  const int t_ = tid_now(), tid = t_ % kPart, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp % kWD) * 16 * G::MI, g = lane >> 2;
  const int n0 = col_of(t_) * 16 + 2 * (lane & 3);
#pragma unroll
  for (int m0 = 0; m0 < G::MI; m0 += MT) {
    T* xr[MT][2];  // the thread's rows at column c0, or null past the panel
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int R = r0 + wm + (m0 + mi) * 16 + g + 8 * hf, ti = R / M;
        xr[mi][hf] =
            R < rows ? x + (((long long)ti * ltc + j) * M + (R - ti * M)) * N + c0 : nullptr;
      }
    P2 xv[MT][2][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int n = n0 + ni * 8;  // n and ncols are even: n + 1 < ncols too
          xv[mi][hf][ni] = xr[mi][hf] && n < ncols
                               ? *reinterpret_cast<const P2*>(xr[mi][hf] + n)
                               : P2{T(0), T(0)};
        }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int n = n0 + ni * 8;
          if (!xr[mi][hf] || n >= ncols) continue;
          T sum[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sum[e] = dlaf_split::term_sum<T, NS>(
                [&](int q) { return acc[q][m0 + mi][ni][2 * hf + e]; });
          P2 out = xv[mi][hf][ni];
          out.x = out.x - sum[0];
          out.y = out.y - sum[1];
          *reinterpret_cast<P2*>(xr[mi][hf] + n) = out;
        }
  }
}

// One pass of a segment's update: x[i, j][m, c0 + n] -= the split product
// of cp[i][m, :] and seg[n, :] for i < ltr, m < M, n < ncols (at most the
// pass's columns), x [ltr][ltc][M][N].  Called by every thread of the
// block; `sm` holds smem_bytes<T, NS>(K, pw) with pw >= ncols.  Every copy
// has landed and every thread is done with `sm` when it returns.
//
// The block cuts the segment together, then splits in kParts parts: part
// p takes the tiles p, p + kParts, ... with a ring of stages and a barrier
// of its own, so that while one part waits, copies or cuts, another's
// products keep the tensor cores busy.
template <typename T, int NS>
__device__ void update_pass(T* __restrict__ x, const T* __restrict__ cp,
                            const T* __restrict__ seg, int ltr, int ltc, int j, int M, int N,
                            int K, int ncols, int c0, void* sm) {
  using G = Geom<T, NS>;
  constexpr int RPC = kPart / G::CPR;  // stage rows a round of a part's copies covers
  const int rows = ltr * M;
  const int nk = (K + kBK - 1) / kBK;  // K rounded up to 32, zero-filled past K
  const int ns = nk * (kBK / G::SK);   // a tile's slices
  const int tiles = (rows + G::BM - 1) / G::BM;
  const int rp = (int)seg_pitch<T, NS>(K);
  const int live = (ncols + 15) / 16 * 16;  // columns the warps compute
  const int tid = threadIdx.x, part = tid / kPart;
  const uint32_t sb = dlaf_fma::smem_addr(sm) + G::STAGES;
  const uint32_t st0 = dlaf_fma::smem_addr(sm) + part * kStages * G::STAGE;
  const int total = (tiles - part + kParts - 1) / kParts * ns;  // this part's slices
  // a warp's tile is rows (warp % kWD) * 16 MI of the part's tile by the
  // columns of its group (col_of): the warps past a narrow pass's columns
  // skip their products
  auto active = [&] { return col_of(tid_now()) * 16 < live; };

  // the segment's ncols rows, zero past K, by the whole block
  const int seg_cpr = nk * kGroups * G::CPG;
#pragma unroll 1
  for (int c = tid; c < ncols * seg_cpr; c += kThreads) {
    const int r = c / seg_cpr, w = c - r * seg_cpr, gi = w / G::CPG, h = w - gi * G::CPG;
    const int k = gi * kGK + h * G::V;
    const bool ok = k < K;  // K is a multiple of V: a copy is in or out
    cp_async16(sb + r * rp + gi * G::GB + h * 16, ok ? seg + (long long)r * K + k : seg,
               ok ? 16 : 0);
  }
  dlaf_fma::cp_async_commit();
  // start the copy of this part's slice t (its tile t / ns, depth slice
  // t % ns) into its stage: a thread copies rows ct / CPR + RPC p of the
  // tile, its 16 bytes of k at the same place in each; past the end an
  // empty group keeps the count of groups in step
  auto issue = [&](int t) {
    if (t < total) {
      const int ct = tid_now() % kPart, cr = ct / G::CPR, cgi = (ct % G::CPR) / G::CPG;
      const uint32_t cdst = cr * G::SP + cgi * G::GB + (ct % G::CPG) * 16;
      const int tl = t / ns, gk = (t - tl * ns) * G::SK + cgi * kGK + (ct % G::CPG) * G::V;
      const uint32_t st = st0 + (t % kStages) * G::STAGE + cdst;
#pragma unroll
      for (int p = 0; p < (G::BM + RPC - 1) / RPC; ++p) {
        if (G::BM % RPC != 0 && cr + p * RPC >= G::BM) break;
        const int gr = (part + kParts * tl) * G::BM + cr + p * RPC;
        const bool ok = gr < rows && gk < K;
        cp_async16(st + p * RPC * G::SP, ok ? cp + (long long)gr * K + gk : cp, ok ? 16 : 0);
      }
    }
    dlaf_fma::cp_async_commit();
  };
  // cut this part's slice t in its stage in place, one group a thread
  auto cut_stage = [&](int t) {
    const int ct = tid_now() % kPart;
    if (ct < G::BM * G::SG)
      cut_group<T, NS>(st0 + (t % kStages) * G::STAGE + (ct / G::SG) * G::SP +
                       (ct % G::SG) * G::GB);
  };
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  dlaf_fma::cp_async_wait<kStages - 1>();  // the segment has landed
  __syncthreads();
  const int seg_gpr = nk * kGroups;
#pragma unroll 1
  for (int q = tid; q < ncols * seg_gpr; q += kThreads) {
    const int r = q / seg_gpr;
    cut_group<T, NS>(sb + r * rp + (q - r * seg_gpr) * G::GB);
  }
  dlaf_fma::cp_async_wait<kStages - 2>();  // slice 0 has landed
  __syncthreads();  // and the segment's slices are visible to every part
  cut_stage(0);
  int t = 0;
  for (int r0 = part * G::BM; r0 < rows; r0 += kParts * G::BM) {
    Acc<T, NS> acc;
#pragma unroll
    for (int q = 0; q < dlaf_split::nterms(NS); ++q)
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[q][mi][ni][c] = 0.f;
    prefetch_x<T, NS>(x, ltc, j, M, N, rows, ncols, c0, r0);
#pragma unroll 1
    for (int kt = 0; kt < ns; ++kt, ++t) {
      dlaf_fma::cp_async_wait<kStages - 3>();  // this thread's copies of slice t + 1 have landed
      // the part's have, slice t's cut is visible, and the part is done
      // with slice t - 1's stage
      part_sync(part);
      issue(t + kStages - 1);  // into slice t - 1's stage
      // the products first: the cut's chain of dependent shared-memory
      // accesses then runs while the tensor cores work
      if (active()) compute_slice<T, NS>(acc, st0 + (t % kStages) * G::STAGE, sb, rp, ncols, kt);
      if (t + 1 < total) cut_stage(t + 1);
    }
    if (active()) store<T, NS>(x, ltc, j, M, N, rows, ncols, c0, r0, acc);
  }
  dlaf_fma::cp_async_wait<0>();
  __syncthreads();  // the stages and the slices are free for the next pass
}

}  // namespace dlaf_consume_split
