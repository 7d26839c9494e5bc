// The default-tier update body of the ring consumers B6 and B8
// (csrc/consume.cu), written for Hopper within the ring's limits.
//
// It applies one ring segment: x[i, j][m, c0 + n] -= sum over k of
// cp[i][m, k] * seg[n, k] for every i and m and the segment's n < ncols,
// with the bits of csrc/fma_gemm.cuh's body (B3): every output one FMA
// chain started at +0 over k ascending in 16-deep slices whose tail past
// K is zero-filled, explicit fused multiply-adds (__fmaf_rn, __fma_rn),
// then x - acc.  Each output of a consume update takes exactly one slot,
// so B6's trailing matrix is bit for bit B3 applied once to the merged
// panel with the slots not applied set to zero (chip_smoke.py's check).
//
// The ring's limits shape it: a ring kernel's block is 512 threads, at
// most 128 registers a thread, one block an SM, 16 blocks a rank; and a
// segment's output is narrow (ncols = the segment's rows of one slot, 64
// at nb = 512, 192 and 128).  So:
// - cp [ltr][M][K] is contiguous, and the body takes it as one
//   (ltr * M) x K matrix: a tile is BM of those flattened rows by 64
//   columns (f32 128 x 64, 4 x 4 outputs a thread; f64 64 x 64, 2 x 4),
//   so at M = 192 or 96 only the panel's last tile is ragged, and a tile
//   may span two row tiles of x.  A larger register tile (f32 256 x 64,
//   8 x 4 a thread) spills within the 128 registers (ptxas), in every
//   arrangement tried;
// - one pipelined loop over the segment's (tile, k slice) pairs: the
//   copies of the next kStages - 1 slices stay in flight across a tile's
//   end (its epilogue overlaps them), so the ring of stages fills once a
//   segment, not once a tile;
// - both operands by 16-byte cp.async.cg copies, which read through L2
//   only: the segment comes from a landing slot that other ranks rewrite
//   during the launch, and an L1 line of an earlier hop must never serve
//   it (never cp.async.ca or plain loads here);
// - no transpose: both stay [row][k] in shared memory, rows padded by 16
//   bytes, read 16 bytes of k a time (fma_gemm.cuh's N x K form: rows
//   ty + 32 i of cp, rows tx + 16 j of the segment);
// - the epilogue loads all of the thread's x before it stores any
//   (fma_gemm.cuh's store).
// Past-the-edge rows, segment rows and depths are zero-filled by the
// copy's source size (0 bytes), never read.  The caller has checked that
// cp, the segment and K * sizeof(T) lie on 16 bytes.
#pragma once

#include <cuda_runtime.h>

#include "fma_gemm.cuh"

namespace dlaf_ring_gemm {

using dlaf_fma::kBK;
constexpr int kThreads = 512;  // a ring kernel's block, 16 x 32
constexpr int kStages = 4;
constexpr int kBN = 64;  // a segment's rows, at most (consume.cu's segment_rows)

template <typename T>
struct Geom {
  static constexpr int BM = sizeof(T) == 4 ? 128 : 64;  // flattened rows of cp a tile
  static constexpr int TM = BM / 32, TN = kBN / 16;      // a thread's outputs
  static constexpr int V = 16 / (int)sizeof(T);          // elements in 16 bytes
  static constexpr int LDK = kBK + V;                    // a [row][k] row, padded by 16 bytes
  static constexpr int A_ELEMS = BM * LDK;
  static constexpr int STAGE = A_ELEMS + kBN * LDK;
  static constexpr size_t SMEM_BYTES = (size_t)kStages * STAGE * sizeof(T);
};

// Start the copy of depths [k0, k0 + kBK) of rows [r0, r0 + BM) of a
// (rows x K) and of the ncols rows of b (ncols x K) into the stage at `as`.
template <typename T>
__device__ __forceinline__ void load_slice(T* as, const T* __restrict__ a, int rows,
                                           const T* __restrict__ b, int ncols, int K, int r0,
                                           int k0, int tid) {
  using G = Geom<T>;
  constexpr int CPR = kBK / G::V;  // 16-byte chunks in a row's slice
  static_assert(G::BM * CPR % kThreads == 0 && kBN * CPR <= kThreads, "one chunk a thread");
  T* bs = as + G::A_ELEMS;
#pragma unroll
  for (int p = 0; p < G::BM * CPR / kThreads; ++p) {
    const int c = tid + p * kThreads, r = c / CPR, kc = (c % CPR) * G::V;
    const int gr = r0 + r, gk = k0 + kc;
    const bool ok = gr < rows && gk < K;  // K is a multiple of V: a chunk is in or out
    dlaf_fma::cp_async16(as + r * G::LDK + kc, ok ? a + (long long)gr * K + gk : a,
                         ok ? 16 : 0);
  }
  if (tid < kBN * CPR) {
    const int r = tid / CPR, kc = (tid % CPR) * G::V, gk = k0 + kc;
    const bool ok = r < ncols && gk < K;
    dlaf_fma::cp_async16(bs + r * G::LDK + kc, ok ? b + r * K + gk : b, ok ? 16 : 0);
  }
}

// acc[i][j] += over the slice staged at `as`, k ascending, for the
// thread's rows ty + 32 i and columns tx + 16 j.  The segment's 16 bytes
// of k are held for all j, cp's for one i at a time: 36 registers of
// operands and sums (f32 and f64), within the ring's 128.
template <typename T>
__device__ __forceinline__ void compute_slice(T (&acc)[Geom<T>::TM][Geom<T>::TN], const T* as,
                                              int tx, int ty) {
  using G = Geom<T>;
  using VT = typename dlaf_fma::Vec<T>::type;
  const T* bs = as + G::A_ELEMS;
#pragma unroll
  for (int g = 0; g < kBK; g += G::V) {
    alignas(16) T bf[G::TN][G::V];
#pragma unroll
    for (int j = 0; j < G::TN; ++j)
      *reinterpret_cast<VT*>(bf[j]) =
          *reinterpret_cast<const VT*>(bs + (tx + 16 * j) * G::LDK + g);
#pragma unroll
    for (int i = 0; i < G::TM; ++i) {
      alignas(16) T af[G::V];
      *reinterpret_cast<VT*>(af) =
          *reinterpret_cast<const VT*>(as + (ty + 32 * i) * G::LDK + g);
#pragma unroll
      for (int c = 0; c < G::V; ++c)
#pragma unroll
        for (int j = 0; j < G::TN; ++j) acc[i][j] = dlaf_fma::madd(af[c], bf[j][c], acc[i][j]);
    }
  }
}

// x[i, j][m, c0 + n] -= acc for the thread's outputs of the tile whose
// first flattened row is r0 (row R of cp is m = R % M of tile i = R / M).
// One pointer a row, its columns at fixed offsets from it: the addresses
// of the loads are those of the stores without 64-bit registers each.
template <typename T>
__device__ __forceinline__ void store(T* __restrict__ x, int ltc, int j, int M, int N, int rows,
                                      int ncols, int c0, int r0,
                                      const T (&acc)[Geom<T>::TM][Geom<T>::TN], int tx, int ty) {
  using G = Geom<T>;
  T* xr[G::TM];  // the thread's first column of each row, or null past the panel
#pragma unroll
  for (int i = 0; i < G::TM; ++i) {
    const int R = r0 + ty + 32 * i, ti = R / M;
    xr[i] = R < rows ? x + (((long long)ti * ltc + j) * M + (R - ti * M)) * N + c0 + tx : nullptr;
  }
  T xv[G::TM][G::TN];
#pragma unroll
  for (int i = 0; i < G::TM; ++i)
#pragma unroll
    for (int jj = 0; jj < G::TN; ++jj)
      xv[i][jj] = xr[i] && tx + 16 * jj < ncols ? xr[i][16 * jj] : T(0);
#pragma unroll
  for (int i = 0; i < G::TM; ++i)
#pragma unroll
    for (int jj = 0; jj < G::TN; ++jj)
      if (xr[i] && tx + 16 * jj < ncols) xr[i][16 * jj] = xv[i][jj] - acc[i][jj];
}

// One segment's update: x[i, j][m, c0 + n] -= sum_k cp[i][m, k] * seg[n, k]
// for i < ltr, m < M, n < ncols, x [ltr][ltc][M][N].  Called by every
// thread of the block; `sm` holds Geom<T>::SMEM_BYTES.  Every copy has
// landed and every thread is done with `sm` when it returns.
template <typename T>
__device__ void update_segment(T* __restrict__ x, const T* __restrict__ cp,
                               const T* __restrict__ seg, int ltr, int ltc, int j, int M, int N,
                               int K, int ncols, int c0, T* sm) {
  using G = Geom<T>;
  const int rows = ltr * M;
  const int nk = (K + kBK - 1) / kBK;  // the last slice's tail past K is zero-filled
  const int total = (rows + G::BM - 1) / G::BM * nk;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // start the copy of slice t (tile t / nk, depth slice t % nk) into its
  // stage; past the end an empty group keeps the count of groups in step
  auto issue = [=](int t) {
    if (t < total) {
      const int tile = t / nk;
      load_slice<T>(sm + (t % kStages) * G::STAGE, cp, rows, seg, ncols, K, tile * G::BM,
                    (t - tile * nk) * kBK, tid);
    }
    dlaf_fma::cp_async_commit();
  };
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  int t = 0;
  for (int r0 = 0; r0 < rows; r0 += G::BM) {
    T acc[G::TM][G::TN];
#pragma unroll
    for (int i = 0; i < G::TM; ++i)
#pragma unroll
      for (int jj = 0; jj < G::TN; ++jj) acc[i][jj] = T(0);
    for (int kt = 0; kt < nk; ++kt, ++t) {
      dlaf_fma::cp_async_wait<kStages - 2>();  // this thread's copies of slice t have landed
      __syncthreads();  // everyone's have, and everyone is done with slice t - 1's stage
      issue(t + kStages - 1);  // into slice t - 1's stage; past this tile, the next one's
      compute_slice<T>(acc, sm + (t % kStages) * G::STAGE, tx, ty);
    }
    store<T>(x, ltc, j, M, N, rows, ncols, c0, r0, acc, tx, ty);
  }
  dlaf_fma::cp_async_wait<0>();
  __syncthreads();  // the stages are free for the next segment
}

}  // namespace dlaf_ring_gemm
