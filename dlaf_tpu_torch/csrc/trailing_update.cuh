// The first GEMM tile body of the trailing-update kernel (B3) and of the
// panel contraction (B9), which csrc/fma_gemm.cuh replaced with the same
// bits: it runs only in their reference kernels (csrc/trailing_update.cu's
// *_ref_* entry points), for the card's before/after checks.
//
// One 64 x 64 output tile, computed by 256 threads (16 x 16, each a 4 x 4
// register tile) from 16-deep k slices staged in shared memory, summed over
// S slots in order and, within a slot, over k in order, so every element's
// sum has one fixed order whatever the caller.
#pragma once

#include <cuda_runtime.h>

namespace dlaf_tu {

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kTM = 4, kTN = 4;  // 16 x 16 threads, each a 4 x 4 tile
constexpr int kLds = kBM + 4;    // row length of the staged slices (kBN == kBM)

// shared memory of one tile_gemm, in elements
constexpr int kSmemElems = 2 * kBK * kLds;

// acc = sum over slots s < S and depths k < K of A_s(m, k) * B_s(k, n), for
// m in [m0, m0 + 64), n in [n0, n0 + 64), with
//   A_s(m, k) = a[s * sa + m * lda + k]
//   B_s(k, n) = b[s * sb + n * ldb + k]  (kBNK: each slot stored N x K)
//             = b[s * sb + k * ldb + n]  (otherwise: K x N)
// Rows m >= M, columns n >= N and depths k >= K read as zero (M = 0 makes a
// tile that reads nothing).  tid in [0, 256) is the thread's place in its
// 256-thread group and `sm` that group's kSmemElems of shared memory.  Every
// __syncthreads() in here is met by the whole block, so all groups of a
// block must call it with the same S and K.  Offsets within a slot are 32
// bits (a slot holds fewer than 2^31 elements), the slot strides 64, and
// the body is forced inline: 64-bit offsets throughout cost B3 time.
template <typename T, bool kBNK>
__device__ __forceinline__ void tile_gemm(T (&acc)[kTM][kTN], const T* __restrict__ a,
                                          long long sa, int lda, const T* __restrict__ b,
                                          long long sb, int ldb, int S, int M, int N, int K,
                                          int m0, int n0, int tid, T* sm) {
  T* as = sm;               // as[k][m]
  T* bs = sm + kBK * kLds;  // bs[k][n]
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int u = 0; u < kTM; ++u)
#pragma unroll
    for (int v = 0; v < kTN; ++v) acc[u][v] = T(0);

  for (int s = 0; s < S; ++s) {
    const T* as_s = a + s * sa;
    const T* bs_s = b + s * sb;
    for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
      for (int q = 0; q < kBM * kBK / kThreads; ++q) {
        const int idx = tid + q * kThreads;
        const int mm = idx / kBK, kk = idx % kBK;
        const int gm = m0 + mm, gk = k0 + kk;
        as[kk * kLds + mm] = (gm < M && gk < K) ? as_s[gm * lda + gk] : T(0);
      }
#pragma unroll
      for (int q = 0; q < kBN * kBK / kThreads; ++q) {
        const int idx = tid + q * kThreads;
        if (kBNK) {
          const int nn = idx / kBK, kk = idx % kBK;
          const int gn = n0 + nn, gk = k0 + kk;
          bs[kk * kLds + nn] = (gn < N && gk < K) ? bs_s[gn * ldb + gk] : T(0);
        } else {
          const int kk = idx / kBN, nn = idx % kBN;
          const int gn = n0 + nn, gk = k0 + kk;
          bs[kk * kLds + nn] = (gn < N && gk < K) ? bs_s[gk * ldb + gn] : T(0);
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        T av[kTM], bv[kTN];
#pragma unroll
        for (int u = 0; u < kTM; ++u) av[u] = as[kk * kLds + ty + 16 * u];
#pragma unroll
        for (int v = 0; v < kTN; ++v) bv[v] = bs[kk * kLds + tx + 16 * v];
#pragma unroll
        for (int u = 0; u < kTM; ++u)
#pragma unroll
          for (int v = 0; v < kTN; ++v) acc[u][v] += av[u] * bv[v];
      }
      __syncthreads();
    }
  }
}

// x[m * ldx + n] -= acc over the tile's in-range elements (kSub), or
// x[m * ldx + n] = acc (the contraction's write).
template <typename T, bool kSub>
__device__ void tile_store(T* __restrict__ x, long long ldx, int M, int N, int m0, int n0,
                           const T (&acc)[kTM][kTN], int tid) {
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int u = 0; u < kTM; ++u) {
    const int gm = m0 + ty + 16 * u;
    if (gm >= M) continue;
#pragma unroll
    for (int v = 0; v < kTN; ++v) {
      const int gn = n0 + tx + 16 * v;
      if (gn < N) {
        if (kSub) x[gm * ldx + gn] -= acc[u][v];
        else x[gm * ldx + gn] = acc[u][v];
      }
    }
  }
}

}  // namespace dlaf_tu
