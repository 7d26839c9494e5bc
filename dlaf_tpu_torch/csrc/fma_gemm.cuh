// The default-tier FMA GEMM body of B3 and B9 (csrc/trailing_update.cu),
// written for Hopper.  It computes what dlaf_tu::tile_gemm + tile_store
// (csrc/trailing_update.cuh) compute, with the same bits: every output
// element is one FMA chain started at +0, summed over the S slots in
// order and, within a slot, over k ascending in 16-deep slices whose tail
// past K is zero-filled, so the chain takes the same zero terms at the
// same places (they matter only to the sign of a zero sum).  The products
// are explicit fused multiply-adds (__fmaf_rn, __fma_rn), where the old
// body relies on nvcc contracting `acc += a * b` into one.
//
// What bounds it: f32 (f64) FMA issue.  The design keeps the FMA units fed:
// - a register tile of TM x TN = 8 x 8 outputs a thread (f32; 4 x 4 in
//   f64, whose 64 accumulators would need 128 registers alone), 256
//   threads on a 128 x 128 (f64: 64 x 64) output tile;
// - a ring of kStages shared-memory stages filled by cp.async: slices
//   t+1 .. t+kStages-1 are in flight while slice t is computed, with one
//   __syncthreads per slice (the ring's wait_group, then the barrier that
//   also frees the stage the next copy overwrites);
// - 16-byte copies (cp.async.cg) where every row is 16-byte aligned (K, and
//   N for a K x N operand, multiples of 16 bytes, the bases aligned), else
//   one element per copy (cp.async.ca, 4 or 8 bytes): the caller picks;
//   past-the-edge rows, columns and depths are zero-filled by the copy's
//   source size (0 bytes), never read;
// - no transpose: a and an N x K operand stay [row][k] in shared memory,
//   each row padded by 16 bytes, and a thread reads 16 bytes of k per row
//   (rows ty + 16 i of a, rows tx + 16 j of b: the 8 lanes of a quarter
//   warp hit 8 distinct 16-byte bank groups); a K x N operand stays
//   [k][n] and a thread reads 16 bytes of n (columns tx * V + 16 V q + c),
//   so a cp.async copies every operand as it lies in device memory.
// Ragged M and N are masked, not given a narrower tile (B3's and B9's
// shapes on the main paths are multiples of 128).  Offsets within a slot
// are 32 bits, the slot strides 64, as in dlaf_tu::tile_gemm.
//
// The f32 instantiations take up to 254 registers without spilling, so one
// block (8 warps) runs per SM: a cap of 128 registers for two blocks an SM
// spills (ptxas).
#pragma once

#include <cuda_runtime.h>

namespace dlaf_fma {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBK = 16;        // the k slice, dlaf_tu::kBK: the same zero-padded tail
constexpr int kStages = 4;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

// The tile of one block and the shared-memory layout of one stage, in
// elements.  kBNK: b is N x K per slot (else K x N).
template <typename T, bool kBNK>
struct Geom {
  static constexpr int BM = sizeof(T) == 4 ? 128 : 64, BN = BM;
  static constexpr int TM = BM / 16, TN = BN / 16;
  static constexpr int V = 16 / (int)sizeof(T);  // elements in 16 bytes
  static constexpr int LDK = kBK + V;            // a [row][k] row, padded by 16 bytes
  static constexpr int LDN = BN + V;             // a [k][n] row
  static constexpr int A_ELEMS = BM * LDK;
  static constexpr int B_ELEMS = kBNK ? BN * LDK : kBK * LDN;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr size_t SMEM_BYTES = (size_t)kStages * STAGE * sizeof(T);
  // the output column of a thread's j-th accumulator
  static __device__ __forceinline__ int col(int tx, int j) {
    return kBNK ? tx + 16 * j : (j / V) * 16 * V + tx * V + j % V;
  }
};

__device__ __forceinline__ float madd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, of which the first `src_bytes` (16 or 0) are read and the rest
// zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// one element of kBytes (4 or 8), read when src_bytes == kBytes, else zero
template <int kBytes>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(kBytes), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start the copy of one k slice (depths [k0, k0 + kBK) of slot pointers
// a_s, b_s) into the stage at `as` (a, then b).  kVec: 16-byte copies (the
// caller has checked the alignment), else one element per copy.
template <typename T, bool kBNK, bool kVec>
__device__ __forceinline__ void load_slice(T* as, const T* __restrict__ a_s, int lda,
                                           const T* __restrict__ b_s, int ldb, int M, int N,
                                           int K, int m0, int n0, int k0, int tid) {
  using G = Geom<T, kBNK>;
  constexpr int V = G::V;
  T* bs = as + G::A_ELEMS;
  if constexpr (kVec) {
    constexpr int CPR = kBK / V;  // 16-byte chunks in a row of k
#pragma unroll
    for (int p = 0; p < G::BM * CPR / kThreads; ++p) {
      const int c = tid + p * kThreads, r = c / CPR, kc = (c % CPR) * V;
      const int gm = m0 + r, gk = k0 + kc;
      const bool ok = gm < M && gk < K;
      cp_async16(as + r * G::LDK + kc, ok ? a_s + gm * lda + gk : a_s, ok ? 16 : 0);
    }
    if constexpr (kBNK) {
#pragma unroll
      for (int p = 0; p < G::BN * CPR / kThreads; ++p) {
        const int c = tid + p * kThreads, r = c / CPR, kc = (c % CPR) * V;
        const int gn = n0 + r, gk = k0 + kc;
        const bool ok = gn < N && gk < K;
        cp_async16(bs + r * G::LDK + kc, ok ? b_s + gn * ldb + gk : b_s, ok ? 16 : 0);
      }
    } else {
      constexpr int CPN = G::BN / V;  // 16-byte chunks in a row of n
#pragma unroll
      for (int p = 0; p < kBK * CPN / kThreads; ++p) {
        const int c = tid + p * kThreads, r = c / CPN, nc = (c % CPN) * V;
        const int gk = k0 + r, gn = n0 + nc;
        const bool ok = gk < K && gn < N;  // N is a multiple of V: a chunk is in or out
        cp_async16(bs + r * G::LDN + nc, ok ? b_s + gk * ldb + gn : b_s, ok ? 16 : 0);
      }
    }
  } else {
    constexpr int E = sizeof(T);
#pragma unroll
    for (int p = 0; p < G::BM * kBK / kThreads; ++p) {
      const int e = tid + p * kThreads, r = e / kBK, kk = e % kBK;
      const int gm = m0 + r, gk = k0 + kk;
      const bool ok = gm < M && gk < K;
      cp_async_elem<E>(as + r * G::LDK + kk, ok ? a_s + gm * lda + gk : a_s, ok ? E : 0);
    }
    if constexpr (kBNK) {
#pragma unroll
      for (int p = 0; p < G::BN * kBK / kThreads; ++p) {
        const int e = tid + p * kThreads, r = e / kBK, kk = e % kBK;
        const int gn = n0 + r, gk = k0 + kk;
        const bool ok = gn < N && gk < K;
        cp_async_elem<E>(bs + r * G::LDK + kk, ok ? b_s + gn * ldb + gk : b_s, ok ? E : 0);
      }
    } else {
#pragma unroll
      for (int p = 0; p < kBK * G::BN / kThreads; ++p) {
        const int e = tid + p * kThreads, r = e / G::BN, nn = e % G::BN;
        const int gk = k0 + r, gn = n0 + nn;
        const bool ok = gk < K && gn < N;
        cp_async_elem<E>(bs + r * G::LDN + nn, ok ? b_s + gk * ldb + gn : b_s, ok ? E : 0);
      }
    }
  }
}

// acc[i][j] += over the slice staged at `as`, k ascending, for the
// thread's rows ty + 16 i and columns Geom::col(tx, j)
template <typename T, bool kBNK>
__device__ __forceinline__ void compute_slice(T (&acc)[Geom<T, kBNK>::TM][Geom<T, kBNK>::TN],
                                              const T* as, int tx, int ty) {
  using G = Geom<T, kBNK>;
  using VT = typename Vec<T>::type;
  constexpr int V = G::V, TM = G::TM, TN = G::TN;
  const T* bs = as + G::A_ELEMS;
#pragma unroll
  for (int g = 0; g < kBK; g += V) {
    alignas(16) T af[TM][V];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      *reinterpret_cast<VT*>(af[i]) =
          *reinterpret_cast<const VT*>(as + (ty + 16 * i) * G::LDK + g);
    if constexpr (kBNK) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        alignas(16) T bf[V];
        *reinterpret_cast<VT*>(bf) = *reinterpret_cast<const VT*>(bs + (tx + 16 * j) * G::LDK + g);
#pragma unroll
        for (int c = 0; c < V; ++c)
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[i][j] = madd(af[i][c], bf[c], acc[i][j]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        alignas(16) T bf[TN];
#pragma unroll
        for (int q = 0; q < TN / V; ++q)
          *reinterpret_cast<VT*>(bf + q * V) =
              *reinterpret_cast<const VT*>(bs + (g + c) * G::LDN + q * 16 * V + tx * V);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = madd(af[i][c], bf[j], acc[i][j]);
      }
    }
  }
}

// acc = sum over slots s < S and depths k < K of A_s(m, k) * B_s(k, n) for
// the thread's outputs of the tile at (m0, n0), with
//   A_s(m, k) = a[s * sa + m * lda + k]
//   B_s(k, n) = b[s * sb + n * ldb + k]  (kBNK: each slot stored N x K)
//             = b[s * sb + k * ldb + n]  (otherwise: K x N)
// (dlaf_tu::tile_gemm's contract).  `sm` is Geom::SMEM_BYTES of dynamic
// shared memory; every thread of the block calls this with the same S and
// K.
template <typename T, bool kBNK, bool kVec>
__device__ __forceinline__ void gemm(T (&acc)[Geom<T, kBNK>::TM][Geom<T, kBNK>::TN],
                                     const T* __restrict__ a, long long sa, int lda,
                                     const T* __restrict__ b, long long sb, int ldb, int S, int M,
                                     int N, int K, int m0, int n0, T* sm) {
  using G = Geom<T, kBNK>;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < G::TM; ++i)
#pragma unroll
    for (int j = 0; j < G::TN; ++j) acc[i][j] = T(0);

  const int nk = (K + kBK - 1) / kBK;  // the last slice's tail past K is zero-filled
  const int total = S * nk;
  int ls = 0, lk0 = 0;  // the next slice to copy: slot, first depth
  auto issue = [&](int t) {
    if (t < total) {
      load_slice<T, kBNK, kVec>(sm + (t % kStages) * G::STAGE, a + ls * sa, lda, b + ls * sb, ldb,
                                M, N, K, m0, n0, lk0, tid);
      lk0 += kBK;
      if (lk0 >= nk * kBK) {
        lk0 = 0;
        ++ls;
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count of groups in step
  };
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < total; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slice t have landed
    __syncthreads();  // everyone's have, and everyone is done with slice t - 1's stage
    issue(t + kStages - 1);  // into slice t - 1's stage
    compute_slice<T, kBNK>(acc, sm + (t % kStages) * G::STAGE, tx, ty);
  }
}

// x[m * ldx + n] -= acc over the tile's in-range elements (kSub), or
// x[m * ldx + n] = acc (the contraction's write).  kSub loads all of the
// thread's x before it stores any: the compiler cannot tell that a store
// to one row does not alias a load from the next, and would otherwise wait
// out one load's latency per row (in the first measurements that made B3's
// N x K form slower than the first body).
template <typename T, bool kBNK, bool kSub>
__device__ __forceinline__ void store(T* __restrict__ x, long long ldx, int M, int N, int m0,
                                      int n0,
                                      const T (&acc)[Geom<T, kBNK>::TM][Geom<T, kBNK>::TN]) {
  using G = Geom<T, kBNK>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  T xv[G::TM][G::TN];
  if constexpr (kSub) {
#pragma unroll
    for (int i = 0; i < G::TM; ++i) {
      const int gm = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < G::TN; ++j) {
        const int gn = n0 + G::col(tx, j);
        xv[i][j] = gm < M && gn < N ? x[gm * ldx + gn] : T(0);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < G::TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < G::TN; ++j) {
      const int gn = n0 + G::col(tx, j);
      if (gn < N) x[gm * ldx + gn] = kSub ? xv[i][j] - acc[i][j] : acc[i][j];
    }
  }
}

}  // namespace dlaf_fma
