// The split-GEMM tile body of the trailing-update kernels under the bf16
// tiers (tune.gemm_precision 'bf16x3' / 'bf16x6'): the counterpart of
// tile.contract's split (dlaf_tpu/ops/tile.py:124-229) as the TPU kernels
// B3 and B9 trace it inside their bodies (dlaf_tpu/ops/
// pallas_trailing_update.py: _update_kernel :127, _contract_kernel :185).
// Used by csrc/trailing_update.cu (B3, B9); the ring consumers B6 and B8
// run their own split body, csrc/consume_split.cuh, with these bits, and
// take nterms, term_a, term_b and mma from here.
//
// What it computes, for one 64 x 64 output tile: each real operand element
// v (float or double) is cut into NS bf16 slices as its tile is loaded,
//   s0 = bf16(v), s1 = bf16(v - s0), s2 = bf16(v - s0 - s1),
// the residuals taken at the operand's type (a double rounds to bf16
// through float, as PyTorch's to(bfloat16) does), and every pair (i, j)
// with i + j < NS is multiplied on the tensor cores with a float32
// accumulator of its own: NS = 2 gives 3 products (bf16x3), NS = 3 gives 6
// (bf16x6).  The accumulators are kept apart to the end and added at the
// operand's type in the JAX package's term order (smallest first:
// (0,1), (1,0), (0,0) for NS = 2; (0,2), (1,1), (2,0), (0,1), (1,0), (0,0)
// for NS = 3; ops/tile.py: split_terms), so every product has the error
// profile of one bf16 product with float32 accumulation, as on the TPU.
//
// What bounds it on the H100: operations.  Each bf16 product is a GEMM of
// the tile's shape, so B3 at 32 x 32 x 512^2 (K = 512) under bf16x3 is
// 3 x 275 GFlop, 0.83 ms at the 989 TFLOP/s dense bf16 rate, against
// 0.66 ms for its bytes.  The design is the simple one: 256 threads, eight
// warps of 32 x 16 outputs each, 32-deep k slices loaded from device memory
// by all threads, cut into slices in registers and staged in shared memory
// as bf16 (rows padded to 40 values, so the fragment reads of a warp hit 32
// distinct banks), then mma.sync m16n8k16 (bf16 in, float32 out) from
// those fragments.  No wgmma, no TMA, no double buffering: the loads and
// the slicing are not overlapped with the products (a later PR's work).
// Each warp holds kMI = 2 m16 row blocks: 32 x 16 outputs, eight warps a
// tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dlaf_split {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kLds = kBK + 8;  // staged row length in bf16 values (80 bytes)

constexpr int kMI = 2;  // m16 row blocks a warp
// B3's and B9's blocks: kBM / (16 kMI) warps down the tile by 4 across
// (each 16 columns wide)
constexpr int kThreads = 32 * 4 * (kBM / (16 * kMI));

// products of a split with ns slices per operand
__host__ __device__ constexpr int nterms(int ns) { return ns * (ns + 1) / 2; }
// the slice of A and of B in term q (terms in the order they are added)
__host__ __device__ constexpr int term_a(int ns, int q) {
  return ns == 2 ? (q == 1 ? 1 : 0) : (q == 1 || q == 4) ? 1 : (q == 2 ? 2 : 0);
}
__host__ __device__ constexpr int term_b(int ns, int q) {
  return ns == 2 ? (q == 0 ? 1 : 0) : q == 0 ? 2 : (q == 1 || q == 3) ? 1 : 0;
}

// the staged slices of one k slice: a[s][m][k], b[s][n][k] (raw bf16 bits)
template <int NS>
struct Smem {
  unsigned short a[NS][kBM][kLds];
  unsigned short b[NS][kBN][kLds];
};

template <int NS>
using Acc = float[nterms(NS)][kMI][2][4];

template <typename T, int NS>
__device__ __forceinline__ void cut(T v, unsigned short (&s)[NS]) {
  T r = v;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const __nv_bfloat16 h = __float2bfloat16_rn(static_cast<float>(r));
    s[i] = __bfloat16_as_ushort(h);
    if (i + 1 < NS) r = r - static_cast<T>(__bfloat162float(h));
  }
}

__device__ __forceinline__ uint32_t ld32(const unsigned short* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[q] = sum over slots s < S and depths k < K of
// A_s(m, k)_slice(term_a(q)) * B_s(k, n)_slice(term_b(q)) for the 64 x 64
// tile at (m0, n0), each term summed in float32, with
//   A_s(m, k) = a[s * sa + m * lda + k]
//   B_s(k, n) = b[s * sb + n * ldb + k]  (kBNK: each slot stored N x K)
//             = b[s * sb + k * ldb + n]  (otherwise: K x N)
// Rows m >= M, columns n >= N and depths k >= K read as zero.  tid in
// [0, kThreads) is the thread's place in the block; every __syncthreads()
// is met by the whole block.  Offsets within a slot are 32 bits.
template <typename T, int NS, bool kBNK>
__device__ __forceinline__ void tile_gemm(Acc<NS>& acc, const T* __restrict__ a,
                                          long long sa, int lda, const T* __restrict__ b,
                                          long long sb, int ldb, int S, int M, int N, int K,
                                          int m0, int n0, int tid, Smem<NS>& sm) {
  constexpr int kT = nterms(NS);
  constexpr int kNT = kThreads;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 2) * (16 * kMI), wn = (warp & 3) * 16;
#pragma unroll
  for (int q = 0; q < kT; ++q)
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[q][mi][ni][c] = 0.f;

  for (int s = 0; s < S; ++s) {
    const T* as_s = a + s * sa;
    const T* bs_s = b + s * sb;
    for (int k0 = 0; k0 < K; k0 += kBK) {
      // load, cut and stage: 64 x 32 of A and of B, 8 elements of each a
      // thread
#pragma unroll
      for (int q = 0; q < kBM * kBK / kNT; ++q) {
        const int idx = tid + q * kNT;
        const int mm = idx / kBK, kk = idx % kBK;
        const int gm = m0 + mm, gk = k0 + kk;
        unsigned short sl[NS];
        cut<T, NS>((gm < M && gk < K) ? as_s[gm * lda + gk] : T(0), sl);
#pragma unroll
        for (int i = 0; i < NS; ++i) sm.a[i][mm][kk] = sl[i];
      }
#pragma unroll
      for (int q = 0; q < kBN * kBK / kNT; ++q) {
        const int idx = tid + q * kNT;
        int nn, kk;
        if (kBNK) {
          nn = idx / kBK;
          kk = idx % kBK;
        } else {
          kk = idx / kBN;
          nn = idx % kBN;
        }
        const int gn = n0 + nn, gk = k0 + kk;
        T v = T(0);
        if (gn < N && gk < K) v = kBNK ? bs_s[gn * ldb + gk] : bs_s[gk * ldb + gn];
        unsigned short sl[NS];
        cut<T, NS>(v, sl);
#pragma unroll
        for (int i = 0; i < NS; ++i) sm.b[i][nn][kk] = sl[i];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t af[NS][kMI][4], bf[NS][2][2];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi) {
            const unsigned short* p = &sm.a[i][wm + mi * 16 + g][kk + 2 * t4];
            af[i][mi][0] = ld32(p);
            af[i][mi][1] = ld32(p + 8 * kLds);
            af[i][mi][2] = ld32(p + 8);
            af[i][mi][3] = ld32(p + 8 * kLds + 8);
          }
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            const unsigned short* p = &sm.b[i][wn + ni * 8 + g][kk + 2 * t4];
            bf[i][ni][0] = ld32(p);
            bf[i][ni][1] = ld32(p + 8);
          }
        }
#pragma unroll
        for (int q = 0; q < kT; ++q)
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
            for (int ni = 0; ni < 2; ++ni)
              mma(acc[q][mi][ni], af[term_a(NS, q)][mi], bf[term_b(NS, q)][ni]);
      }
      __syncthreads();
    }
  }
}

// The terms added at T in their order, then x[m * ldx + n] -= sum (kSub)
// or x[m * ldx + n] = sum, over the tile's in-range elements.
template <typename T, int NS, bool kSub>
__device__ __forceinline__ void tile_store(T* __restrict__ x, long long ldx, int M, int N, int m0,
                                           int n0, const Acc<NS>& acc, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 2) * (16 * kMI), wn = (warp & 3) * 16;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gm = m0 + wm + mi * 16 + g + 8 * (c >> 1);
        const int gn = n0 + wn + ni * 8 + 2 * t4 + (c & 1);
        if (gm >= M || gn >= N) continue;
        T sum = static_cast<T>(acc[0][mi][ni][c]);
#pragma unroll
        for (int q = 1; q < nterms(NS); ++q) sum = sum + static_cast<T>(acc[q][mi][ni][c]);
        if (kSub) x[gm * ldx + gn] -= sum;
        else x[gm * ldx + gn] = sum;
      }
}

}  // namespace dlaf_split
