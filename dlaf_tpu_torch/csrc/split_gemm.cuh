// The split-GEMM arithmetic of the bf16 tiers (tune.gemm_precision
// 'bf16x3' / 'bf16x6'): the counterpart of tile.contract's split
// (dlaf_tpu/ops/tile.py:124-229) as the TPU kernels B3 and B9 trace it
// inside their bodies (dlaf_tpu/ops/pallas_trailing_update.py:
// _update_kernel :127, _contract_kernel :185), and the body of B3-split and
// B9-split (csrc/trailing_update.cu).  The ring consumers B6 and B8 run their
// own split body, csrc/consume_split.cuh, on the pieces shared here: the
// terms (nterms, term_a, term_b), the product (mma), the cut (cut8,
// cut_group) and the terms' sum (term_sum).  Both bodies give the same bits.
//
// What is computed: each real operand element v (float or double) is cut
// into NS bf16 slices,
//   s0 = bf16(v), s1 = bf16(v - s0), s2 = bf16(v - s0 - s1),
// the residuals taken at the operand's type (a double rounds to bf16
// through float, as PyTorch's to(bfloat16) does), and every pair (i, j)
// with i + j < NS is multiplied on the tensor cores with a float32
// accumulator of its own started at +0: NS = 2 gives 3 products (bf16x3),
// NS = 3 gives 6 (bf16x6).  Each accumulator takes mma.sync m16n8k16 over
// the k16 chunks in ascending order up to K rounded up to 32, zero-filled
// past K (over the slots in order first, for B9's sum across slots).  The
// accumulators are added at the operand's type in the JAX package's term
// order (smallest first: (0,1), (1,0), (0,0) for NS = 2; (0,2), (1,1),
// (2,0), (0,1), (1,0), (0,0) for NS = 3; ops/tile.py: split_terms), so
// every product has the error profile of one bf16 product with float32
// accumulation, as on the TPU.
//
// B3-split and B9-split: what bounds them on the H100 is operations.  B3 at
// 32 x 32 x 512^2 under bf16x3 is 3 x 275 GFlop, 0.83 ms at the 989 TFLOP/s
// dense bf16 rate, against 0.66 ms for its bytes.  A call is two kernels:
// - the pre-pass (split_cut_kernel) reads a and b once, as they lie, and
//   writes each operand's slices into a workspace of bf16 planes: one plane
//   row per operand row (b's K x N slots transposed through shared memory,
//   32 k by 64 n a tile), K rounded up to 32 and zero-filled, every group of
//   8 k values as NS runs of 16 bytes (slice s at +16 s), the layout
//   consume_split.cuh cuts its segment into in shared memory; so each
//   element is cut once a call, not once per tile that reads it, and the
//   body has one operand layout;
// - the body (run) is a bf16 multi-term GEMM over the planes, 256 threads
//   and one block an SM, on 128 x 64 output tiles at NS = 2 (eight warps of
//   32 x 32 outputs, 96 float32 accumulators a thread), 128 x 128 for B9 in
//   f32 (warps of 64 x 32, 192 accumulators), 64 x 64 at NS = 3 (warps of
//   32 x 16, 6 terms: 96).  What held it back, in order
//   (scripts/split_variants.py's probes): the planes' copies from L2 (a
//   stage's copies are as many bytes as the f32 operands: a larger tile
//   reads fewer of them an output, where its registers allow), then the
//   epilogue, which no other block's products overlap.  So each block walks
//   a persistent run of tiles in one ring of kStages shared-memory stages of
//   32-deep slices, filled by 16-byte cp.async.cg copies, one
//   __syncthreads a slice: the next tile's first slices (and B9's next
//   slot's) are in flight during a tile's last products and its epilogue;
//   fragments by ldmatrix.x4 from rows padded to an odd number of 16 bytes;
//   x's tile prefetched to L2 as its products start; the sums staged in
//   shared memory so that x is read and written in 16-byte accesses, each
//   thread's loads of a batch before its stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fma_gemm.cuh"

namespace dlaf_split {

// products of a split with ns slices per operand
__host__ __device__ constexpr int nterms(int ns) { return ns * (ns + 1) / 2; }
// the slice of A and of B in term q (terms in the order they are added)
__host__ __device__ constexpr int term_a(int ns, int q) {
  return ns == 2 ? (q == 1 ? 1 : 0) : (q == 1 || q == 4) ? 1 : (q == 2 ? 2 : 0);
}
__host__ __device__ constexpr int term_b(int ns, int q) {
  return ns == 2 ? (q == 0 ? 1 : 0) : q == 0 ? 2 : (q == 1 || q == 3) ? 1 : 0;
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared memory is addressed by 32-bit shared-window addresses (ldmatrix,
// cp.async and the cut's 16-byte accesses).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// 16 bytes, of which the first `src_bytes` (16 or 0) are read through L2
// only and the rest zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t a, const uint32_t (&w)[4]) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(w[0]), "r"(w[1]),
               "r"(w[2]), "r"(w[3])
               : "memory");
}

// bf16(a), bf16(b), each rounded to nearest even: one cvt.rn.bf16x2.f32,
// which rounds each half as cvt.rn.bf16.f32 (__float2bfloat16_rn) does
__device__ __forceinline__ __nv_bfloat162 round2(float a, float b) {
  return __float22bfloat162_rn(make_float2(a, b));
}

// The 8 values v cut into NS bf16 slices, s0 = bf16(v), s1 = bf16(v - s0),
// s2 = bf16(v - s0 - s1), the residuals at T and a double rounded to float
// first; put(s, w) takes slice s's 8 values as 16 bytes as soon as they
// are cut.
template <typename T, int NS, typename Put>
__device__ __forceinline__ void cut8(T (&v)[8], Put&& put) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    uint32_t w[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const __nv_bfloat162 h =
          round2(static_cast<float>(v[2 * p]), static_cast<float>(v[2 * p + 1]));
      w[p] = (uint32_t)__bfloat16_as_ushort(h.x) | ((uint32_t)__bfloat16_as_ushort(h.y) << 16);
      if (s + 1 < NS) {
        v[2 * p] = v[2 * p] - static_cast<T>(__bfloat162float(h.x));
        v[2 * p + 1] = v[2 * p + 1] - static_cast<T>(__bfloat162float(h.y));
      }
    }
    put(s, w);
  }
}

// The 8 values of the group at shared address g cut into NS bf16 slices
// written over them, slice s's 8 values at g + 16 s (the group holds
// max(8 sizeof(T), 16 NS) bytes)
template <typename T, int NS>
__device__ __forceinline__ void cut_group(uint32_t g) {
  T v[8];
#pragma unroll
  for (int c = 0; c < (int)sizeof(T) / 2; ++c) {
    const uint4 w = lds128(g + 16 * c);
    if constexpr (sizeof(T) == 4) {
      v[4 * c] = __uint_as_float(w.x), v[4 * c + 1] = __uint_as_float(w.y);
      v[4 * c + 2] = __uint_as_float(w.z), v[4 * c + 3] = __uint_as_float(w.w);
    } else {
      v[2 * c] = __hiloint2double((int)w.y, (int)w.x);
      v[2 * c + 1] = __hiloint2double((int)w.w, (int)w.z);
    }
  }
  cut8<T, NS>(v, [&](int s, const uint32_t(&w)[4]) { sts128(g + 16 * s, w); });
}

// One output's terms added at T in their order: acc(q) is term q's
// float32 accumulator
template <typename T, int NS, typename Acc>
__device__ __forceinline__ T term_sum(Acc&& acc) {
  T sum = static_cast<T>(acc(0));
#pragma unroll
  for (int q = 1; q < nterms(NS); ++q) sum = sum + static_cast<T>(acc(q));
  return sum;
}

// ------------------------------------------------- B3-split and B9-split

// W values of T on W sizeof(T) bytes: one access
template <typename T, int W>
struct alignas(W * sizeof(T)) Vals {
  T v[W];
};

// The geometry of the planes at NS slices, and of the body's tile: 128 x 64
// (warps of 32 x 32, 96 accumulators a thread) or, kWide, 128 x 128 (warps
// of 64 x 32, 192) at NS = 2; 64 x 64 (warps of 32 x 16, 6 terms: 96) at
// NS = 3
template <int NS_, bool kWide = false>
struct Body {
  static constexpr int NS = NS_;
  static constexpr int kThreads = 256;
  static constexpr int kStages = 3;
  static constexpr int BK = 32;                      // a stage's depth; K is rounded up to it
  static constexpr int GB = 16 * NS;                 // bytes of a group of 8 k values: its slices
  static constexpr int RB = BK / 8 * GB;             // bytes of a stage's row of a plane
  static constexpr int CPR = RB / 16;                // its 16-byte copies
  static constexpr int SP = RB + 16;                 // a stage row: an odd number of 16 bytes
  static constexpr int MI = NS == 2 && kWide ? 4 : 2;   // m16 blocks a warp
  static constexpr int NI = NS == 2 ? 4 : 2;            // n8 blocks a warp
  static constexpr int WM = NS == 2 && !kWide ? 4 : 2;  // warps down the tile
  static constexpr int WN = kThreads / 32 / WM;         // warps across
  static constexpr int BM = WM * 16 * MI;
  static constexpr int BN = WN * 8 * NI;
  static constexpr int A_BYTES = BM * SP;
  static constexpr int STAGE = (BM + BN) * SP;
  static constexpr int SMEM_BYTES = kStages * STAGE;
  static constexpr int A_COPIES = BM * CPR / kThreads;  // a thread's copies of a stage
  static constexpr int B_COPIES = BN * CPR / kThreads;
  static_assert(BM * CPR % kThreads == 0 && BN * CPR % kThreads == 0, "whole rounds of copies");
};

// bytes of one plane row at depth K (K rounded up to 32)
template <int NS>
__host__ __device__ constexpr long long plane_pitch(int K) {
  return (long long)((K + Body<NS>::BK - 1) / Body<NS>::BK) * Body<NS>::RB;
}

// The pre-pass's item i of a K-contiguous source (`rows` rows of K): the
// group of 8 k values g of row i / groups, cut into its plane row; read in
// 16-byte loads where the caller has found every row on 16 bytes (vec)
template <typename T, int NS>
__device__ __forceinline__ void cut_item(unsigned char* __restrict__ plane, long long pitch,
                                         const T* __restrict__ src, int K, int groups,
                                         long long i, bool vec) {
  constexpr int W = 16 / (int)sizeof(T);
  const long long row = i / groups;
  const int g = (int)(i - row * groups);
  const T* p = src + row * K + g * 8;
  T v[8];
  if (vec && g * 8 + 8 <= K) {
#pragma unroll
    for (int c = 0; c < 8 / W; ++c) {
      const Vals<T, W> w = reinterpret_cast<const Vals<T, W>*>(p)[c];
#pragma unroll
      for (int e = 0; e < W; ++e) v[c * W + e] = w.v[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = g * 8 + e < K ? p[e] : T(0);
  }
  unsigned char* dst = plane + row * pitch + g * Body<NS>::GB;
  cut8<T, NS>(v, [&](int s, const uint32_t(&w)[4]) {
    *reinterpret_cast<uint4*>(dst + 16 * s) = make_uint4(w[0], w[1], w[2], w[3]);
  });
}

// The pre-pass's tile i of slots of K x N (the b of B3's jbc form and of
// B9): 32 k by 64 n of one slot, read along n into `tile` (32 x 65 values
// of shared memory), then each thread cuts the 8 k values of one group of
// one n into plane row slot * N + n, the 4 groups of a row side by side.
// Called by the whole block.
template <typename T, int NS>
__device__ __forceinline__ void cut_tile_kn(unsigned char* __restrict__ plane, long long pitch,
                                            const T* __restrict__ src, int K, int N,
                                            long long i, T (*tile)[65]) {
  const int nb = (N + 63) / 64, kb = (int)(pitch / Body<NS>::RB);
  const long long s = i / ((long long)kb * nb);
  const int rest = (int)(i - s * kb * nb), k0 = rest / nb * 32, n0 = rest % nb * 64;
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int r = tid / 64 + 4 * q, c = tid % 64, k = k0 + r, n = n0 + c;
    tile[r][c] = k < K && n < N ? src[(s * K + k) * N + n] : T(0);
  }
  __syncthreads();
  const int n = tid >> 2, g = tid & 3;
  if (n0 + n < N) {
    T v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = tile[g * 8 + e][n];
    unsigned char* dst = plane + (s * N + n0 + n) * pitch + (k0 / 8 + g) * Body<NS>::GB;
    cut8<T, NS>(v, [&](int q, const uint32_t(&w)[4]) {
      *reinterpret_cast<uint4*>(dst + 16 * q) = make_uint4(w[0], w[1], w[2], w[3]);
    });
  }
  __syncthreads();  // the tile is free for the next
}

// The output tiles of one launch and where their planes start: output
// slot o < O (M x N at x + o M N) sums over slots s < S the products of
// a's plane rows (o / od) a_outer + (o % od) a_inner + s sa + m and b's
// (o / od) b_outer + (o % od) b_inner + s sb + n, nk stages of 32 k deep,
// pitch bytes a plane row.
struct Job {
  int O, od, S, nk, M, N;
  long long a_outer, a_inner, b_outer, b_inner, sa, sb, pitch;
};

template <class G>
using Acc = float[nterms(G::NS)][G::MI][G::NI][4];

template <class G>
__device__ __forceinline__ void zero(Acc<G>& acc) {
#pragma unroll
  for (int q = 0; q < nterms(G::NS); ++q)
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[q][mi][ni][c] = 0.f;
}

// acc += the products of the stage at `st` (32 deep), its two k16 chunks in
// order, every term into its own accumulator.  b's fragments of a chunk are
// held for every n8 block, a's one slice of one m16 block at a time (the
// terms of that slice then).
template <class G>
__device__ __forceinline__ void compute_stage(Acc<G>& acc, uint32_t st) {
  constexpr int NS = G::NS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t a = st + ((warp % G::WM) * 16 * G::MI + (lane & 15)) * G::SP + (lane >> 4) * G::GB;
  const uint32_t b = st + G::A_BYTES +
                     ((warp / G::WM) * 8 * G::NI + (lane & 7) + ((lane >> 4) << 3)) * G::SP +
                     ((lane >> 3) & 1) * G::GB;
#pragma unroll
  for (int kc = 0; kc < G::BK / 16; ++kc) {
    uint32_t bf[NS][G::NI][2];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int nb = 0; nb < G::NI / 2; ++nb) {
        uint32_t r[4];
        ldsm_x4(r, b + nb * 16 * G::SP + 2 * kc * G::GB + 16 * s);
        bf[s][2 * nb][0] = r[0], bf[s][2 * nb][1] = r[1];
        bf[s][2 * nb + 1][0] = r[2], bf[s][2 * nb + 1][1] = r[3];
      }
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int sa = 0; sa < NS; ++sa) {
        uint32_t af[4];
        ldsm_x4(af, a + mi * 16 * G::SP + 2 * kc * G::GB + 16 * sa);
#pragma unroll
        for (int q = 0; q < nterms(NS); ++q)
          if (term_a(NS, q) == sa)
#pragma unroll
            for (int ni = 0; ni < G::NI; ++ni) mma(acc[q][mi][ni], af, bf[term_b(NS, q)][ni]);
      }
  }
}

// x's lines of the tile at (m0, n0) to L2, by the whole block: issued as
// the tile's products start, so that its epilogue's loads find them there
template <typename T, class G>
__device__ __forceinline__ void prefetch_x(const T* __restrict__ x, int M, int N, int m0, int n0) {
  constexpr int LPR = G::BN * (int)sizeof(T) / 128 + 1;  // lines a row may touch
  const int bytes = min(G::BN, N - n0) * (int)sizeof(T);
#pragma unroll 1
  for (int p = threadIdx.x; p < G::BM * LPR; p += G::kThreads) {
    const int r = p / LPR;
    if (m0 + r >= M) break;
    const char* row = reinterpret_cast<const char*>(x + (long long)(m0 + r) * N + n0);
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row + min(128 * (p - r * LPR), bytes - 1)));
  }
}

// The epilogue's staging of a tile's sums in shared memory, after the
// stages: ROWS rows a round (half the tile where a whole one would not fit
// beside the stages), each padded by 8 values (a quarter warp's pairs of
// one row fill 32 or 64 bytes: the 8 rows of a warp's write take the least
// wavefronts)
template <typename T, class G>
struct Out {
  static constexpr int LD = G::BN + 8;
  static constexpr int ROWS = G::BM * LD * (int)sizeof(T) > 81920 ? G::BM / 2 : G::BM;
  static constexpr int BYTES = ROWS * LD * (int)sizeof(T);
};

// x[m][n] -= the staged sums (kSub) or x[m][n] = them, for rows [r0, r0 +
// ROWS) of the tile at (m0, n0), W columns a thread at a time, in batches
// of 8 accesses a thread: a batch's loads of x all before its stores
template <typename T, class G, bool kSub, int W>
__device__ __forceinline__ void put_rows(T* __restrict__ x, int M, int N, int m0, int n0, int r0,
                                         const T* out) {
  using O = Out<T, G>;
  using V = Vals<T, W>;
  constexpr int PR = G::BN / W, J = O::ROWS * PR / G::kThreads, JB = J < 8 ? J : 8;
  static_assert(O::ROWS * PR % G::kThreads == 0 && J % JB == 0, "whole rounds of the block");
#pragma unroll 1
  for (int q0 = 0; q0 < J; q0 += JB) {
    V xv[JB];
#pragma unroll
    for (int q = 0; q < JB; ++q) {
      const int i = threadIdx.x + (q0 + q) * G::kThreads, r = i / PR, c = (i - r * PR) * W;
      const int m = m0 + r0 + r, n = n0 + c;
      if constexpr (kSub)
        if (m < M && n < N) xv[q] = *reinterpret_cast<const V*>(x + (long long)m * N + n);
    }
#pragma unroll
    for (int q = 0; q < JB; ++q) {
      const int i = threadIdx.x + (q0 + q) * G::kThreads, r = i / PR, c = (i - r * PR) * W;
      const int m = m0 + r0 + r, n = n0 + c;
      if (m >= M || n >= N) continue;
      V v = *reinterpret_cast<const V*>(out + r * O::LD + c);
      if constexpr (kSub)
#pragma unroll
        for (int e = 0; e < W; ++e) v.v[e] = xv[q].v[e] - v.v[e];
      *reinterpret_cast<V*>(x + (long long)m * N + n) = v;
    }
  }
}

// The terms added at T in their order, then x[m * N + n] -= sum (kSub) or
// x[m * N + n] = sum, over the tile's in-range elements.  The block stages
// the sums in `out` (Out<T, G>::BYTES of shared memory) and reads x and
// writes it in 16-byte accesses where every row of x lies on 16 bytes,
// else one value at a time.
template <typename T, class G, bool kSub>
__device__ __forceinline__ void store(T* __restrict__ x, int M, int N, int m0, int n0,
                                      const Acc<G>& acc, T* out) {
  using O = Out<T, G>;
  constexpr int W = 16 / (int)sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = (warp % G::WM) * 16 * G::MI;  // the warp's first row in the tile
  const int cn = (warp / G::WM) * 8 * G::NI + 2 * (lane & 3);
  const bool vec = reinterpret_cast<unsigned long long>(x) % 16 == 0 && N % W == 0;
#pragma unroll
  for (int r0 = 0; r0 < G::BM; r0 += O::ROWS) {
    if (wr >= r0 && wr < r0 + O::ROWS) {
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni) {
            Vals<T, 2> v;
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v.v[e] = term_sum<T, G::NS>([&](int q) { return acc[q][mi][ni][2 * h + e]; });
            const int r = wr - r0 + mi * 16 + (lane >> 2) + 8 * h;
            *reinterpret_cast<Vals<T, 2>*>(out + r * O::LD + cn + ni * 8) = v;
          }
    }
    __syncthreads();
    if (vec)
      put_rows<T, G, kSub, W>(x, M, N, m0, n0, r0, out);
    else
      put_rows<T, G, kSub, 1>(x, M, N, m0, n0, r0, out);
    __syncthreads();  // the staging is free again
  }
}

// Every output tile of job j: block b takes the tiles b, b + gridDim.x, ...
// (tile g: column block g % tiles_n, then row block, then output slot) in
// one pipeline over its (tile, slot, stage) slices, the copies of a tile's
// first slices in flight during the previous tile's last products and
// epilogue.  For each tile acc = the split product summed over its slots
// and stages (rows m >= M and n >= N read as zero), then stored (store).
// `smem` holds G::SMEM_BYTES (the stages), then Out<T, G>::BYTES (the
// epilogue's staging); every thread of the block calls this.  The
// launcher has checked that the block's slices count fits an int.
template <typename T, class G, bool kSub>
__device__ __forceinline__ void run(T* __restrict__ x, const unsigned char* __restrict__ pa,
                                    const unsigned char* __restrict__ pb, const Job& j,
                                    unsigned char* smem) {
  const int tid = threadIdx.x;
  const uint32_t sm = dlaf_fma::smem_addr(smem);
  T* out = reinterpret_cast<T*>(smem + G::SMEM_BYTES);
  const int tiles_n = (j.N + G::BN - 1) / G::BN, tiles_m = (j.M + G::BM - 1) / G::BM;
  const long long ntiles = (long long)j.O * tiles_m * tiles_n;
  const int mine = ntiles > blockIdx.x ? (int)((ntiles - 1 - blockIdx.x) / gridDim.x) + 1 : 0;
  const int per = j.S * j.nk;  // slices a tile
  const int total = mine * per;
  // this block's tile i: its output slot and first row and column
  auto tile = [&](int i, long long& o, int& m0, int& n0) {
    long long g = blockIdx.x + (long long)i * gridDim.x;
    n0 = (int)(g % tiles_n) * G::BN;
    g /= tiles_n;
    m0 = (int)(g % tiles_m) * G::BM;
    o = g / tiles_m;
  };
  Acc<G> acc;
  zero<G>(acc);
  if (per == 0) {  // K = 0: every sum is +0
    for (int i = 0; i < mine; ++i) {
      long long o;
      int m0, n0;
      tile(i, o, m0, n0);
      store<T, G, kSub>(x + o * j.M * (long long)j.N, j.M, j.N, m0, n0, acc, out);
    }
    return;
  }

  // the copies: the next slice's tile li, slot ls and stage lk, its stage
  // in the ring, and the first rows of the tile's current slot in a and b
  // (rows past vm and vn read as zero)
  int li = 0, ls = 0, lk = 0, ring = 0, vm = 0, vn = 0;
  const unsigned char *ta = pa, *tb = pb;
  auto start_tile = [&](int i) {
    long long o;
    int m0, n0;
    tile(i, o, m0, n0);
    const long long oo = o / j.od, oi = o - oo * j.od;
    ta = pa + (oo * j.a_outer + oi * j.a_inner + m0) * j.pitch;
    tb = pb + (oo * j.b_outer + oi * j.b_inner + n0) * j.pitch;
    vm = j.M - m0, vn = j.N - n0;
  };
  // start the copy of the next slice into its stage: a thread copies 16
  // bytes of rows (tid + p kThreads) / CPR, a's rows first; past the end
  // an empty group keeps the count of groups in step
  auto issue = [&]() {
    if (li < mine) {
      const uint32_t st = sm + ring * G::STAGE;
      const unsigned char* as = ta + lk * G::RB;
      const unsigned char* bs = tb + lk * G::RB;
#pragma unroll
      for (int p = 0; p < G::A_COPIES; ++p) {
        const int c = tid + p * G::kThreads, r = c / G::CPR, u = c - r * G::CPR;
        const bool ok = r < vm;
        cp_async16(st + r * G::SP + u * 16, ok ? as + r * j.pitch + u * 16 : pa, ok ? 16 : 0);
      }
#pragma unroll
      for (int p = 0; p < G::B_COPIES; ++p) {
        const int c = tid + p * G::kThreads, r = c / G::CPR, u = c - r * G::CPR;
        const bool ok = r < vn;
        cp_async16(st + G::A_BYTES + r * G::SP + u * 16, ok ? bs + r * j.pitch + u * 16 : pb,
                   ok ? 16 : 0);
      }
      if (++lk == j.nk) {
        lk = 0;
        ta += j.sa * j.pitch, tb += j.sb * j.pitch;
        if (++ls == j.S) {
          ls = 0;
          if (++li < mine) start_tile(li);
        }
      }
    }
    if (++ring == G::kStages) ring = 0;
    dlaf_fma::cp_async_commit();
  };

  if (mine > 0) start_tile(0);
  for (int t = 0; t < G::kStages - 1; ++t) issue();
  int ci = 0, cs = 0, cring = 0;  // the tile being computed, its slices done, their stage
  for (int t = 0; t < total; ++t) {
    if (cs == 0 && kSub) {
      long long o;
      int m0, n0;
      tile(ci, o, m0, n0);
      prefetch_x<T, G>(x + o * j.M * (long long)j.N, j.M, j.N, m0, n0);
    }
    dlaf_fma::cp_async_wait<G::kStages - 2>();  // this thread's copies of slice t have landed
    __syncthreads();  // everyone's have, and everyone is done with slice t - 1's stage
    issue();          // into slice t - 1's stage
    compute_stage<G>(acc, sm + cring * G::STAGE);
    if (++cring == G::kStages) cring = 0;
    if (++cs == per) {
      long long o;
      int m0, n0;
      tile(ci, o, m0, n0);
      store<T, G, kSub>(x + o * j.M * (long long)j.N, j.M, j.N, m0, n0, acc, out);
      zero<G>(acc);
      cs = 0, ++ci;
    }
  }
}

}  // namespace dlaf_split
