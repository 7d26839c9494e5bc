// The strip bodies of the panel-TRSM kernel (B2).
//
// solve_strip: the first body, the body of B2's reference kernel
// (csrc/panel_trsm.cu, panel_trsm_reference) only: no main-path kernel runs
// it.  Every row's arithmetic is the same whatever the block size NT.
//
// solve_rows: the Hopper body B2 launches (csrc/panel_trsm.cu), and B7 and
// B8's tail run on any run of rows (csrc/factor_send.cuh), bit for bit
// solve_strip.  Every element x[r, j] (j = c0 + t, c0 = 32 * (j / 32)) is
//   acc = one FMA chain from +0 over s < c0, s ascending;
//   v = b[r, j] - acc;
//   contrib = one FMA chain from +0 over c0 <= s < j, s ascending;
//   x[r, j] = (v - contrib) / L[j, j]  (IEEE division)
// as solve_strip computes it (nvcc contracts its `acc += x * l` into FMAs),
// here with explicit __fmaf_rn / __fma_rn.  See panel_trsm.cu for the
// design.
#pragma once

#include <cuda_runtime.h>

#include "fma_gemm.cuh"

namespace dlaf_panel_trsm {

constexpr int kW = 32;
constexpr int kLd = kW + 1;

// shared memory of one strip solve: the strip [R][nb + 1] and a staged
// 32 x 32 block of L
template <typename T, int R>
__host__ __device__ inline size_t smem_bytes(int nb) {
  return ((size_t)R * (nb + 1) + (size_t)kW * kLd) * sizeof(T);
}

// Solve rows [strip * R, strip * R + R) of X op(L) = B by one block of NT
// threads; smem holds smem_bytes<T, R>(nb).
template <typename T, int R, int NT>
__device__ void solve_strip(const T* __restrict__ ell, const T* __restrict__ b,
                            T* __restrict__ x, long long rows, int nb, long long strip,
                            T* smem) {
  const int ldx = nb + 1;
  T* xs = smem;             // [R][nb + 1]: the strip, b then x
  T* ls = xs + R * ldx;     // [32][33]: a staged block of L
  constexpr int kWarps = NT / 32;
  constexpr int kRowsPerWarp = R / kWarps;
  static_assert(kRowsPerWarp >= 1 && R % kWarps == 0, "R must be a multiple of NT / 32");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = strip * R;
  const int nrows = (int)min((long long)R, rows - r0);

  for (int idx = tid; idx < R * nb; idx += NT) {
    const int r = idx / nb, c = idx % nb;
    xs[r * ldx + c] = r < nrows ? b[(r0 + r) * nb + c] : T(0);
  }
  __syncthreads();

  for (int c0 = 0; c0 < nb; c0 += kW) {
    // GEMM update of column block c0 from the solved columns s < c0
    T acc[kRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = T(0);
    for (int s0 = 0; s0 < c0; s0 += kW) {
      for (int idx = tid; idx < kW * kW; idx += NT) {
        const int t = idx / kW, s = idx % kW;
        ls[t * kLd + s] = ell[(long long)(c0 + t) * nb + s0 + s];
      }
      __syncthreads();
#pragma unroll 8
      for (int s = 0; s < kW; ++s) {
        const T l = ls[lane * kLd + s];
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q)
          acc[q] += xs[(warp * kRowsPerWarp + q) * ldx + s0 + s] * l;
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q)
      xs[(warp * kRowsPerWarp + q) * ldx + c0 + lane] -= acc[q];

    // diagonal block of L, then the substitution within it
    for (int idx = tid; idx < kW * kW; idx += NT) {
      const int t = idx / kW, s = idx % kW;
      ls[t * kLd + s] = ell[(long long)(c0 + t) * nb + c0 + s];
    }
    __syncthreads();
    if (tid < R) {
      T* xr = xs + tid * ldx + c0;
      for (int t = 0; t < kW; ++t) {
        T contrib = T(0);
        for (int s = 0; s < t; ++s) contrib += xr[s] * ls[t * kLd + s];
        xr[t] = (xr[t] - contrib) / ls[t * kLd + t];
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nrows * nb; idx += NT) {
    const int r = idx / nb, c = idx % nb;
    x[(r0 + r) * nb + c] = xs[r * ldx + c];
  }
  __syncthreads();  // the strip's shared memory may be reused at once
}

// ------------------------------------------------------ solve_rows (Hopper)

// A pack of N elements, loaded and stored as one access of up to 16 bytes.
template <typename T, int N>
struct alignas(N * sizeof(T) < 16 ? N * sizeof(T) : 16) Pack {
  T v[N];
};

// The geometry of one stage (a slab of L): KS columns of L, every row from
// the current column block's first down to nb, each row padded to 80 bytes
// (an odd number of 16-byte units, so the 8 lanes of a quarter warp reading
// 16 bytes of 8 consecutive rows hit 8 distinct bank groups).
template <typename T>
struct Slab {
  static constexpr int V = 16 / (int)sizeof(T);   // elements in 16 bytes
  static constexpr int KS = 64 / (int)sizeof(T);  // columns a slab: 16 f32, 8 f64
  static constexpr int LD = KS + V;               // a staged row
  static_assert(kW % KS == 0, "a column block is a whole number of slabs");
};

// shared memory of solve_rows: two slabs of nb rows, and each warp's
// [32][RW] of solved x of the current slab
template <typename T, int RW>
__host__ __device__ inline size_t rows_smem_bytes(int nb, int warps) {
  return (2 * (size_t)nb * Slab<T>::LD + (size_t)warps * kW * RW) * sizeof(T);
}

// Start the copy of slab g (rows [32 k, nb) x columns [KS g, KS g + KS) of
// L, k = KS g / 32) into `dst`, by every thread of the block; one commit
// group.  vec: L's base is 16-byte aligned (its rows then are: nb % 32 == 0).
// A thread copies one 16-byte column (one element) of every blockDim.x /
// CH-th row (of every blockDim.x / KS-th row).
template <typename T>
__device__ __forceinline__ void issue_slab(const T* __restrict__ ell, int nb, int g, bool vec,
                                           T* dst) {
  using S = Slab<T>;
  const int c0 = g * S::KS, row0 = c0 / kW * kW, nr = nb - row0;
  const int per_row = vec ? S::KS / S::V : S::KS;  // copies a row
  const int c = threadIdx.x % per_row * (vec ? S::V : 1), step = blockDim.x / per_row;
  const T* src = ell + (long long)(row0 + threadIdx.x / per_row) * nb + c0 + c;
  T* to = dst + threadIdx.x / per_row * S::LD + c;
  for (int r = threadIdx.x / per_row; r < nr;
       r += step, src += (long long)step * nb, to += step * S::LD) {
    if (vec)
      dlaf_fma::cp_async16(to, src, 16);
    else
      dlaf_fma::cp_async_elem<sizeof(T)>(to, src, sizeof(T));
  }
  dlaf_fma::cp_async_commit();
}

// x = RN(a / d), the IEEE quotient, with d fixed ahead of a.  In f32: by
// one f64 product with RN64(1 / d), within 2^-52 of a / d relatively.  A
// normal or infinite quotient of two floats is never a midpoint between two
// floats (a midpoint's significand is 25 bits and odd) and, when not a
// float itself, lies more than 2^-49 from every midpoint, relatively, so
// rounding the product to float gives RN(a / d).  Below FLT_MIN it need
// not: a quotient can be a midpoint (a / 98 = K * 2^-150, K odd) that the
// product misses.  So `of` also says whether the product was a nonzero
// magnitude under FLT_MIN, by the high word of its bits (a nonzero product
// is at least 2^-277, never below 2^-1022; a zero product is the quotient
// of a = 0, or of an infinite d, sign included), and solve_rows solves a
// warp's rows again by the division where any kept quotient was
// (solve_row_exact).  No division is left on the substitution's chain, and
// no branch: every lane computes, lane s keeps.  A NaN's payload may
// differ.  In f64 (no wider type) the division itself.
template <typename T>
struct Divisor;
template <>
struct Divisor<float> {
  double r;
  __device__ __forceinline__ explicit Divisor(float d) : r(1.0 / (double)d) {}
  __device__ __forceinline__ float of(float a, bool& tiny) const {
    const double p = (double)a * r;
    // 2^-1022 <= |p| < 2^-126
    tiny = 2u * (unsigned)__double2hiint(p) - 0x00200000u < 0x70000000u;
    return (float)p;
  }
};
template <>
struct Divisor<double> {
  double d;
  __device__ __forceinline__ explicit Divisor(double d_) : d(d_) {}
  __device__ __forceinline__ double of(double a, bool& tiny) const {
    tiny = false;
    return a / d;
  }
};

// Row r of X op(L) = B solved by one warp in the arithmetic of solve_rows,
// every quotient by the IEEE division (__fdiv_rn in f32), L, b and the row's
// solved columns read from device memory: lane t owns column c0 + t of each
// column block, acc and contrib are the same FMA chains in the same order.
// The rare path of a warp that met a quotient below FLT_MIN; slow.
template <typename T>
__device__ __forceinline__ void solve_row_exact(const T* __restrict__ ell,
                                                const T* __restrict__ b, T* __restrict__ x,
                                                long long r, int nb) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < nb; c0 += kW) {
    const T* lj = ell + (long long)(c0 + lane) * nb;
    T acc = T(0);
    for (int s = 0; s < c0; ++s) acc = dlaf_fma::madd(x[r * nb + s], lj[s], acc);
    const T v = __ldcg(b + r * nb + c0 + lane) - acc;
    T contrib = T(0), xt = T(0);
    for (int sp = 0; sp < kW; ++sp) {
      if (lane == sp) {
        if constexpr (sizeof(T) == 4)
          xt = __fdiv_rn(v - contrib, lj[c0 + lane]);
        else
          xt = (v - contrib) / lj[c0 + lane];
      }
      const T xs = __shfl_sync(0xffffffffu, xt, sp);
      if (lane > sp) contrib = dlaf_fma::madd(xs, lj[c0 + sp], contrib);
    }
    x[r * nb + c0 + lane] = xt;
    __syncwarp();  // the block's x, read by every lane for the next acc
  }
}

// Solve rows [row0 + warp * RW, + RW) of X op(L) = B (row0: the first row
// of this block's run; rows < `rows` only): each
// warp owns RW rows and keeps, in registers, every later column block's acc
// of its rows (lane t holds column 32 j + t of block j, j < NKB, nb <= 32
// NKB); the block shares L, streamed slab by slab through two stages by
// cp.async.  Per slab g (columns c0 .. c0 + KS of column block k):
//   at a block's first slab: v = b - acc[k], contrib = 0;
//   substitution, KS steps s: lane s divides, __shfl_sync hands x[s] to the
//     warp, lanes t > s add x[s] L[t][s] to contrib;
//   the slab's x go to the warp's [32][RW] buffer, and every later block
//     j > k takes acc[j] += x[s] L[32 j + lane][s] for the slab's s, in
//     ascending s (a broadcast read of x, a 16-byte read of L per lane);
//   at a block's last slab, lane t writes x[r][32 k + t] (coalesced).
// A warp one of whose kept f32 quotients was under FLT_MIN then solves its
// rows again by solve_row_exact (see Divisor).
// smem holds rows_smem_bytes<T, RW>(nb, blockDim.x / 32).
template <typename T, int NKB, int RW>
__device__ void solve_rows(const T* __restrict__ ell, const T* __restrict__ b,
                           T* __restrict__ x, long long rows, int nb, bool vec, T* smem,
                           long long row0) {
  using S = Slab<T>;
  constexpr int V = S::V, KS = S::KS, LD = S::LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  T* stage[2] = {smem, smem + (size_t)nb * LD};
  T* xb = smem + 2 * (size_t)nb * LD + (size_t)warp * kW * RW;  // [32][RW]
  const int nkb = nb / kW, nslabs = nb / KS;
  const long long r0 = row0 + (long long)warp * RW;

  T acc[RW][NKB];
#pragma unroll
  for (int q = 0; q < RW; ++q)
#pragma unroll
    for (int j = 0; j < NKB; ++j) acc[q][j] = T(0);
  T bnext[RW], v[RW], contrib[RW];
  bool tiny = false;  // a kept quotient the product may not round as the division
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    bnext[q] = r0 + q < rows ? __ldcg(b + (r0 + q) * nb + lane) : T(0);
    v[q] = contrib[q] = T(0);
  }

  issue_slab(ell, nb, 0, vec, stage[0]);
  for (int g = 0; g < nslabs; ++g) {
    const int k = g * KS / kW, o = g * KS % kW;
    dlaf_fma::cp_async_wait<0>();  // this thread's copies of slab g have landed
    __syncthreads();               // everyone's have, and slab g - 1's stage is free
    if (g + 1 < nslabs) issue_slab(ell, nb, g + 1, vec, stage[(g + 1) & 1]);
    const T* sl = stage[g & 1];

    if (o == 0) {  // column block k starts: v = b - acc[k]
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        T a = T(0);
#pragma unroll
        for (int j = 0; j < NKB; ++j)
          if (j == k) a = acc[q][j];
        v[q] = bnext[q] - a;
        contrib[q] = T(0);
      }
      if (k + 1 < nkb) {
#pragma unroll
        for (int q = 0; q < RW; ++q)
          bnext[q] = r0 + q < rows ? __ldcg(b + (r0 + q) * nb + (k + 1) * kW + lane) : T(0);
      }
    }

    // substitution: lane t's row of the diagonal block, this slab's columns
    T lrow[KS];
#pragma unroll
    for (int m = 0; m < KS / V; ++m) {
      const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(sl + lane * LD + m * V);
#pragma unroll
      for (int u = 0; u < V; ++u) lrow[m * V + u] = p.v[u];
    }
    // lane t's diagonal L[t][t], where this slab holds it (o <= t < o + KS)
    const Divisor<T> dv(sl[lane * LD + min(max(lane - o, 0), KS - 1)]);
#pragma unroll
    for (int sp = 0; sp < KS; ++sp) {
      const int s = o + sp;
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          bool t;
          const T xq = dv.of(v[q] - contrib[q], t);
          v[q] = lane == s ? xq : v[q];
          tiny |= lane == s && t;
        }
      } else if (lane == s) {  // the f64 division's slow path on lanes whose d is no divisor
        bool t;
#pragma unroll
        for (int q = 0; q < RW; ++q) v[q] = dv.of(v[q] - contrib[q], t);
      }
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        const T xs = __shfl_sync(0xffffffffu, v[q], s);
        if (lane > s) contrib[q] = dlaf_fma::madd(xs, lrow[sp], contrib[q]);
      }
    }
    if (lane >= o && lane < o + KS) {
      Pack<T, RW> p;
#pragma unroll
      for (int q = 0; q < RW; ++q) p.v[q] = v[q];
      *reinterpret_cast<Pack<T, RW>*>(xb + lane * RW) = p;
    }
    __syncwarp();

    // the later column blocks j > k, s ascending over the slab
#pragma unroll 1
    for (int m = 0; m < KS / V; ++m) {
      Pack<T, RW> xv[V];
#pragma unroll
      for (int u = 0; u < V; ++u)
        xv[u] = *reinterpret_cast<const Pack<T, RW>*>(xb + (o + m * V + u) * RW);
#pragma unroll
      for (int j = 0; j < NKB; ++j) {
        if (j > k && j < nkb) {
          const Pack<T, V> l =
              *reinterpret_cast<const Pack<T, V>*>(sl + ((j - k) * kW + lane) * LD + m * V);
#pragma unroll
          for (int u = 0; u < V; ++u)
#pragma unroll
            for (int q = 0; q < RW; ++q)
              acc[q][j] = dlaf_fma::madd(xv[u].v[q], l.v[u], acc[q][j]);
        }
      }
    }

    if (o + KS == kW) {  // column block k is solved
#pragma unroll
      for (int q = 0; q < RW; ++q)
        if (r0 + q < rows) x[(r0 + q) * nb + k * kW + lane] = v[q];
    }
  }
  if (__any_sync(0xffffffffu, tiny)) {  // no barrier follows: the warp may go alone
#pragma unroll 1
    for (int q = 0; q < RW; ++q)
      if (r0 + q < rows) solve_row_exact(ell, b, x, r0 + q, nb);
  }
}

}  // namespace dlaf_panel_trsm
