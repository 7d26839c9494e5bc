// The strip body of the panel-TRSM kernel (B2), shared by csrc/panel_trsm.cu
// and the fused factor-and-send kernel of csrc/panel_exchange.cu (B7), as
// the TPU's fused kernel composes pallas_panel_trsm._kernel.  See
// panel_trsm.cu for what it computes and why it is staged this way.  Every
// row's arithmetic is the same whatever the block size NT, so both kernels
// give the same bits.
#pragma once

#include <cuda_runtime.h>

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

}  // namespace dlaf_panel_trsm
