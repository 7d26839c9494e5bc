// Panel triangular solve X op(L) = B, Right / Lower / op in {T, C} /
// non-unit, real (op C is op T).
//
// Replaces dlaf_tpu/ops/pallas_panel_trsm.py (panel_trsm_right_lower_t /
// _kernel).  Rows of X are independent:
//   x[r, j] = (b[r, j] - sum_{s<j} x[r, s] * L[j, s]) / L[j, j].
//
// What bounds it on the H100: operations.  At the main path's shape
// (15872 x 512 f32) the solve is 4.2 GFlop over 66 MB.  The TPU kernel
// keeps the whole factor in VMEM; at nb=512 the f32 factor is 1 MiB, above
// a block's 227 KB of shared memory, so L is read through the L2 cache,
// staged 32 x 32 at a time.  Each block owns a strip of R rows (32 for f32,
// 16 for f64) held in shared memory and follows the TPU kernel's W=32
// column-blocked schedule:
//   for each 32-wide column block:
//     GEMM: x[r, blk] -= x[r, <c0] @ L[blk, <c0]^T  (warp = rows, lane = column)
//     substitution inside the block, one thread per row.
// Only the lower triangle of L is read.  The caller owns X.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kW = 32;
constexpr int kLd = kW + 1;

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
panel_trsm_kernel(const T* __restrict__ ell, const T* __restrict__ b, T* __restrict__ x,
                  long long rows, int nb) {
  extern __shared__ unsigned char smem_raw[];
  const int ldx = nb + 1;
  T* xs = reinterpret_cast<T*>(smem_raw);  // [R][nb + 1]: the strip, b then x
  T* ls = xs + R * ldx;                    // [32][33]: a staged block of L
  constexpr int kRowsPerWarp = R / (kThreads / 32);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * R;
  const int nrows = (int)min((long long)R, rows - r0);

  for (int idx = tid; idx < R * nb; idx += kThreads) {
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
      for (int idx = tid; idx < kW * kW; idx += kThreads) {
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
    for (int idx = tid; idx < kW * kW; idx += kThreads) {
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

  for (int idx = tid; idx < nrows * nb; idx += kThreads) {
    const int r = idx / nb, c = idx % nb;
    x[(r0 + r) * nb + c] = xs[r * ldx + c];
  }
}

template <typename T, int R>
int launch_panel_trsm(const void* ell, const void* b, void* x, long long rows, int nb,
                      void* stream) {
  if (rows <= 0) return 0;
  if (nb <= 0 || nb % kW) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)R * (nb + 1) + (size_t)kW * kLd) * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(panel_trsm_kernel<T, R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (rows + R - 1) / R;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  panel_trsm_kernel<T, R><<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ell), static_cast<const T*>(b), static_cast<T*>(x), rows, nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dlaf_panel_trsm_f32(const void* ell, const void* b, void* x, long long rows, int nb,
                        void* stream) {
  return launch_panel_trsm<float, 32>(ell, b, x, rows, nb, stream);
}

int dlaf_panel_trsm_f64(const void* ell, const void* b, void* x, long long rows, int nb,
                        void* stream) {
  return launch_panel_trsm<double, 16>(ell, b, x, rows, nb, stream);
}

}  // extern "C"
