// Cholesky of one (n, n) real tile, lower factor, on one thread block.
//
// Replaces dlaf_tpu/ops/pallas_potrf.py (potrf_tile / _potrf_kernel): the
// tile is hermitized from its lower triangle (only the lower triangle is
// read), the result is the lower factor with the upper triangle zero, and
// a non-positive pivot poisons the factor with NaN exactly as the TPU
// kernel's 1/sqrt does.
//
// What bounds it on the H100: n sequential pivot steps.  An n=512 f32 tile
// is 44.7 MFlop over 2 MiB, a few microseconds of the card at its peaks,
// but each column depends on the one before it.  The TPU kernel keeps the
// whole tile in VMEM; here the tile (1 MiB at n=512 f32) is far above a
// block's 227 KB of shared memory, so the design is blocked right-looking:
//   for each column panel of width pw (32, or 16/8 when a 32-wide panel of
//   the tile does not fit in shared memory):
//     load the panel (rows c0..n-1) into shared memory,
//     factor it there column by column (one __syncthreads() per step),
//     write it back, and subtract its rank-pw product from the trailing
//     lower triangle, which stays in device memory (L2-resident).
// The block body lives in potrf.cuh, which the fused factor-and-send
// kernel (panel_exchange.cu, B7) shares.  The caller owns the output
// buffer; nothing is allocated here.

#include <cuda_runtime.h>

#include "potrf.cuh"

namespace {

constexpr int kThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kThreads)
potrf_kernel(const T* __restrict__ a, T* __restrict__ out, int n, int pw) {
  extern __shared__ unsigned char smem_raw[];
  dlaf_potrf::factor_tile<T, kThreads>(a, out, n, pw, reinterpret_cast<T*>(smem_raw));
}

template <typename T>
int launch_potrf(const void* a, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int pw = dlaf_potrf::panel_width<T>(n);
  if (pw == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = dlaf_potrf::smem_bytes<T>(n);
  cudaError_t e = cudaFuncSetAttribute(potrf_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  potrf_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(out), n, pw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dlaf_potrf_f32(const void* a, void* out, int n, void* stream) {
  return launch_potrf<float>(a, out, n, stream);
}

int dlaf_potrf_f64(const void* a, void* out, int n, void* stream) {
  return launch_potrf<double>(a, out, n, stream);
}

const char* dlaf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
