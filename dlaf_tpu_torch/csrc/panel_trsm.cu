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
// Only the lower triangle of L is read.  The caller owns X.  The strip
// body lives in panel_trsm.cuh, which the fused factor-and-send kernel
// (panel_exchange.cu, B7) shares.

#include <cuda_runtime.h>

#include "panel_trsm.cuh"

namespace {

constexpr int kThreads = 256;
using dlaf_panel_trsm::kW;

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
panel_trsm_kernel(const T* __restrict__ ell, const T* __restrict__ b, T* __restrict__ x,
                  long long rows, int nb) {
  extern __shared__ unsigned char smem_raw[];
  dlaf_panel_trsm::solve_strip<T, R, kThreads>(ell, b, x, rows, nb, blockIdx.x,
                                               reinterpret_cast<T*>(smem_raw));
}

template <typename T, int R>
int launch_panel_trsm(const void* ell, const void* b, void* x, long long rows, int nb,
                      void* stream) {
  if (rows <= 0) return 0;
  if (nb <= 0 || nb % kW) return (int)cudaErrorInvalidValue;
  const size_t smem = dlaf_panel_trsm::smem_bytes<T, R>(nb);
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
