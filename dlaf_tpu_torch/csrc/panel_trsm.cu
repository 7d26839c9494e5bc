// Panel triangular solve X op(L) = B, Right / Lower / op in {T, C} /
// non-unit, real (op C is op T).
//
// Replaces dlaf_tpu/ops/pallas_panel_trsm.py (panel_trsm_right_lower_t /
// _kernel).  Rows of X are independent:
//   x[r, j] = (b[r, j] - sum_{s<j} x[r, s] * L[j, s]) / L[j, j],
// in the TPU kernel's W=32 column blocks: per block, a GEMM update from the
// solved blocks, then a 32-step substitution within the block.  Only the
// lower triangle of L is read.  The caller owns X.
//
// What bounds it on the H100: operations.  At the main path's tallest
// panel (15872 x 512 f32) the solve is 4.2 GFlop over 66 MB; the mean panel
// of path A is half as tall, the shortest 512 rows.  The TPU kernel keeps
// the whole factor in VMEM; at nb=512 the f32 factor is 1 MiB, above a
// block's 227 KB of shared memory, so L is read through the L2 cache.
//
// The kernel B2 launches (panel_trsm_rows_kernel, body solve_rows in
// panel_trsm.cuh) is built so that no strip waits on its own latency:
// - a warp owns RW rows (4 in f32, 2 in f64 up to nb=512) and keeps every
//   later column block's GEMM sum of them in registers (lane t: column
//   32 j + t), growing them right-looking, in ascending s, as each column
//   block is solved: per 16-byte read of L (4 columns of s, f32) a lane
//   does 16 FMAs, per broadcast read of x 16;
// - the substitution runs on every lane: lane t is column t of the block,
//   lane s keeps its quotient and __shfl_sync hands x[s] to the warp, so a
//   row's chain is 32 steps a block, and each warp carries RW rows at once;
//   in f32 the quotient is one f64 product with the divisor's reciprocal,
//   which gives the IEEE quotient's bits wherever it is normal; a warp that
//   kept a quotient under FLT_MIN solves its rows again by the division
//   (panel_trsm.cuh, Divisor, solve_row_exact): an IEEE
//   division on that chain, with its divergent slow-path branch, made each
//   row's 4 divisions a step run one after another;
// - L is streamed in slabs of 64 bytes of columns (every row from the
//   current block down) through two shared-memory stages by cp.async, the
//   next slab in flight while this one is used, one __syncthreads a slab;
// - b is read and x written straight from and to device memory, 128
//   coalesced bytes a warp and row, b one column block ahead;
// - the launcher gives a block 1, 2, 4 or 8 warps, the fewest that put
//   every block in one wave of two blocks an SM (above 8448 rows f32, two
//   waves of 8-warp blocks), so a 512-row panel runs 128 warps on 128 SMs
//   where a 32-row strip a block made it 16 blocks, and a 2048-row panel one
//   wave of 256 blocks, not two of 512.
// Every element keeps the first body's arithmetic (panel_trsm.cuh), so the
// first body, panel_trsm_kernel over solve_strip, stays as B2's reference
// kernel (dlaf_panel_trsm_ref_*): the before/after check holds them bit for
// bit.  B7 and B8's tail run solve_rows on runs of rows of their own
// (csrc/factor_send.cuh); no main-path kernel runs solve_strip.  b is read
// through L2 (ld.global.cg): it is read once, and B7 and B8 read a peer's
// panel that other SMs wrote.

#include <cuda_runtime.h>

#include <cstdint>

#include "panel_trsm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWarps = 8;
using dlaf_panel_trsm::kW;

// ------------------------------------------------- the reference (first body)

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

// ------------------------------------------------------ the Hopper body

template <typename T, int NKB, int RW>
__global__ void __launch_bounds__(kThreads, 2)
panel_trsm_rows_kernel(const T* __restrict__ ell, const T* __restrict__ b, T* __restrict__ x,
                       long long rows, int nb, int vec) {
  extern __shared__ __align__(16) unsigned char smem_rows[];
  dlaf_panel_trsm::solve_rows<T, NKB, RW>(ell, b, x, rows, nb, vec != 0,
                                          reinterpret_cast<T*>(smem_rows),
                                          (long long)blockIdx.x * (blockDim.x / 32) * RW);
}

// Done once per instantiation: its dynamic shared memory opted in at the
// largest size any launch of it takes (nb = 32 NKB, kMaxWarps warps), so
// that no launch changes the attribute while a launch of another rank
// thread, of another size, is between its check and its start; and the
// card's SM count.
struct RowsSetup {
  cudaError_t e;
  int sms;
};

template <typename T, int NKB, int RW>
RowsSetup rows_setup() {
  RowsSetup r{cudaSuccess, 0};
  int dev = 0;
  r.e = cudaGetDevice(&dev);
  if (r.e == cudaSuccess) r.e = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, dev);
  if (r.e == cudaSuccess)
    r.e = cudaFuncSetAttribute(
        panel_trsm_rows_kernel<T, NKB, RW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dlaf_panel_trsm::rows_smem_bytes<T, RW>(NKB * kW, kMaxWarps));
  return r;
}

template <typename T, int NKB, int RW>
int launch_rows(const void* ell, const void* b, void* x, long long rows, int nb,
                cudaStream_t stream) {
  static const RowsSetup setup = rows_setup<T, NKB, RW>();  // once per instantiation
  if (setup.e != cudaSuccess) return (int)setup.e;
  // the fewest warps a block that still puts every block in one wave of
  // two blocks an SM (two stages of L take 80 KB), at most kMaxWarps
  const long long warps_needed = (rows + RW - 1) / RW;
  int warps = 1;
  while (warps < kMaxWarps && (warps_needed + warps - 1) / warps > 2LL * setup.sms) warps *= 2;
  const long long blocks = (warps_needed + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = dlaf_panel_trsm::rows_smem_bytes<T, RW>(nb, warps);
  const int vec = reinterpret_cast<std::uintptr_t>(ell) % 16 == 0;
  panel_trsm_rows_kernel<T, NKB, RW><<<(unsigned)blocks, warps * 32, smem, stream>>>(
      static_cast<const T*>(ell), static_cast<const T*>(b), static_cast<T*>(x), rows, nb, vec);
  return (int)cudaGetLastError();
}

// the instantiation for nb: NKB column blocks at most, RW rows a warp, so
// that a lane's sums (RW x NKB values) take at most 64 registers
template <typename T>
int launch_hopper(const void* ell, const void* b, void* x, long long rows, int nb,
                  void* stream) {
  if (rows <= 0) return 0;
  if (nb <= 0 || nb % kW || nb > 32 * kW) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  constexpr bool f32 = sizeof(T) == 4;
  if (nb <= 8 * kW) return launch_rows<T, 8, f32 ? 4 : 2>(ell, b, x, rows, nb, s);
  if (nb <= 16 * kW) return launch_rows<T, 16, f32 ? 4 : 2>(ell, b, x, rows, nb, s);
  return launch_rows<T, 32, f32 ? 2 : 1>(ell, b, x, rows, nb, s);
}

}  // namespace

extern "C" {

int dlaf_panel_trsm_f32(const void* ell, const void* b, void* x, long long rows, int nb,
                        void* stream) {
  return launch_hopper<float>(ell, b, x, rows, nb, stream);
}

int dlaf_panel_trsm_f64(const void* ell, const void* b, void* x, long long rows, int nb,
                        void* stream) {
  return launch_hopper<double>(ell, b, x, rows, nb, stream);
}

// B2's first body, the reference of its before/after check
int dlaf_panel_trsm_ref_f32(const void* ell, const void* b, void* x, long long rows, int nb,
                            void* stream) {
  return launch_panel_trsm<float, 32>(ell, b, x, rows, nb, stream);
}

int dlaf_panel_trsm_ref_f64(const void* ell, const void* b, void* x, long long rows, int nb,
                            void* stream) {
  return launch_panel_trsm<double, 16>(ell, b, x, rows, nb, stream);
}

}  // extern "C"
