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
// The caller owns the output buffer; nothing is allocated here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr size_t kSmemLimit = 232448;  // 227 KB per block on Hopper

template <typename T>
__global__ void __launch_bounds__(kThreads)
potrf_kernel(const T* __restrict__ a, T* __restrict__ out, int n, int pw) {
  extern __shared__ unsigned char smem_raw[];
  T* ps = reinterpret_cast<T*>(smem_raw);  // panel [n - c0][pw + 1]
  const int ld = pw + 1;                   // +1: conflict-free column reads
  const int tid = threadIdx.x;
  const long long nn = (long long)n * n;

  // lower triangle of a into out, upper triangle zero
  for (long long idx = tid; idx < nn; idx += kThreads) {
    const int r = (int)(idx / n), c = (int)(idx % n);
    out[idx] = (c <= r) ? a[idx] : T(0);
  }
  __syncthreads();

  for (int c0 = 0; c0 < n; c0 += pw) {
    const int w = min(pw, n - c0);  // panel width
    const int m = n - c0;           // panel rows (c0 .. n-1)
    for (int idx = tid; idx < m * w; idx += kThreads) {
      const int r = idx / w, c = idx % w;
      ps[r * ld + c] = out[(long long)(c0 + r) * n + c0 + c];
    }
    __syncthreads();

    // unblocked right-looking factor of the panel
    for (int t = 0; t < w; ++t) {
      const T inv = T(1) / sqrt(ps[t * ld + t]);
      __syncthreads();  // every thread has read the pivot before it is scaled
      for (int r = t + tid; r < m; r += kThreads) ps[r * ld + t] *= inv;
      __syncthreads();
      const int cols = w - t - 1;
      const int rows = m - t - 1;
      for (int idx = tid; idx < rows * cols; idx += kThreads) {
        const int r = t + 1 + idx / cols, u = t + 1 + idx % cols;
        if (r >= u) ps[r * ld + u] -= ps[r * ld + t] * ps[u * ld + t];
      }
      __syncthreads();
    }

    // write the factored panel back (upper part of its diagonal block zero)
    for (int idx = tid; idx < m * w; idx += kThreads) {
      const int r = idx / w, c = idx % w;
      out[(long long)(c0 + r) * n + c0 + c] = (r >= c) ? ps[r * ld + c] : T(0);
    }

    // trailing lower triangle: out[i][j] -= sum_t P[i][t] * P[j][t]
    const int mt = m - w;
    const long long mm = (long long)mt * mt;
    for (long long idx = tid; idx < mm; idx += kThreads) {
      const int i = (int)(idx / mt), j = (int)(idx % mt);
      if (j > i) continue;
      const T* pi = ps + (w + i) * ld;
      const T* pj = ps + (w + j) * ld;
      T acc = T(0);
      for (int t = 0; t < w; ++t) acc += pi[t] * pj[t];
      out[(long long)(c0 + w + i) * n + c0 + w + j] -= acc;
    }
    __syncthreads();
  }
}

template <typename T>
int launch_potrf(const void* a, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  int pw = 32;
  while (pw > 8 && (size_t)n * (pw + 1) * sizeof(T) > kSmemLimit) pw /= 2;
  const size_t smem = (size_t)n * (pw + 1) * sizeof(T);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
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
