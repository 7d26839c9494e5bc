// The block body of the potrf kernel (B1), shared by csrc/potrf.cu and the
// fused factor-and-send kernel of csrc/panel_exchange.cu (B7), as the TPU's
// fused kernel composes pallas_potrf._potrf_kernel.  See potrf.cu for what
// it computes and why it is blocked this way.
#pragma once

#include <cuda_runtime.h>

namespace dlaf_potrf {

constexpr size_t kSmemLimit = 232448;  // 227 KB per block on Hopper

// Panel width for an n x n tile: 32, or narrower when a 32-wide panel of
// the tile does not fit in shared memory; 0 when not even 8 fits.
template <typename T>
__host__ __device__ inline int panel_width(int n) {
  int pw = 32;
  while (pw > 8 && (size_t)n * (pw + 1) * sizeof(T) > kSmemLimit) pw /= 2;
  return (size_t)n * (pw + 1) * sizeof(T) > kSmemLimit ? 0 : pw;
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(int n) {
  return (size_t)n * (panel_width<T>(n) + 1) * sizeof(T);
}

// Lower Cholesky factor of the (n, n) tile a (lower triangle read) into out
// (upper triangle zero), by one block of NT threads; ps is the block's
// shared memory, smem_bytes<T>(n) of it.
template <typename T, int NT>
__device__ void factor_tile(const T* __restrict__ a, T* __restrict__ out, int n, int pw, T* ps) {
  const int ld = pw + 1;  // +1: conflict-free column reads
  const int tid = threadIdx.x;
  const long long nn = (long long)n * n;

  // lower triangle of a into out, upper triangle zero
  for (long long idx = tid; idx < nn; idx += NT) {
    const int r = (int)(idx / n), c = (int)(idx % n);
    out[idx] = (c <= r) ? a[idx] : T(0);
  }
  __syncthreads();

  for (int c0 = 0; c0 < n; c0 += pw) {
    const int w = min(pw, n - c0);  // panel width
    const int m = n - c0;           // panel rows (c0 .. n-1)
    for (int idx = tid; idx < m * w; idx += NT) {
      const int r = idx / w, c = idx % w;
      ps[r * ld + c] = out[(long long)(c0 + r) * n + c0 + c];
    }
    __syncthreads();

    // unblocked right-looking factor of the panel
    for (int t = 0; t < w; ++t) {
      const T inv = T(1) / sqrt(ps[t * ld + t]);
      __syncthreads();  // every thread has read the pivot before it is scaled
      for (int r = t + tid; r < m; r += NT) ps[r * ld + t] *= inv;
      __syncthreads();
      const int cols = w - t - 1;
      const int rows = m - t - 1;
      for (int idx = tid; idx < rows * cols; idx += NT) {
        const int r = t + 1 + idx / cols, u = t + 1 + idx % cols;
        if (r >= u) ps[r * ld + u] -= ps[r * ld + t] * ps[u * ld + t];
      }
      __syncthreads();
    }

    // write the factored panel back (upper part of its diagonal block zero)
    for (int idx = tid; idx < m * w; idx += NT) {
      const int r = idx / w, c = idx % w;
      out[(long long)(c0 + r) * n + c0 + c] = (r >= c) ? ps[r * ld + c] : T(0);
    }

    // trailing lower triangle: out[i][j] -= sum_t P[i][t] * P[j][t]
    const int mt = m - w;
    const long long mm = (long long)mt * mt;
    for (long long idx = tid; idx < mm; idx += NT) {
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

}  // namespace dlaf_potrf
