// Trailing update x[i, j] -= a[i] @ op(b[j]) over a batch of tile pairs,
// written in place.
//
// Replaces dlaf_tpu/ops/pallas_trailing_update.py (trailing_update /
// _update_kernel, tier 'default'; the one-rank branch of
// fused_transpose_update).  Two forms, picked by b_is_nk:
//   b_is_nk = 1: 'iab,jcb->ijac', x[i, j] -= a[i] @ b[j]^T, b [C, N, K]
//   b_is_nk = 0: 'iab,jbc->ijac', x[i, j] -= a[i] @ b[j],   b [C, K, N]
// with x [L, C, M, N] and a [L, M, K], all row-major.
//
// What bounds it on the H100: operations.  At N=16384, nb=512 (x is
// [32, 32, 512, 512]) one update is 275 GFlop over 2.2 GB.  The design is a
// plain shared-memory-tiled FMA GEMM, no tensor cores yet: a 256-thread
// block computes one 64 x 64 tile of one (i, j) pair, staging 16-deep k
// slices of a and b in shared memory, each thread a 4 x 4 register tile.
// The grid is one-dimensional, L*C*ceil(M/64)*ceil(N/64) blocks (65536 at
// N=16384), so it never meets the 65535 limit of gridDim.y and gridDim.z.
// Masked zero slots are computed like any other, as the TPU kernel does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kTM = 4, kTN = 4;  // 16 x 16 threads, each a 4 x 4 tile

template <typename T, bool kBIsNK>
__global__ void __launch_bounds__(kThreads)
trailing_update_kernel(T* __restrict__ x, const T* __restrict__ a, const T* __restrict__ b,
                       int C, int M, int N, int K) {
  __shared__ T as[kBK][kBM + 4];  // as[k][m]
  __shared__ T bs[kBK][kBN + 4];  // bs[k][n]
  const int tiles_n = (N + kBN - 1) / kBN, tiles_m = (M + kBM - 1) / kBM;
  long long bid = blockIdx.x;
  const int tn = (int)(bid % tiles_n);
  bid /= tiles_n;
  const int tm = (int)(bid % tiles_m);
  bid /= tiles_m;
  const int j = (int)(bid % C);
  const long long i = bid / C;

  const T* ai = a + i * M * (long long)K;
  const T* bj = b + (long long)j * N * K;
  T* xij = x + (i * C + j) * (long long)M * N;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = tm * kBM, n0 = tn * kBN;

  T acc[kTM][kTN];
#pragma unroll
  for (int u = 0; u < kTM; ++u)
#pragma unroll
    for (int v = 0; v < kTN; ++v) acc[u][v] = T(0);

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < kBM * kBK / kThreads; ++q) {
      const int idx = tid + q * kThreads;
      const int mm = idx / kBK, kk = idx % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      as[kk][mm] = (gm < M && gk < K) ? ai[(long long)gm * K + gk] : T(0);
    }
#pragma unroll
    for (int q = 0; q < kBN * kBK / kThreads; ++q) {
      const int idx = tid + q * kThreads;
      if (kBIsNK) {
        const int nn = idx / kBK, kk = idx % kBK;
        const int gn = n0 + nn, gk = k0 + kk;
        bs[kk][nn] = (gn < N && gk < K) ? bj[(long long)gn * K + gk] : T(0);
      } else {
        const int kk = idx / kBN, nn = idx % kBN;
        const int gn = n0 + nn, gk = k0 + kk;
        bs[kk][nn] = (gn < N && gk < K) ? bj[(long long)gk * N + gn] : T(0);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      T av[kTM], bv[kTN];
#pragma unroll
      for (int u = 0; u < kTM; ++u) av[u] = as[kk][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < kTN; ++v) bv[v] = bs[kk][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < kTM; ++u)
#pragma unroll
        for (int v = 0; v < kTN; ++v) acc[u][v] += av[u] * bv[v];
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < kTM; ++u) {
    const int gm = m0 + ty + 16 * u;
    if (gm >= M) continue;
#pragma unroll
    for (int v = 0; v < kTN; ++v) {
      const int gn = n0 + tx + 16 * v;
      if (gn < N) xij[(long long)gm * N + gn] -= acc[u][v];
    }
  }
}

template <typename T>
int launch_trailing_update(void* x, const void* a, const void* b, int L, int C, int M, int N,
                           int K, int b_is_nk, void* stream) {
  if (L <= 0 || C <= 0 || M <= 0 || N <= 0) return 0;
  const long long blocks =
      (long long)L * C * ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_is_nk)
    trailing_update_kernel<T, true><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<T*>(x), static_cast<const T*>(a), static_cast<const T*>(b), C, M, N, K);
  else
    trailing_update_kernel<T, false><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<T*>(x), static_cast<const T*>(a), static_cast<const T*>(b), C, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dlaf_trailing_update_f32(void* x, const void* a, const void* b, int L, int C, int M, int N,
                             int K, int b_is_nk, void* stream) {
  return launch_trailing_update<float>(x, a, b, L, C, M, N, K, b_is_nk, stream);
}

int dlaf_trailing_update_f64(void* x, const void* a, const void* b, int L, int C, int M, int N,
                             int K, int b_is_nk, void* stream) {
  return launch_trailing_update<double>(x, a, b, L, C, M, N, K, b_is_nk, stream);
}

}  // extern "C"
