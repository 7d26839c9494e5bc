// Cholesky of one (n, n) real tile, lower factor: on a thread-block
// cluster (the kernel every path launches), and on one thread block (the
// kernel it replaced, kept as the reference of its before/after check, and
// the kernel B1's gate takes where the cluster's rows do not fit).  Both
// bodies are in potrf.cuh; the cluster body (factor_team) also runs inside
// B7 and B8's tail, on the blocks of their launch (csrc/factor_send.cuh).
//
// Replaces dlaf_tpu/ops/pallas_potrf.py (potrf_tile / _potrf_kernel): the
// tile is hermitized from its lower triangle (only the lower triangle is
// read), the result is the lower factor with the upper triangle zero, and
// a non-positive pivot poisons the factor with NaN exactly as the TPU
// kernel's 1/sqrt does.
//
// What bounds it on the H100: latency.  An n=512 f32 tile is 44.7 MFlop
// over 2 MiB, a few microseconds of the card at its peaks, but each
// column depends on the one before it.  The TPU kernel keeps the whole tile
// in VMEM.  The one-block body (potrf.cuh) is blocked right-looking on one
// SM: for each column panel of width pw (32, or 16/8 when a 32-wide panel
// does not fit in shared memory) it loads the panel into shared memory,
// factors it there with two __syncthreads() per column, writes it back and
// subtracts its rank-pw product from the trailing lower triangle, which
// stays in device memory.
//
// The cluster kernel holds the whole tile in the distributed shared memory
// of a cluster of CS blocks (8: a 1 MiB f32 tile is 128 KB of rows per
// block).  Row i lives in block i % CS, so every block carries an equal
// share of each trailing update.  For each 32-wide panel at column c0:
//   1. block 0 gathers the 32 x 32 diagonal block through DSMEM and one
//      warp factors it, a row per lane in registers, the columns handed
//      over by shuffles, keeping each column's 1/sqrt(pivot);
//   2. cluster.sync(); every block copies that factor and the 32 reciprocals
//      and solves its own rows of the panel, one thread per row;
//   3. cluster.sync(); every block copies the factored panel (rows below
//      the diagonal block, at most (n - 32) x 32) into its own shared memory
//      and applies the rank-32 update to its own trailing rows, 4 x 4
//      register tiles per thread; cluster.sync().
// The tile is read once and written once.  A cluster is scheduled as a
// unit, so no block ever waits for one that cannot be scheduled.  The body
// is potrf.cuh's factor_team on a ClusterTeam.
//
// Both give the same bits: every element sees the same operations in the
// same order as in the one-block body.  A panel element:
// x -= L[r][t] * L[u][t] over t < u in order (each an FMA: nvcc contracts
// a -= b * c the same way in both), then x *= 1/sqrt(pivot u); a trailing
// element: acc = 0, acc += L[i][t] * L[j][t] over the panel's t in order,
// then x -= acc.  Both need the panel width 32, which the one-block body
// takes at every size the cluster takes.  The build has no fast-math.
//
// The caller owns the output buffer; nothing is allocated here.

#include <cuda_runtime.h>

#include "potrf.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kClusterThreads = 512;
using dlaf_potrf::cluster_elems;
using dlaf_potrf::kPw;

// B1's cluster: the team body of potrf.cuh on the blocks of one cluster
template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 2)
potrf_cluster_kernel(const T* __restrict__ a, T* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dlaf_potrf::ClusterTeam tm;
  dlaf_potrf::factor_team<T>(tm, a, out, n, static_cast<T*>(nullptr), smem_raw);
}

template <typename T>
int launch_potrf_cluster(const void* a, void* out, int n, int cs, void* stream) {
  if (n <= 0) return 0;
  // the same bits as the one-block body need its panel width
  if (n % 8 || cs < 1 || dlaf_potrf::panel_width<T>(n) != kPw) return (int)cudaErrorInvalidValue;
  const size_t smem = cluster_elems(n, cs) * sizeof(T);
  if (smem > dlaf_potrf::kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(potrf_cluster_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (cs > 8) {
    e = cudaFuncSetAttribute(potrf_cluster_kernel<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // refuse a cluster the card cannot hold, rather than shrink it
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, potrf_cluster_kernel<T>, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, potrf_cluster_kernel<T>, static_cast<const T*>(a),
                         static_cast<T*>(out), n);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of B1's cluster at side n: how many
// clusters of cs blocks the card holds at once (on an empty card), or a
// negated CUDA error
template <typename T>
int cluster_occupancy(int n, int cs) {
  const size_t smem = cluster_elems(n, cs) * sizeof(T);
  if (n <= 0 || cs < 1 || smem > dlaf_potrf::kSmemLimit) return -(int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(potrf_cluster_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && cs > 8)
    e = cudaFuncSetAttribute(potrf_cluster_kernel<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, potrf_cluster_kernel<T>, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

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

// B1 on a cluster of cs blocks (cs > 8 is a non-portable cluster size).
int dlaf_potrf_cluster_f32(const void* a, void* out, int n, int cs, void* stream) {
  return launch_potrf_cluster<float>(a, out, n, cs, stream);
}

int dlaf_potrf_cluster_f64(const void* a, void* out, int n, int cs, void* stream) {
  return launch_potrf_cluster<double>(a, out, n, cs, stream);
}

// clusters of cs blocks of B1's cluster kernel at side n the card holds at
// once (cudaOccupancyMaxActiveClusters), or a negated CUDA error
int dlaf_potrf_cluster_occupancy(int f64, int n, int cs) {
  return f64 ? cluster_occupancy<double>(n, cs) : cluster_occupancy<float>(n, cs);
}

const char* dlaf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
