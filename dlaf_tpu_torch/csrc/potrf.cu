// Cholesky of one (n, n) real tile, lower factor: on a thread-block
// cluster (the kernel every path launches), and on one thread block (the
// kernel it replaced, kept as the reference of its before/after check; its
// body, potrf.cuh, also runs inside B7 and B8).
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
// unit, so no block ever waits for one that cannot be scheduled.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "potrf.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kClusterThreads = 512;
constexpr int kPw = 32;         // panel width of the cluster kernel
constexpr int kLdP = kPw + 1;   // +1: conflict-free column reads
constexpr int kTileRows = 4;    // local rows of a thread's update tile
constexpr int kTileCols = 4;    // columns of it, 32 apart (one per lane)

// Shared memory of one cluster block, in elements: its rows [ceil(n/cs)][n],
// the gathered panel [n - 32][33], the diagonal factor [32][33] and its
// reciprocals [32].
__host__ __device__ inline size_t cluster_elems(int n, int cs) {
  const size_t rows = (size_t)((n + cs - 1) / cs) * n;
  const size_t pan = (size_t)(n > kPw ? n - kPw : 0) * kLdP;
  return rows + pan + (size_t)kPw * kLdP + kPw;
}

// Block 0, warp 0: factor the w x w diagonal block d in place, the
// one-block body's column loop on it (the reciprocal of the pivot, the
// column scaled, the trailing lower triangle of the block updated), with
// row r in lane r's registers and each column handed over by shuffles, so
// that no step waits on shared memory.  inv[t] keeps each column's
// reciprocal.
template <typename T>
__device__ void factor_diag(T* d, T* inv, int w) {
  const int r = threadIdx.x;
  T x[kPw];
#pragma unroll
  for (int u = 0; u < kPw; ++u) x[u] = (r < w && u < w) ? d[r * kLdP + u] : T(0);
#pragma unroll
  for (int t = 0; t < kPw; ++t) {
    if (t < w) {
      const T iv = T(1) / sqrt(__shfl_sync(0xffffffffu, x[t], t));
      if (r >= t) x[t] *= iv;
      if (r == 0) inv[t] = iv;
      const T lrt = x[t];
#pragma unroll
      for (int u = t + 1; u < kPw; ++u) {
        const T lut = __shfl_sync(0xffffffffu, x[t], u);
        if (u <= r && r < w) x[u] -= lrt * lut;
      }
    }
  }
  if (r < w)
    for (int u = 0; u < w; ++u) d[r * kLdP + u] = x[u];
}

// Block-wide copy of this block's rows between the tile in device memory
// (row i at g[i * n]) and its shared memory (row i = me + li * cs at
// s[li * n]), in 16-byte pieces when both are aligned; on the way in, the
// upper triangle is zeroed.
template <typename T, bool kIn>
__device__ inline void move_rows(T* g, T* s, int n, int nr, int me, int cs) {
  constexpr int kVec = 16 / sizeof(T);
  const int tid = threadIdx.x, nt = blockDim.x;
  if (reinterpret_cast<size_t>(g) % 16 == 0) {  // n % 8 == 0: every row is aligned too
    const int per_row = n / kVec;
#pragma unroll 4
    for (int idx = tid; idx < nr * per_row; idx += nt) {
      const int li = idx / per_row, c = (idx % per_row) * kVec, i = me + li * cs;
      uint4* gp = reinterpret_cast<uint4*>(g + (size_t)i * n + c);
      uint4* sp = reinterpret_cast<uint4*>(s + (size_t)li * n + c);
      if (kIn) {
        uint4 raw = *gp;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          if (c + k > i) e[k] = T(0);
        *sp = raw;
      } else {
        *gp = *sp;
      }
    }
  } else {
#pragma unroll 4
    for (int idx = tid; idx < nr * n; idx += nt) {
      const int li = idx / n, c = idx % n, i = me + li * cs;
      if (kIn)
        s[idx] = (c <= i) ? g[(size_t)i * n + c] : T(0);
      else
        g[(size_t)i * n + c] = s[idx];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 2)
potrf_cluster_kernel(const T* __restrict__ a, T* __restrict__ out, int n) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cs = (int)cluster.num_blocks();
  const int me = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nt / 32;
  T* rows = reinterpret_cast<T*>(smem_raw);  // row i = me + li * cs at rows[li * n]
  T* pan = rows + (size_t)((n + cs - 1) / cs) * n;
  T* d = pan + (size_t)(n > kPw ? n - kPw : 0) * kLdP;
  T* inv = d + kPw * kLdP;
  const int nr = (n - me + cs - 1) / cs;  // rows this block owns

  // own rows of the lower triangle of a, upper triangle zero
  move_rows<T, true>(const_cast<T*>(a), rows, n, nr, me, cs);
  cluster.sync();

  for (int c0 = 0; c0 < n; c0 += kPw) {
    const int w = min(kPw, n - c0);
    // 1. block 0 gathers and factors the diagonal block
    if (me == 0) {
      for (int idx = tid; idx < w * w; idx += nt) {
        const int r = idx / w, u = idx % w, i = c0 + r;
        const T* src = cluster.map_shared_rank(rows, i % cs);
        d[r * kLdP + u] = src[(size_t)(i / cs) * n + c0 + u];
      }
      __syncthreads();
      if (warp == 0) factor_diag(d, inv, w);
      __syncthreads();
    }
    cluster.sync();
    // 2. the factor and its reciprocals from block 0; this block's rows of
    // the diagonal block from it, then its rows below it solved
    if (me != 0) {
      const T* src = cluster.map_shared_rank(d, 0);
      for (int idx = tid; idx < kPw * kLdP + kPw; idx += nt) d[idx] = src[idx];
      __syncthreads();
    }
    for (int idx = tid; idx < w * w; idx += nt) {
      const int r = idx / w, u = idx % w, i = c0 + r;
      if (i % cs == me) rows[(size_t)(i / cs) * n + c0 + u] = (u <= r) ? d[r * kLdP + u] : T(0);
    }
    if (w == kPw && c0 + kPw < n) {
      const int li0 = (c0 + kPw - me + cs - 1) / cs;  // first own row below the block
      for (int li = li0 + tid; li < nr; li += nt) {
        T* x = rows + (size_t)li * n + c0;
        T v[kPw];
#pragma unroll
        for (int u = 0; u < kPw; ++u) v[u] = x[u];
#pragma unroll
        for (int u = 0; u < kPw; ++u) {
#pragma unroll
          for (int t = 0; t < u; ++t) v[u] -= v[t] * d[u * kLdP + t];
          v[u] *= inv[u];
        }
#pragma unroll
        for (int u = 0; u < kPw; ++u) x[u] = v[u];
      }
    }
    cluster.sync();
    if (w < kPw || c0 + kPw >= n) break;  // the last panel has no trailing rows
    // 3. the factored panel below the diagonal block from every block, then
    // the rank-32 update of this block's trailing rows
    const int base = c0 + kPw, m2 = n - base;
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kChunks = kPw / kVec;
    constexpr int kInFlight = 4;  // DSMEM loads in flight per thread
    for (int idx0 = tid; idx0 < m2 * kChunks; idx0 += kInFlight * nt) {
      uint4 raw[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int idx = idx0 + k * nt;
        if (idx < m2 * kChunks) {
          const int i = base + idx / kChunks, q = idx % kChunks;
          raw[k] = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(rows, i % cs) +
                                                   (size_t)(i / cs) * n + c0 + q * kVec);
        }
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int idx = idx0 + k * nt;
        if (idx < m2 * kChunks) {
          const T* e = reinterpret_cast<const T*>(&raw[k]);
          T* dst = pan + (idx / kChunks) * kLdP + (idx % kChunks) * kVec;
#pragma unroll
          for (int v = 0; v < kVec; ++v) dst[v] = e[v];
        }
      }
    }
    __syncthreads();
    const int li0 = (base - me + cs - 1) / cs;
    const int groups = (nr - li0 + kTileRows - 1) / kTileRows;
    const int strips = (m2 + 32 * kTileCols - 1) / (32 * kTileCols);
    for (int wt = warp; wt < groups * strips; wt += nwarps) {
      const int lr = li0 + (wt / strips) * kTileRows;
      const int jb = base + (wt % strips) * 32 * kTileCols;
      const int i_last = me + min(lr + kTileRows - 1, nr - 1) * cs;
      if (jb > i_last) continue;  // the tile lies above the diagonal
      int pi[kTileRows], pj[kTileCols];
#pragma unroll
      for (int q = 0; q < kTileRows; ++q) pi[q] = (me + min(lr + q, nr - 1) * cs - base) * kLdP;
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) pj[c] = (min(jb + lane + 32 * c, n - 1) - base) * kLdP;
      T acc[kTileRows][kTileCols];
#pragma unroll
      for (int q = 0; q < kTileRows; ++q)
#pragma unroll
        for (int c = 0; c < kTileCols; ++c) acc[q][c] = T(0);
#pragma unroll 8
      for (int t = 0; t < kPw; ++t) {
        T li[kTileRows], lj[kTileCols];
#pragma unroll
        for (int q = 0; q < kTileRows; ++q) li[q] = pan[pi[q] + t];
#pragma unroll
        for (int c = 0; c < kTileCols; ++c) lj[c] = pan[pj[c] + t];
#pragma unroll
        for (int q = 0; q < kTileRows; ++q)
#pragma unroll
          for (int c = 0; c < kTileCols; ++c) acc[q][c] += li[q] * lj[c];
      }
#pragma unroll
      for (int q = 0; q < kTileRows; ++q) {
        const int li_q = lr + q, i = me + li_q * cs;
#pragma unroll
        for (int c = 0; c < kTileCols; ++c) {
          const int j = jb + lane + 32 * c;
          if (li_q < nr && j <= i && j < n) rows[(size_t)li_q * n + j] -= acc[q][c];
        }
      }
    }
    cluster.sync();
  }

  // every block's reads of this block's rows are over (the last
  // cluster.sync() above); write the rows out
  move_rows<T, false>(out, rows, n, nr, me, cs);
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

const char* dlaf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
