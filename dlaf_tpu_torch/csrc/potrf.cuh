// The block bodies of the potrf kernel (B1), shared by csrc/potrf.cu and
// the factor-and-send body of csrc/factor_send.cuh (B7 and B8's tail), as
// the TPU's fused kernels compose pallas_potrf._potrf_kernel.  See potrf.cu
// for what they compute and why they are blocked this way.
//
// factor_tile: the one-block body (B1's reference kernel).  On the main
// path it runs only where B1's gate (ops/potrf.py: cluster_fits) takes the
// one-block kernel: f64 above n = 360, so f64 at nb = 512, in B1 and, by
// the same gate, in B7 and B8's tail.
//
// factor_team: the cluster body, written once for two teams of blocks:
//   ClusterTeam, B1's thread-block cluster: the blocks read each other's
//     rows through distributed shared memory and meet at cluster.sync();
//   a flag team (factor_send.cuh), the blocks of one ring launch: a row a
//     block publishes goes to device memory and is read through L2, and the
//     blocks meet at a barrier of device flags.
// Both run the same arithmetic in the same order on every element
// (potrf.cu), so both give the bits of factor_tile.
#pragma once

#include <cooperative_groups.h>
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

// ------------------------------------------------------------ the team body

constexpr int kPw = 32;         // panel width of the team body
constexpr int kLdP = kPw + 1;   // +1: conflict-free column reads
constexpr int kTileRows = 4;    // local rows of a thread's update tile
constexpr int kTileCols = 4;    // columns of it, 32 apart (one per lane)

// Shared memory of one block of a team of cs, in elements: its rows
// [ceil(n/cs)][n], the gathered panel [n - 32][33], the diagonal factor
// [32][33] and its reciprocals [32].
__host__ __device__ inline size_t cluster_elems(int n, int cs) {
  const size_t rows = (size_t)((n + cs - 1) / cs) * n;
  const size_t pan = (size_t)(n > kPw ? n - kPw : 0) * kLdP;
  return rows + pan + (size_t)kPw * kLdP + kPw;
}

// B1's cluster: the blocks of one thread-block cluster.
struct ClusterTeam {
  static constexpr bool kDsmem = true;
  cooperative_groups::cluster_group cluster;
  int cs, me;
  __device__ ClusterTeam()
      : cluster(cooperative_groups::this_cluster()),
        cs((int)cluster.num_blocks()),
        me((int)cluster.block_rank()) {}
  __device__ bool sync() {
    cluster.sync();
    return true;
  }
};

// Warp 0: factor the w x w diagonal block d in place, the one-block body's
// column loop on it (the reciprocal of the pivot, the column scaled, the
// trailing lower triangle of the block updated), with row r in lane r's
// registers and each column handed over by shuffles, so that no step waits
// on shared memory.  inv[t] keeps each column's reciprocal.
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

// Every thread: solve its own rows li0 .. nr - 1 (rows + li * n) of the
// panel at column c0 against the factored diagonal block d and its
// reciprocals, a row per thread in registers:
// x[u] = (x[u] - sum_{t<u} x[t] d[u][t]) * inv[u], t ascending.
template <typename T>
__device__ void solve_panel_rows(T* rows, const T* d, const T* inv, int n, int c0, int li0,
                                 int nr) {
  for (int li = li0 + (int)threadIdx.x; li < nr; li += blockDim.x) {
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

// Every warp: the rank-32 update of this block's trailing rows from the
// gathered panel pan (rows base .. n - 1), 4 x 4 register tiles a thread:
// x[i][j] -= acc, acc = sum over the panel's t in order of L[i][t] L[j][t].
template <typename T>
__device__ void update_rows(T* rows, const T* pan, int n, int me, int cs, int nr, int base) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const int m2 = n - base;
  const int lb = (base - me + cs - 1) / cs;
  const int groups = (nr - lb + kTileRows - 1) / kTileRows;
  const int strips = (m2 + 32 * kTileCols - 1) / (32 * kTileCols);
  for (int wt = warp; wt < groups * strips; wt += nwarps) {
    const int lr = lb + (wt / strips) * kTileRows;
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
}

// The three out of line, for a flag team: in a ring launch their rows
// and sums in registers would sit beside the ring's state and spill.
template <typename T>
__device__ __noinline__ void factor_diag_call(T* d, T* inv, int w) {
  factor_diag(d, inv, w);
}

template <typename T>
__device__ __noinline__ void solve_panel_rows_call(T* rows, const T* d, const T* inv, int n,
                                                   int c0, int li0, int nr) {
  solve_panel_rows(rows, d, inv, n, c0, li0, nr);
}

template <typename T>
__device__ __noinline__ void update_rows_call(T* rows, const T* pan, int n, int me, int cs, int nr,
                                              int base) {
  update_rows(rows, pan, n, me, cs, nr, base);
}

// Block-wide copy of this block's rows between the tile in device memory
// (row i at g[i * n]) and its shared memory (row i = me + li * cs at
// s[li * n]), in 16-byte pieces when both are aligned; on the way in, the
// upper triangle is zeroed, and kCg reads the tile through L2 (a flag
// team's tile may have been written by other SMs during the launch).
template <typename T, bool kIn, bool kCg = false>
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
        uint4 raw = kCg ? __ldcg(gp) : *gp;
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
        s[idx] = (c <= i) ? (kCg ? __ldcg(g + (size_t)i * n + c) : g[(size_t)i * n + c]) : T(0);
      else
        g[(size_t)i * n + c] = s[idx];
    }
  }
}

// A flag team's hand-over of the diagonal block at column c0 (w wide): this
// block's rows of it into the team's scratch [32][32].
template <typename T>
__device__ inline void publish_diag(const T* rows, T* dscr, int n, int me, int cs, int c0, int w) {
  for (int idx = threadIdx.x; idx < w * w; idx += blockDim.x) {
    const int r = idx / w, u = idx % w, i = c0 + r;
    if (i % cs == me) dscr[r * kPw + u] = rows[(size_t)(i / cs) * n + c0 + u];
  }
}

// The lower Cholesky factor of the (n, n) tile a (lower triangle read)
// into out (upper triangle zero), by a team of tm.cs blocks of 512
// threads, row i in block i % cs (see potrf.cu).  For each 32-wide panel:
//   1. the diagonal block: ClusterTeam: block 0 gathers it through DSMEM,
//      factors it in warp 0, the others copy the factor after a sync; flag
//      team: every block reads it from the scratch dscr, where its owners
//      put it before the last sync, and factors it itself (the same bits:
//      the same inputs, the same code);
//   2. every block solves its own rows of the panel; a flag team's blocks
//      then store those rows of the panel in out, where they are final;
//   sync; 3. every block copies the panel's rows below the diagonal block
//      (DSMEM, or out through L2) and applies the rank-32 update to its own
//      trailing rows; a flag team's owners of the next diagonal block put
//      their rows of it in dscr; sync.
// Finally each block writes its rows to out.  False when a sync's wait ran
// out (a flag team only): the caller returns.  smem holds
// cluster_elems(n, tm.cs) elements.
template <typename T, class Team>
__device__ bool factor_team(Team& tm, const T* __restrict__ a, T* __restrict__ out, int n,
                            T* __restrict__ dscr, unsigned char* smem_raw) {
  constexpr bool kDsmem = Team::kDsmem;
  const int cs = tm.cs, me = tm.me;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32;
  T* rows = reinterpret_cast<T*>(smem_raw);  // row i = me + li * cs at rows[li * n]
  T* pan = rows + (size_t)((n + cs - 1) / cs) * n;
  T* d = pan + (size_t)(n > kPw ? n - kPw : 0) * kLdP;
  T* inv = d + kPw * kLdP;
  const int nr = (n - me + cs - 1) / cs;  // rows this block owns
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kPw / kVec;

  // own rows of the lower triangle of a, upper triangle zero
  move_rows<T, true, !kDsmem>(const_cast<T*>(a), rows, n, nr, me, cs);
  if constexpr (!kDsmem) {
    __syncthreads();
    publish_diag(rows, dscr, n, me, cs, 0, min(kPw, n));
  }
  if (!tm.sync()) return false;

  for (int c0 = 0; c0 < n; c0 += kPw) {
    const int w = min(kPw, n - c0);
    // 1. the diagonal block, factored
    if constexpr (kDsmem) {
      if (me == 0) {
        for (int idx = tid; idx < w * w; idx += nt) {
          const int r = idx / w, u = idx % w, i = c0 + r;
          const T* src = tm.cluster.map_shared_rank(rows, i % cs);
          d[r * kLdP + u] = src[(size_t)(i / cs) * n + c0 + u];
        }
        __syncthreads();
        if (warp == 0) factor_diag(d, inv, w);
        __syncthreads();
      }
      tm.sync();
      // 2. the factor and its reciprocals from block 0
      if (me != 0) {
        const T* src = tm.cluster.map_shared_rank(d, 0);
        for (int idx = tid; idx < kPw * kLdP + kPw; idx += nt) d[idx] = src[idx];
        __syncthreads();
      }
    } else {
      for (int idx = tid; idx < w * w; idx += nt) {
        const int r = idx / w, u = idx % w;
        d[r * kLdP + u] = __ldcg(dscr + r * kPw + u);
      }
      __syncthreads();
      if (warp == 0) factor_diag_call(d, inv, w);
      __syncthreads();
    }
    // 2. this block's rows of the diagonal block, then its rows below it
    // solved
    for (int idx = tid; idx < w * w; idx += nt) {
      const int r = idx / w, u = idx % w, i = c0 + r;
      if (i % cs == me) rows[(size_t)(i / cs) * n + c0 + u] = (u <= r) ? d[r * kLdP + u] : T(0);
    }
    const int li0 = (c0 + kPw - me + cs - 1) / cs;  // first own row below the block
    if (w == kPw && c0 + kPw < n) {
      if constexpr (kDsmem)
        solve_panel_rows(rows, d, inv, n, c0, li0, nr);
      else
        solve_panel_rows_call(rows, d, inv, n, c0, li0, nr);
      if constexpr (!kDsmem) {
        // the solved rows of the panel, final, into out for the team
        __syncthreads();
        for (int idx = tid; idx < (nr - li0) * kChunks; idx += nt) {
          const int li = li0 + idx / kChunks, q = idx % kChunks, i = me + li * cs;
          *reinterpret_cast<uint4*>(out + (size_t)i * n + c0 + q * kVec) =
              *reinterpret_cast<const uint4*>(rows + (size_t)li * n + c0 + q * kVec);
        }
      }
    }
    if (!tm.sync()) return false;
    if (w < kPw || c0 + kPw >= n) break;  // the last panel has no trailing rows
    // 3. the factored panel below the diagonal block from every block, then
    // the rank-32 update of this block's trailing rows
    const int base = c0 + kPw, m2 = n - base;
    constexpr int kInFlight = 4;  // loads in flight per thread
    for (int idx0 = tid; idx0 < m2 * kChunks; idx0 += kInFlight * nt) {
      uint4 raw[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int idx = idx0 + k * nt;
        if (idx < m2 * kChunks) {
          const int i = base + idx / kChunks, q = idx % kChunks;
          if constexpr (kDsmem)
            raw[k] = *reinterpret_cast<const uint4*>(tm.cluster.map_shared_rank(rows, i % cs) +
                                                     (size_t)(i / cs) * n + c0 + q * kVec);
          else
            raw[k] = __ldcg(reinterpret_cast<const uint4*>(out + (size_t)i * n + c0 + q * kVec));
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
    if constexpr (kDsmem)
      update_rows(rows, pan, n, me, cs, nr, base);
    else
      update_rows_call(rows, pan, n, me, cs, nr, base);
    if constexpr (!kDsmem) {
      __syncthreads();
      publish_diag(rows, dscr, n, me, cs, base, min(kPw, m2));
    }
    if (!tm.sync()) return false;
  }

  // every block's reads of this block's rows are over (the last sync
  // above); write the rows out
  move_rows<T, false>(out, rows, n, nr, me, cs);
  return true;
}

}  // namespace dlaf_potrf
