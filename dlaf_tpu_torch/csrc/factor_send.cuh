// The factor-and-send body of B7 (csrc/panel_exchange.cu, fused_kernel)
// and of B8's tail (csrc/consume.cu, fused_step_kernel, phases 2-4): the
// Cholesky factor of the diagonal tile on the blocks of the launch, the
// panel solve of the root's column shared by every rank of the ring, and
// the send as a pull.  As the TPU's _fused_kernel composes _potrf_kernel,
// pallas_panel_trsm._kernel and _ring_hops.
//
// Every rank of the ring launches G blocks of 512 threads (G = SMs / ranks
// of the grid, as every ring kernel), all at once, and every block spins
// on flags set by other blocks, so every block must be resident beside all
// the others (panel_exchange.cu): each block fits an SM alone.
//
// 1. The factor: B1's cluster body (potrf.cuh, factor_team) on the first
//    FB = min(G, 16) blocks of the launch, every rank factoring its own
//    copy of the tile (the same bits on every rank: the factor is
//    deterministic).  The blocks are not a thread-block cluster: they
//    publish the rows the others need (the diagonal block, the solved
//    panel) in device memory, read them through L2, and meet at a barrier
//    of device flags, one per block (FlagTeam: thread 0 stores its flag,
//    the lanes of warp 0 each poll the flags of a few other blocks).  Where
//    B1's gate (cluster_fits) takes the one-block body, f64 at nb = 512,
//    block 0 runs it.  Then a barrier over all G blocks: the factor is
//    written.
//    Why not a cluster.  A cluster of 8 needs 8 SMs of one GPC free at
//    once, one block each (f32, nb = 512: 196 KB of shared memory a block
//    at 8 blocks, 131 KB at 16); cudaOccupancyMaxActiveClusters gives 16 on
//    an empty H100 80GB HBM3 (chip_smoke.py's phase 1 prints it) and every
//    rank of a 2x4 grid would need 2 (G = 16 blocks) at once.  Worse, the
//    ring kernels of the other ranks (B5, B6, B8: up to 7 x 16 = 112
//    blocks) spin on the card while B7 waits to be scheduled, and a B6 or
//    B8 block holds its SM's whole register file: with 112 SMs held, 20
//    free SMs spread over 7-8 GPCs need not hold one cluster of 8.  The
//    pigeonhole argument that makes the ring kernels safe (G x ranks <=
//    SMs, each block fits an SM) holds for single blocks only.  So the
//    team body runs on plain blocks; its cost over the cluster is a flag
//    round trip through L2 per sync (2 a panel) in place of cluster.sync.
// 2. The solve: B2's body (panel_trsm.cuh, solve_rows) on runs of C = 16
//    warps x RW rows ("chunks": 32 rows in f32, 16 in f64).  The root's
//    tiles below the diagonal (below[i] != 0) give nc = (solved tiles) x
//    ceil(nb / C) chunks, and
//    ring position q solves chunks [nc q / P, nc (q + 1) / P) of the root's
//    panel (share_lo) into its own cp, reading the root's tiles where they
//    lie, against its own factor, and publishes a flag per chunk.  Tiles
//    not below the diagonal are written as zeros by every rank, not solved.
// 3. The send: every rank copies each chunk it did not solve straight out
//    of the cp of the rank that solved it, once the chunk's flag is up, so
//    copying overlaps the solve; no landing slots, no hops.  The peers' xc
//    and cp pointers come from the host rendezvous before the launch.
// 4. The exit barrier (B5's): no rank's kernel ends until every block of
//    every rank that reads its xc or its cp is done.
//
// Flags are 64-bit, valued epoch | step and never reset (ring.cuh); every
// wait is bounded by %globaltimer and sets the grid's error word when it
// runs out.  The bits: the factor is B1's (the same per-element order as
// the one-block body), each solved row is B2's (solve_rows is bit for bit
// solve_strip), the send is a copy, so lkk and cp are bit for bit the
// unfused potrf_tile -> panel_trsm_right_lower_t -> mask -> ring_bcast.
#pragma once

#include <cuda_runtime.h>

#include "panel_trsm.cuh"
#include "potrf.cuh"
#include "ring.cuh"

namespace dlaf_fsend {

using dlaf_ring::publish;
using dlaf_ring::u64;

constexpr int kThreads = 512;       // B7's and B8's blocks
constexpr int kMaxRanks = 32;       // ranks of a ring (a grid has at most 30)
constexpr int kFactorBlocks = 16;   // the factor's team: min(G, 16) blocks
constexpr unsigned kReady = 0xffffu;  // the step of the factor's last barrier

constexpr int kClusterBlocks = 8;  // B1's cluster (ops/potrf.py: CLUSTER_BLOCKS)

// B1's gate (ops/potrf.py: cluster_fits): the team body takes a tile whose
// rows fit a block at B1's cluster of 8 and whose one-block panel is 32
template <typename T>
__host__ __device__ inline bool cluster_fits(int n) {
  return dlaf_potrf::panel_width<T>(n) == dlaf_potrf::kPw &&
         dlaf_potrf::cluster_elems(n, kClusterBlocks) * sizeof(T) <= dlaf_potrf::kSmemLimit;
}

// the factor's team at G blocks a launch: FB blocks, 0 for the one-block
// body, -1 when the card's geometry cannot give B1's gate its 8 blocks
template <typename T>
__host__ __device__ inline int factor_blocks(int n, int G) {
  if (!cluster_fits<T>(n)) return 0;
  const int fb = G < kFactorBlocks ? G : kFactorBlocks;
  return fb >= kClusterBlocks ? fb : -1;
}

template <typename T>
__host__ __device__ inline size_t factor_smem(int n, int fb) {
  return fb > 0 ? dlaf_potrf::cluster_elems(n, fb) * sizeof(T) : dlaf_potrf::smem_bytes<T>(n);
}

// The solve: B2's body at NKB = 16 column blocks (nb <= 512) and RW rows a
// warp, 2 (f32) or 1 (f64): half of what B2's own kernel takes, so that its
// sums (RW x 16 a lane) leave room in the 128 registers a thread of a
// 512-thread block has for the send's state; the factor's row work runs
// out of line (potrf.cuh: the *_call functions).  ptxas: no spills.  Any RW
// gives the same bits.  Tiles wider than 512 take the unfused path
// (ops/panel_exchange.py: FUSED_MAX_NB).
constexpr int kNkb = 16;
constexpr int kMaxNb = kNkb * dlaf_panel_trsm::kW;
template <typename T>
__host__ __device__ constexpr int rows_per_warp() {
  return sizeof(T) == 4 ? 2 : 1;
}

template <typename T>
__host__ __device__ inline size_t solve_smem(int nb) {
  return dlaf_panel_trsm::rows_smem_bytes<T, rows_per_warp<T>()>(nb, kThreads / 32);
}

// the first chunk of ring position q's share of nc chunks over P positions
// (nc * P stays far inside an int: nc <= ltr * nb / 16)
__host__ __device__ inline int share_lo(int nc, int q, int P) { return nc * q / P; }

struct Bound {
  int* err;            // the grid's sticky error word
  u64 timeout_ns;      // every spin's bound
};

// This thread: ring.cuh's wait_ge under the bound.
__device__ inline bool wait_ge(const u64* flag, u64 target, const Bound& bd, int code) {
  return dlaf_ring::wait_ge(flag, target, bd.err, bd.timeout_ns, code);
}

// Block-uniform: thread 0 waits for one flag.
__device__ inline bool block_wait(const u64* flag, u64 target, const Bound& bd, int code) {
  int ok = 1;
  if (threadIdx.x == 0) {
    ok = wait_ge(flag, target, bd, code);
    __threadfence();
  }
  return __syncthreads_and(ok) != 0;
}

// A barrier of n blocks, this one at index me of the flag array: every
// write of this block before it is visible to the others after it.
// Thread 0 stores this block's flag; the lanes of warp 0 wait for the
// others' in parallel.  Block-uniform result.
__device__ inline bool team_barrier(u64* flags, int n, int me, u64 value, const Bound& bd,
                                    int code) {
  __syncthreads();
  if (threadIdx.x == 0) publish(flags + me, value);
  int ok = 1;
  if (threadIdx.x < 32) {
    for (int q = threadIdx.x; q < n; q += 32)
      if (q != me && !wait_ge(flags + q, value, bd, code)) {
        ok = 0;
        break;
      }
    __threadfence();
  }
  return __syncthreads_and(ok) != 0;
}

// The factor's team: the first cs blocks of the launch, flags [cs] of this
// rank, valued epoch | step.
struct FlagTeam {
  static constexpr bool kDsmem = false;
  int cs, me;
  u64* flags;
  u64 epoch;
  unsigned step;
  Bound bd;
  __device__ bool sync() {
    return team_barrier(flags, cs, me, epoch | ++step, bd, dlaf_ring::kErrFactor);
  }
};

// The factor of the tile a (lower triangle read) into lkk by the G blocks
// of this launch: the team body on the first fb blocks (0: the one-block
// body in block 0), then a barrier over all G blocks, after which every
// block may read lkk.  flags [G] of this rank, at steps above step0; dscr
// [32][32] of this rank; smem holds factor_smem<T>(n, fb).  a is read
// through L2 by the team body.  Block-uniform; false when a wait ran out.
template <typename T>
__device__ bool factor_stage(const T* a, T* lkk, int n, int fb, u64* flags, u64 epoch,
                             unsigned step0, T* dscr, const Bound& bd, unsigned char* smem) {
  const int b = blockIdx.x;
  if (fb > 0) {
    if (b < fb) {
      FlagTeam tm{fb, b, flags, epoch, step0, bd};
      if (!dlaf_potrf::factor_team<T>(tm, a, lkk, n, dscr, smem)) return false;
    }
  } else if (b == 0) {
    dlaf_potrf::factor_tile<T, kThreads>(a, lkk, n, dlaf_potrf::panel_width<T>(n),
                                         reinterpret_cast<T*>(smem));
  }
  return team_barrier(flags, gridDim.x, b, epoch | kReady, bd, dlaf_ring::kErrFactor);
}

// The panel of one ring: the root's panel, every position's output.
template <typename T>
struct Send {
  const T* xc;          // the root's panel: tile i at xc + i * xstride
  long long xstride;    // elements from one of the root's tiles to the next
  T* cp[kMaxRanks];     // every ring position's output panel [ltr][nb][nb]
  const int* below;     // [ltr]: the tiles solved (the others are zeros)
  u64* chunk;           // [ltr * runs]: this ring's chunk flags
  int ltr, nb, P, me, root;
};

// dst[0, n) = src[0, n) by the block, 16 bytes a thread and 4 in flight,
// src through L2 (another rank's output; B5's pull copies with it too);
// n * sizeof(T) % 16 == 0 and both 16-byte aligned
template <typename T>
__device__ inline void copy_l2(T* __restrict__ dst, const T* __restrict__ src, long long n) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  const long long n4 = n * (long long)sizeof(T) / 16, nt = blockDim.x;
  for (long long i = threadIdx.x; i < n4; i += 4 * nt) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * nt < n4) v[u] = __ldcg(s4 + i + u * nt);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * nt < n4) d4[i + u * nt] = v[u];
  }
}

// Steps 2 and 3 on this block, once lkk is written: this position's share
// of the root's chunks solved into its cp (after the flag src_flag, that
// the root's panel is written, reaches src_target), a flag per chunk; the
// zeros; then the other positions' chunks pulled as their flags go up.
// sidx holds ltr + 1 ints of shared memory, work solve_smem<T>(nb) bytes.
// Block-uniform; false when a wait ran out.
template <typename T>
__device__ bool solve_send(const Send<T>& s, const T* __restrict__ lkk, const u64* src_flag,
                           u64 src_target, u64 epoch, const Bound& bd, int* sidx, T* work) {
  constexpr int RW = rows_per_warp<T>();
  const int b = blockIdx.x, G = gridDim.x, tid = threadIdx.x;
  const int C = (int)(blockDim.x / 32) * RW;
  const int runs = (s.nb + C - 1) / C;
  const long long tile = (long long)s.nb * s.nb;
  if (tid == 0) {  // the solved tiles in order
    int n = 0;
    for (int i = 0; i < s.ltr; ++i)
      if (s.below[i]) sidx[n++] = i;
    sidx[s.ltr] = n;
  }
  __syncthreads();
  const int nc = sidx[s.ltr] * runs;
  const int lo = share_lo(nc, s.me, s.P), hi = share_lo(nc, s.me + 1, s.P);
  const bool vec = reinterpret_cast<size_t>(lkk) % 16 == 0;

  // 2. this position's share, as B2 solves it
  if (lo + b < hi && !block_wait(src_flag, src_target, bd, dlaf_ring::kErrEntry)) return false;
  for (int k = lo + b; k < hi; k += G) {
    const int i = sidx[k / runs], r0 = k % runs * C;
    dlaf_panel_trsm::solve_rows<T, kNkb, RW>(lkk, s.xc + i * s.xstride, s.cp[s.me] + i * tile,
                                             s.nb, s.nb, vec, work, r0);
    __syncthreads();  // every warp's rows are written (and the stages free)
    if (tid == 0) publish(s.chunk + k, epoch | 1);
  }
  // the tiles not below the diagonal: zeros
  for (int q = b; q < s.ltr * runs; q += G) {
    const int i = q / runs, r0 = q % runs * C;
    if (s.below[i]) continue;
    T* z = s.cp[s.me] + i * tile + (long long)r0 * s.nb;
    const int n = min(C, s.nb - r0) * s.nb;
    for (int e = tid; e < n; e += blockDim.x) z[e] = T(0);
  }
  // 3. every other position's chunks, round j of each share in turn
  const int most = (nc + s.P - 1) / s.P;  // the largest share
  for (int j = b; j < most; j += G) {
    for (int dq = 1; dq < s.P; ++dq) {
      const int q = (s.me + dq) % s.P;
      const int k = share_lo(nc, q, s.P) + j;
      if (k >= share_lo(nc, q + 1, s.P)) continue;
      if (!block_wait(s.chunk + k, epoch | 1, bd, dlaf_ring::kErrChunk)) return false;
      const int i = sidx[k / runs], r0 = k % runs * C;
      const long long off = i * tile + (long long)r0 * s.nb;
      copy_l2(s.cp[s.me] + off, s.cp[q] + off, (long long)min(C, s.nb - r0) * s.nb);
    }
  }
  return true;
}

}  // namespace dlaf_fsend
