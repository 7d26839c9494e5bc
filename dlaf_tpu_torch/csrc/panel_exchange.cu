// The ring kernels of the 'pallas' collectives tier: the hop merge (B4),
// the one-contributor exchange (B5: the pull kernel on every path, and the
// hop ring it replaced, kept as the reference of its before/after check)
// and the fused factor-and-send of the lookahead Cholesky panel (B7).
//
// Replaces dlaf_tpu/ops/pallas_panel_exchange.py: merge_hop
// [_merge_kernel], dma_ring_exchange [_dma_ring_kernel, _ring_hops] and
// fused_factor_bcast [_fused_kernel].
//
// The ranks of a grid are threads of one process, each with its own CUDA
// stream on the one card (dlaf_tpu_torch/comm/_ranks.py).  An exchange of
// P ranks along a grid axis runs one launch per rank, all at the same time.
// Each rank carries a (payload, have) pair.  The result of the TPU's ring
// is, for each slot: this rank's bytes where it has the slot, else the
// bytes of its nearest upstream rank that has it (me - 1, me - 2, ...
// around the ring), and have = the OR over the ring.  A pure select: the
// result is bit-identical to the v2 doubling chain and to the psum tier.
// The payload travels as 32-bit words, whatever its dtype (complex and
// float64 payloads are bit-preserving word views).
//
// B5, the pull.  A rank reads its peers' inputs where they lie:
//   entry barrier: store my entry flag, wait for the entry flags of every
//     rank of the ring (a started kernel means that rank's stream has
//     written its input; the device pointers of every rank's input words
//     and have mask were exchanged on the host at the ring's rendezvous);
//   pick each slot's source rank from the P have masks;
//   copy the chosen bytes once into my output (16-byte loads, several in
//     flight per thread);
//   store my done flag and wait for the done flags of every rank of the
//     ring before exiting: a rank's stream may reuse its input as soon as
//     its kernel ends, so this exit barrier is what makes the pull safe.
// Block b of every rank copies the same segments, so the flags are per
// block and rank, and block b's cover every read of those segments.
//
// The hop ring (ring_kernel; B7 and the consumers of csrc/consume.cu, B6
// and B8, run the same protocol): in P - 1 unidirectional hops each rank
// sends its pair into its downstream neighbour's landing slot s % 2 and
// merges what its upstream neighbour sent into its own:
//     take = !have && have_in;  y = take ? y_in : y;  have |= have_in.
//   entry barrier: store my entry flag, wait for both neighbours' (their
//     kernels run, and their previous call on this ring is over, so the
//     persistent landing slots may be written);
//   hop s: (s >= 2) wait for the downstream rank's ack of my hop s - 2
//     copy out of slot s % 2; write the accumulator into the downstream
//     rank's slot s % 2, fence, release-store its recv flag; acquire-wait
//     for my own recv flag of hop s; merge; (s + 2 < P - 1) release-store
//     my ack for the upstream writer.
// Send before wait on every rank, and every wait is on an event earlier in
// the global hop order, so a delayed rank stalls its neighbours, never a
// cycle.  Each block runs an independent ring over its own segments of the
// payload (segments b, b + G, b + 2G, ... of `seg` words), with its own
// flags and its own copy of `have` in shared memory.  The protocol's code
// (the Ring, its waits and ring_hops) is csrc/ring.cuh.
//
// Both: flags never reset: a flag's value is (epoch << 16) | phase (the
// hop + 1 in the ring, 1 and 2 for the pull's two barriers), the epoch
// growing by one per call of the collective (every rank calls them in the
// same SPMD order, so the epochs agree), and a wait is "flag >= target".
// No reset can race a late reader.  Every rank of a collective launches
// the same number of blocks G, and G * (ranks of the grid) stays within
// the card's SMs, so all launches of a grid can be resident at once next
// to other work: a spinning block never waits for a block that cannot be
// scheduled.  Every spin polls %globaltimer against a bound (a few
// seconds); when it runs out the block sets the grid's sticky error word
// and exits, and a spinning block also exits when it finds the word set
// (by another block, or by the host when a rank thread failed).  The host
// reads the word at the end of every algorithm call and raises
// DeadlineExceededError.  A hang is a failure, never a wait.
//
// Scope: thread_scope_device, as every rank of a ring shares one card.
// Spread over several cards (ROADMAP A10), the ring needs peer access to
// the landing slots and the pull peer-mapped inputs, and both need
// thread_scope_system flags.
//
// What bounds them on the H100: bytes.  A hop moves the accumulator into
// the neighbour's slot and merges it back, so the hop ring moves about
// 2 (P - 1) + 2 times the payload per rank through HBM; the pull moves
// the 2 payloads per rank (read the input, write the output) that any
// one-card implementation must move, keeps no landing slots, and has one
// flag round trip in place of P - 1.  B7 adds B1's and B2's work, in their
// own block bodies (potrf.cuh, panel_trsm.cuh), so its factor and panel
// carry B1's and B2's bits.

#include <cuda_runtime.h>

#include <cstdint>

#include "panel_trsm.cuh"
#include "potrf.cuh"
#include "ring.cuh"

namespace {

using namespace dlaf_ring;

constexpr int kMergeThreads = 256;
constexpr int kRingThreads = 256;
constexpr int kFusedThreads = 512;
constexpr int kPullThreads = 512;
constexpr int kPullUnroll = 4;     // 16-byte loads in flight per thread
constexpr int kPullMaxRanks = 32;  // ranks of a ring (a grid has at most 30)
constexpr int kErrDone = 6;        // the pull's exit barrier ran out

// ---------------------------------------------------------------- B4
//
// merge_select_kernel, the hop merge B4 launches: a grid of (slot, chunk)
// blocks, so a block reads its slot's two have words once and decides
// `take` once, divides nothing, and reads only the payload it keeps (y_in
// where take, else y): two payloads of traffic (the kept one and the
// output), not three.  A chunk is kMergeUnroll 16-byte words a thread, all
// loads issued before the stores.  Where the three bases are 16-byte
// aligned a slot's words are a head of up to 3 words up to its first
// 16-byte boundary, 16-byte vectors, and a tail of up to 3 words (a ragged
// w, w % 4 != 0, gives every slot a head or a tail); else every word is an
// element access.  Chunk 0 writes the slot's have.  A pure select: bit for
// bit its plain version (ops/panel_exchange.py's merge_hop_plain).

constexpr int kMergeUnroll = 4;
constexpr long long kMergeChunk = (long long)kMergeThreads * kMergeUnroll;  // vectors

__global__ void __launch_bounds__(kMergeThreads)
merge_select_kernel(const u32* __restrict__ y, const u32* __restrict__ y_in,
                    const int* __restrict__ h, const int* __restrict__ h_in, u32* __restrict__ oy,
                    int* __restrict__ oh, long long w, int vec) {
  const long long slot = blockIdx.x;
  const int have = h[slot], have_in = h_in[slot];
  if (blockIdx.y == 0 && threadIdx.x == 0) oh[slot] = have | have_in;
  const long long base = slot * w;
  const u32* src = (hop_take(have, have_in) ? y_in : y) + base;
  u32* dst = oy + base;
  if (!vec) {
    for (long long i = (long long)blockIdx.y * blockDim.x + threadIdx.x; i < w;
         i += (long long)gridDim.y * blockDim.x)
      dst[i] = __ldg(src + i);
    return;
  }
  const long long head = min((long long)((4 - (base & 3)) & 3), w);
  const long long nvec = (w - head) >> 2;
  const long long tail = w - head - 4 * nvec;
  if (blockIdx.y == 0) {
    if (threadIdx.x < head) dst[threadIdx.x] = __ldg(src + threadIdx.x);
    const long long t = (long long)threadIdx.x - 32;  // the tail: threads 32 .. 34
    if (t >= 0 && t < tail) dst[head + 4 * nvec + t] = __ldg(src + head + 4 * nvec + t);
  }
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (long long v0 = (long long)blockIdx.y * kMergeChunk; v0 < nvec;
       v0 += (long long)gridDim.y * kMergeChunk) {
    uint4 part[kMergeUnroll];
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) {
      const long long i = v0 + (long long)u * blockDim.x + threadIdx.x;
      if (i < nvec) part[u] = __ldg(s4 + i);
    }
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) {
      const long long i = v0 + (long long)u * blockDim.x + threadIdx.x;
      if (i < nvec) d4[i] = part[u];
    }
  }
}

// ---------------------------------------------------------------- B5

__global__ void __launch_bounds__(kRingThreads)
ring_kernel(Ring r, const int* __restrict__ h, int* __restrict__ oh) {
  extern __shared__ int sh[];
  int* sh_have = sh;
  int* sh_hin = sh + r.slots;
  int* sh_ok = sh + 2 * r.slots;
  for (int i = threadIdx.x; i < r.slots; i += blockDim.x) sh_have[i] = h[i];
  copy_segments(r.acc, r.y, r);  // the accumulator starts as this rank's payload
  __syncthreads();
  if (!ring_hops(r, sh_have, sh_hin, sh_ok)) return;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < r.slots; i += blockDim.x) oh[i] = sh_have[i];
}

// ---------------------------------------------------------- B5 (pull)

struct Pull {
  const u32* y[kPullMaxRanks];  // every ring position's input words
  const int* h[kPullMaxRanks];  // every ring position's have [slots]
  u32* out;                     // this rank's output words
  int* oh;                      // this rank's output have [slots]
  u64* entry;                   // [P][G]
  u64* done;                    // [P][G]
  int* err;                     // the grid's sticky error word
  long long total, w, seg;      // payload words, words per slot, per segment
  int slots, P, me, vec;        // vec: 16-byte accesses are aligned
  u64 epoch, timeout_ns;        // this call's epoch << 16; the spins' bound
};

// Thread 0: wait until *flag >= target, bounded as ring.cuh's wait_flag.
__device__ inline bool wait_until(u64* flag, u64 target, const Pull& p, int code) {
  flag_ref f(*flag);
  err_ref e(*p.err);
  const u64 t0 = globaltimer();
  while (f.load(cuda::memory_order_acquire) < target) {
    if (e.load(cuda::memory_order_relaxed) != 0) return false;
    if (globaltimer() - t0 > p.timeout_ns) {
      int zero = 0;
      e.compare_exchange_strong(zero, code, cuda::memory_order_relaxed);
      return false;
    }
    __nanosleep(128);
  }
  return true;
}

// Thread 0: store this block's flag of `phase`, then wait for the same
// block's flag of every other rank of the ring.
__device__ inline bool barrier_all(u64* flags, u64 phase, const Pull& p, int code) {
  const int b = blockIdx.x, G = gridDim.x;
  publish(&flags[(long long)p.me * G + b], p.epoch | phase);
  for (int q = 1; q < p.P; ++q)
    if (!wait_until(&flags[(long long)((p.me + q) % p.P) * G + b], p.epoch | phase, p, code))
      return false;
  return true;
}

// dst[a0, a1) = src[a0, a1), a0 and a1 multiples of 4 words when vec.
__device__ inline void pull_range(u32* __restrict__ dst, const u32* __restrict__ src,
                                  long long a0, long long a1, bool vec) {
  const long long nt = blockDim.x;
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src + a0);
    uint4* d4 = reinterpret_cast<uint4*>(dst + a0);
    const long long n4 = (a1 - a0) / 4;
    for (long long i = threadIdx.x; i < n4; i += kPullUnroll * nt) {
      uint4 v[kPullUnroll];
#pragma unroll
      for (int u = 0; u < kPullUnroll; ++u)
        if (i + u * nt < n4) v[u] = __ldcg(s4 + i + u * nt);
#pragma unroll
      for (int u = 0; u < kPullUnroll; ++u)
        if (i + u * nt < n4) d4[i + u * nt] = v[u];
    }
  } else {
    for (long long i = a0 + threadIdx.x; i < a1; i += nt) dst[i] = __ldcg(src + i);
  }
}

__global__ void __launch_bounds__(kPullThreads)
pull_kernel(const Pull p) {
  extern __shared__ int sh[];
  int* sh_src = sh;  // [slots]: the ring position each slot is read from
  int* sh_ok = sh + p.slots;
  const int b = blockIdx.x, G = gridDim.x;
  bool ok = true;
  if (threadIdx.x == 0) {
    ok = barrier_all(p.entry, 1, p, kErrEntry);
    __threadfence();
  }
  if (!block_ok(ok, sh_ok)) return;
  // each slot's source: this rank where it has the slot, else the nearest
  // upstream rank that has it, else this rank (the select of every hop of
  // the ring, take = !have && have_in, folded over me - 1, me - 2, ...)
  for (int s = threadIdx.x; s < p.slots; s += blockDim.x) {
    int src = p.me, have = __ldcg(p.h[p.me] + s), any = have;
    for (int q = 1; q < p.P; ++q) {
      const int r = (p.me + p.P - q) % p.P;
      const int hq = __ldcg(p.h[r] + s);
      if (hop_take(have, hq)) {
        src = r;
        have = hq;
      }
      any |= hq;
    }
    sh_src[s] = src;
    if (b == 0) p.oh[s] = any;
  }
  __syncthreads();
  for (long long lo = (long long)b * p.seg; lo < p.total; lo += (long long)G * p.seg) {
    const long long hi = min(lo + p.seg, p.total);
    for (long long s = lo / p.w; s * p.w < hi; ++s)
      pull_range(p.out, p.y[sh_src[s]], max(lo, s * p.w), min(hi, (s + 1) * p.w), p.vec);
  }
  __syncthreads();  // every read of the peers' inputs by this block is done
  if (threadIdx.x == 0) barrier_all(p.done, 2, p, kErrDone);
}

// ---------------------------------------------------------------- B7

// One launch per rank of the column ring: block 0 factors the (broadcast)
// diagonal tile d into lkk with B1's body and publishes it through `ready`;
// on the root rank every block then solves its strips of the panel xc
// against lkk with B2's body, writing zeros for the strips of tiles that
// are not below the diagonal (below[tile] == 0); the other ranks'
// contributions are masked out entirely (have = 0), so they solve nothing.
// Then each block runs the ring over its strips (segment = one strip), so
// the root's masked panel reaches every rank of the column ring.
template <typename T, int R>
__global__ void __launch_bounds__(kFusedThreads)
fused_kernel(Ring r, const T* __restrict__ d, const T* __restrict__ xc,
             const int* __restrict__ below, T* __restrict__ lkk, int nb, int pw, int is_root,
             u64* ready, size_t work_smem) {
  extern __shared__ unsigned char smem_raw[];
  T* work = reinterpret_cast<T*>(smem_raw);
  int* sh_have = reinterpret_cast<int*>(smem_raw + work_smem);
  int* sh_hin = sh_have + 1;
  int* sh_ok = sh_have + 2;
  T* cp = reinterpret_cast<T*>(r.acc);
  const long long rows = r.total * (long long)sizeof(u32) / sizeof(T) / nb;

  if (blockIdx.x == 0) {
    dlaf_potrf::factor_tile<T, kFusedThreads>(d, lkk, nb, pw, work);
    __syncthreads();
    if (threadIdx.x == 0) publish(ready + r.me, r.epoch);
  }
  if (is_root) {
    bool ok = blockIdx.x == 0 || threadIdx.x != 0 ||
              wait_flag(ready + r.me, r.epoch, r, kErrFactor);
    if (!block_ok(ok, sh_ok)) return;
    if (threadIdx.x == 0) __threadfence();
    const long long strips = (rows + R - 1) / R;
    for (long long st = blockIdx.x; st < strips; st += gridDim.x) {
      if (below[(st * R) / nb]) {
        dlaf_panel_trsm::solve_strip<T, R, kFusedThreads>(lkk, xc, cp, rows, nb, st, work);
      } else {
        for (long long i = threadIdx.x; i < (long long)R * nb; i += blockDim.x) cp[st * R * nb + i] = T(0);
      }
    }
  }
  if (threadIdx.x == 0) *sh_have = is_root;
  __syncthreads();
  ring_hops(r, sh_have, sh_hin, sh_ok);
}


template <typename T, int R>
int launch_fused(const void* d, const void* xc, const void* below, void* lkk, void* cp, int nb,
                 long long rows, int is_root, void* ready, void* land, void* land_h, void* entry,
                 void* rflag, void* aflag, void* err, int P, int me, int G, u64 epoch,
                 u64 timeout_ns, void* stream) {
  const int pw = dlaf_potrf::panel_width<T>(nb);
  if (pw == 0 || nb % dlaf_panel_trsm::kW || rows % nb || G <= 0) return (int)cudaErrorInvalidValue;
  size_t work = dlaf_potrf::smem_bytes<T>(nb);
  const size_t trsm = dlaf_panel_trsm::smem_bytes<T, R>(nb);
  if (trsm > work) work = trsm;
  work = (work + 15) / 16 * 16;
  const size_t smem = work + 16;
  if (smem > dlaf_potrf::kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fused_kernel<T, R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long total = rows * nb * (long long)sizeof(T) / 4;
  const long long seg = (long long)R * nb * sizeof(T) / 4;  // one strip
  Ring r = make_ring(cp, cp, land, land_h, entry, rflag, aflag, err, total, total, 1, seg, P, me,
                     epoch, timeout_ns);
  fused_kernel<T, R><<<G, kFusedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      r, static_cast<const T*>(d), static_cast<const T*>(xc), static_cast<const int*>(below),
      static_cast<T*>(lkk), nb, pw, is_root, static_cast<u64*>(ready), work);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B4: one hop merge on the wire layout; payload as 32-bit words.
int dlaf_merge_hop(const void* y, const void* y_in, const void* h, const void* h_in, void* oy,
                   void* oh, long long total, long long w, int slots, void* stream) {
  if (total <= 0 || w <= 0 || slots <= 0) return 0;
  if (total != w * slots) return (int)cudaErrorInvalidValue;
  const int vec = ((reinterpret_cast<std::uintptr_t>(y) | reinterpret_cast<std::uintptr_t>(y_in) |
                    reinterpret_cast<std::uintptr_t>(oy)) % 16) == 0;
  const long long units = vec ? w / 4 : w;  // 16-byte vectors or words of a slot
  long long chunks = (units + kMergeChunk - 1) / kMergeChunk;
  chunks = chunks < 1 ? 1 : chunks > 65535 ? 65535 : chunks;
  merge_select_kernel<<<dim3((unsigned)slots, (unsigned)chunks), kMergeThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u32*>(y), static_cast<const u32*>(y_in), static_cast<const int*>(h),
      static_cast<const int*>(h_in), static_cast<u32*>(oy), static_cast<int*>(oh), w, vec);
  return (int)cudaGetLastError();
}

// B5: this rank's launch of the pull exchange of `total` words in `slots`
// have-slots of `w` words, in G blocks of `seg`-word segments; ys and hs
// are host arrays of the P ring positions' input words and have masks
// (device pointers).
int dlaf_pull_exchange(const void* const* ys, const void* const* hs, void* out, void* oh,
                       void* entry, void* done, void* err, long long total, long long w,
                       int slots, long long seg, int G, int P, int me, unsigned long long epoch,
                       unsigned long long timeout_ns, void* stream) {
  if (total <= 0 || slots <= 0 || G <= 0 || P < 2 || P > kPullMaxRanks || me < 0 || me >= P ||
      total != w * slots || seg <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)slots + 1) * sizeof(int);
  if (smem > dlaf_potrf::kSmemLimit) return (int)cudaErrorInvalidValue;
  // the SMs it spins on keep their whole shared memory for other ranks'
  // kernels (B1's cluster blocks take 200 KB beside it)
  cudaError_t e = cudaFuncSetAttribute(pull_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(pull_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Pull p;
  bool vec = (w % 4 == 0) && (seg % 4 == 0) && (reinterpret_cast<size_t>(out) % 16 == 0);
  for (int q = 0; q < kPullMaxRanks; ++q) {
    p.y[q] = q < P ? static_cast<const u32*>(ys[q]) : nullptr;
    p.h[q] = q < P ? static_cast<const int*>(hs[q]) : nullptr;
    if (q < P) vec = vec && (reinterpret_cast<size_t>(ys[q]) % 16 == 0);
  }
  p.out = static_cast<u32*>(out);
  p.oh = static_cast<int*>(oh);
  p.entry = static_cast<u64*>(entry);
  p.done = static_cast<u64*>(done);
  p.err = static_cast<int*>(err);
  p.total = total;
  p.w = w;
  p.seg = seg;
  p.slots = slots;
  p.P = P;
  p.me = me;
  p.vec = vec;
  p.epoch = epoch;
  p.timeout_ns = timeout_ns;
  pull_kernel<<<G, kPullThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// B5 as the hop ring (the kernel the pull replaced): this rank's launch of
// a ring exchange of `total` words in `slots` have-slots of `w` words, in G
// blocks of `seg`-word segments.
int dlaf_ring_exchange(const void* y, const void* h, void* out, void* oh, void* land, void* land_h,
                       void* entry, void* rflag, void* aflag, void* err, long long total,
                       long long w, int slots, long long seg, int G, int P, int me,
                       unsigned long long epoch, unsigned long long timeout_ns, void* stream) {
  if (total <= 0 || slots <= 0 || G <= 0 || P < 2 || total != w * slots) return (int)cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)slots + 1) * sizeof(int);
  if (smem > dlaf_potrf::kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Ring r = make_ring(y, out, land, land_h, entry, rflag, aflag, err, total, w, slots, seg, P, me,
                     epoch, timeout_ns);
  ring_kernel<<<G, kRingThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      r, static_cast<const int*>(h), static_cast<int*>(oh));
  return (int)cudaGetLastError();
}

int dlaf_fused_factor_bcast_f32(const void* d, const void* xc, const void* below, void* lkk,
                                void* cp, int nb, long long rows, int is_root, void* ready,
                                void* land, void* land_h, void* entry, void* rflag, void* aflag,
                                void* err, int P, int me, int G, unsigned long long epoch,
                                unsigned long long timeout_ns, void* stream) {
  return launch_fused<float, 32>(d, xc, below, lkk, cp, nb, rows, is_root, ready, land, land_h,
                                 entry, rflag, aflag, err, P, me, G, epoch, timeout_ns, stream);
}

int dlaf_fused_factor_bcast_f64(const void* d, const void* xc, const void* below, void* lkk,
                                void* cp, int nb, long long rows, int is_root, void* ready,
                                void* land, void* land_h, void* entry, void* rflag, void* aflag,
                                void* err, int P, int me, int G, unsigned long long epoch,
                                unsigned long long timeout_ns, void* stream) {
  return launch_fused<double, 16>(d, xc, below, lkk, cp, nb, rows, is_root, ready, land, land_h,
                                  entry, rflag, aflag, err, P, me, G, epoch, timeout_ns, stream);
}

}  // extern "C"
