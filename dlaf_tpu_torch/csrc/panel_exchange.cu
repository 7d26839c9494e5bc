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
// The hop ring (ring_kernel, B5's reference kernel; the consume rings of
// csrc/consume.cu, B6 and B8's consume phase, run the same protocol): in
// P - 1 unidirectional hops each rank
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
// flag round trip in place of P - 1.
//
// B7, the fused factor-and-send (fused_kernel): the body of
// csrc/factor_send.cuh, shared with B8's tail.  Every rank factors the
// broadcast diagonal tile with B1's cluster body on the blocks of its
// launch (flag-synchronised, not a thread-block cluster: factor_send.cuh
// says why), the root's panel below the diagonal is solved with B2's body
// in P shares, one per rank of the ring, and every rank pulls the chunks it
// did not solve from the rank that did; B5's exit barrier.  So lkk and cp
// carry B1's and B2's bits, and no landing slot or hop is left.

#include <cuda_runtime.h>

#include <cstdint>

#include "factor_send.cuh"
#include "potrf.cuh"
#include "ring.cuh"

namespace {

using namespace dlaf_ring;

constexpr int kMergeThreads = 256;
constexpr int kRingThreads = 256;
constexpr int kFusedThreads = 512;
constexpr int kPullThreads = 512;
constexpr int kPullMaxRanks = 32;  // ranks of a ring (a grid has at most 30)
static_assert(kFusedThreads == dlaf_fsend::kThreads, "B7's blocks are the body's");

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

// Thread 0: store this block's flag of `phase`, then wait for the same
// block's flag of every other rank of the ring.
__device__ inline bool barrier_all(u64* flags, u64 phase, const Pull& p, int code) {
  const int b = blockIdx.x, G = gridDim.x;
  publish(&flags[(long long)p.me * G + b], p.epoch | phase);
  for (int q = 1; q < p.P; ++q)
    if (!wait_ge(&flags[(long long)((p.me + q) % p.P) * G + b], p.epoch | phase, p.err,
                 p.timeout_ns, code))
      return false;
  return true;
}

// dst[a0, a1) = src[a0, a1), a0 and a1 multiples of 4 words when vec.
__device__ inline void pull_range(u32* __restrict__ dst, const u32* __restrict__ src,
                                  long long a0, long long a1, bool vec) {
  if (vec) {
    dlaf_fsend::copy_l2(dst + a0, src + a0, a1 - a0);
  } else {
    for (long long i = a0 + threadIdx.x; i < a1; i += blockDim.x) dst[i] = __ldcg(src + i);
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

template <typename T>
struct Fused {
  dlaf_fsend::Send<T> s;  // the root's panel, every position's cp, the chunk flags
  const T* d;             // the broadcast diagonal tile
  T* lkk;                 // its factor
  u64* entry;             // the ring's root flag: the root's launch has begun
  u64* done;              // [P][G] the exit barrier
  u64* fflags;            // [G] this rank's factor barrier
  T* dscr;                // [32][32] this rank's diagonal-block scratch
  dlaf_fsend::Bound bd;
  u64 epoch;              // this call's epoch << 16
  int fb;                 // the factor's team (0: the one-block body)
  size_t work;            // bytes of shared work area before the int scratch
};

// One launch per rank of the column ring (csrc/factor_send.cuh): the
// factor of d into lkk on this launch's blocks, this rank's share of the
// root's panel below the diagonal solved into its cp against it, the other
// shares pulled, the exit barrier.
template <typename T>
__global__ void __launch_bounds__(kFusedThreads)
fused_kernel(const Fused<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* sidx = reinterpret_cast<int*>(smem_raw + a.work);
  const int b = blockIdx.x, G = gridDim.x;
  // the root's launch has begun, so its stream has written its panel
  if (a.s.me == a.s.root && b == 0 && threadIdx.x == 0) publish(a.entry, a.epoch | 1);
  if (!dlaf_fsend::factor_stage<T>(a.d, a.lkk, a.s.nb, a.fb, a.fflags, a.epoch, 0, a.dscr, a.bd,
                                   smem_raw))
    return;
  if (!dlaf_fsend::solve_send<T>(a.s, a.lkk, a.entry, a.epoch | 1, a.epoch, a.bd, sidx,
                                      reinterpret_cast<T*>(smem_raw)))
    return;
  dlaf_fsend::team_barrier(a.done, a.s.P * G, a.s.me * G + b, a.epoch | 2, a.bd, kErrDone);
}

// bytes of B7's shared work area (the factor's or the solve's, the larger)
// and of the whole block (the work area, then the solved-tile list)
template <typename T>
size_t fused_work(int nb, int fb) {
  size_t w = dlaf_fsend::factor_smem<T>(nb, fb);
  const size_t solve = dlaf_fsend::solve_smem<T>(nb);
  if (solve > w) w = solve;
  return (w + 15) / 16 * 16;
}

// Done once per instantiation: its dynamic shared memory opted in at the
// most a block may take, so that no rank thread's launch changes the
// attribute while another's is between its check and its start.
template <typename T>
cudaError_t fused_setup() {
  static const cudaError_t e = cudaFuncSetAttribute(
      fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dlaf_potrf::kSmemLimit);
  return e;
}

// blocks of B7 an SM holds at tile side nb and ltr tiles (0: none), or a
// negated CUDA error
template <typename T>
int fused_per_sm(int nb, int ltr, int G, size_t* smem_out) {
  const int fb = dlaf_fsend::factor_blocks<T>(nb, G);
  if (fb < 0) return -(int)cudaErrorInvalidConfiguration;
  const size_t smem = fused_work<T>(nb, fb) + ((size_t)ltr + 1) * sizeof(int);
  if (smem > dlaf_potrf::kSmemLimit) return -(int)cudaErrorInvalidValue;
  cudaError_t e = fused_setup<T>();
  if (e != cudaSuccess) return -(int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel<T>, kFusedThreads,
                                                   smem);
  if (e != cudaSuccess) return -(int)e;
  if (smem_out) *smem_out = smem;
  return per_sm;
}

template <typename T>
int launch_fused(Fused<T>& a, int G, void* stream) {
  a.fb = dlaf_fsend::factor_blocks<T>(a.s.nb, G);
  a.work = fused_work<T>(a.s.nb, a.fb);
  size_t smem = 0;
  const int per_sm = fused_per_sm<T>(a.s.nb, a.s.ltr, G, &smem);
  if (per_sm < 0) return -per_sm;
  // every block spins on the others: each must fit an SM on its own
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  fused_kernel<T><<<G, kFusedThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int fused_factor_bcast(const void* d, const void* xc_root, const void* const* cps,
                       const void* below, void* lkk, int nb, int ltr, int root, void* flags,
                       void* scratch, void* err, int P, int me, int G, u64 epoch, u64 timeout_ns,
                       void* stream) {
  if (nb <= 0 || nb % dlaf_panel_trsm::kW || nb > dlaf_fsend::kMaxNb || ltr <= 0 ||
      G <= 0 || P < 1 || P > dlaf_fsend::kMaxRanks || me < 0 || me >= P || root < 0 ||
      root >= P || dlaf_potrf::panel_width<T>(nb) == 0)
    return (int)cudaErrorInvalidValue;
  Fused<T> a;
  a.s.xc = static_cast<const T*>(xc_root);
  a.s.xstride = (long long)nb * nb;
  for (int q = 0; q < dlaf_fsend::kMaxRanks; ++q) {
    a.s.cp[q] = q < P ? static_cast<T*>(const_cast<void*>(cps[q])) : nullptr;
    if (q < P && reinterpret_cast<size_t>(cps[q]) % 16) return (int)cudaErrorMisalignedAddress;
  }
  if (reinterpret_cast<size_t>(lkk) % 16 || reinterpret_cast<size_t>(d) % 16)
    return (int)cudaErrorMisalignedAddress;
  a.s.below = static_cast<const int*>(below);
  u64* f = static_cast<u64*>(flags);
  a.entry = f;
  a.done = f + 1;
  a.fflags = a.done + (long long)P * G + (long long)me * G;
  a.s.chunk = a.done + 2LL * P * G;
  a.s.ltr = ltr;
  a.s.nb = nb;
  a.s.P = P;
  a.s.me = me;
  a.s.root = root;
  a.d = static_cast<const T*>(d);
  a.lkk = static_cast<T*>(lkk);
  a.dscr = static_cast<T*>(scratch) + (long long)me * dlaf_potrf::kPw * dlaf_potrf::kPw;
  a.bd = dlaf_fsend::Bound{static_cast<int*>(err), timeout_ns};
  a.epoch = epoch;
  return launch_fused<T>(a, G, stream);
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

// B7: this rank's launch of the fused factor-and-send on a ring of P
// positions: d [nb][nb], the root's panel xc_root [ltr][nb][nb], cps a host
// array of the P positions' outputs [ltr][nb][nb] (device pointers),
// below [ltr] int; flags of fused_flag_words() 64-bit words (ops/
// panel_exchange.py: entry 1, done [P][G], the factor's barriers [P][G],
// the chunk flags [ltr][ceil(nb / 16)]) and scratch of P x 32 x 32
// elements, both the ring's, zero at first and never reset.
int dlaf_fused_factor_bcast_f32(const void* d, const void* xc_root, const void* const* cps,
                                const void* below, void* lkk, int nb, int ltr, int root,
                                void* flags, void* scratch, void* err, int P, int me, int G,
                                unsigned long long epoch, unsigned long long timeout_ns,
                                void* stream) {
  return fused_factor_bcast<float>(d, xc_root, cps, below, lkk, nb, ltr, root, flags, scratch,
                                   err, P, me, G, epoch, timeout_ns, stream);
}

int dlaf_fused_factor_bcast_f64(const void* d, const void* xc_root, const void* const* cps,
                                const void* below, void* lkk, int nb, int ltr, int root,
                                void* flags, void* scratch, void* err, int P, int me, int G,
                                unsigned long long epoch, unsigned long long timeout_ns,
                                void* stream) {
  return fused_factor_bcast<double>(d, xc_root, cps, below, lkk, nb, ltr, root, flags, scratch,
                                    err, P, me, G, epoch, timeout_ns, stream);
}

// B7's occupancy at a shape: out[0] its blocks per SM (or a negated CUDA
// error), out[1] its factor's team (blocks; 0 for the one-block body),
// out[2] its dynamic shared memory in bytes.
int dlaf_fused_occupancy(int f64, int nb, int ltr, int G, int* out) {
  size_t smem = 0;
  out[0] = f64 ? fused_per_sm<double>(nb, ltr, G, &smem) : fused_per_sm<float>(nb, ltr, G, &smem);
  out[1] = f64 ? dlaf_fsend::factor_blocks<double>(nb, G) : dlaf_fsend::factor_blocks<float>(nb, G);
  out[2] = (int)smem;
  return 0;
}

}  // extern "C"
