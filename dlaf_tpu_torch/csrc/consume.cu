// The ring consumers of the fused trailing-update tier: the consume ring
// (B6) and the one-launch lookahead Cholesky step (B8).
//
// Replaces dlaf_tpu/ops/pallas_trailing_update.py: dma_ring_consume
// [_dma_ring_consume_kernel, _consume_hops, _apply_update] and fused_step
// [_fused_step_kernel].
//
// B6.  The B5 ring (csrc/ring.cuh) over a row panel [slots][N][K] with
// the trailing update spliced in, the TPU's consume schedule: after the
// entry barrier the rank applies its own slots, and after merging hop s
// out of landing slot s % 2 it applies that hop's fresh slots straight out
// of the landing slot, and only then acks the slot.  The contraction is
// 'iab,jcb->ijac', x[i, j] -= cp[i] @ y[j]^T: output columns c of tile
// (i, j) read rows c of slot j only, so each block updates, for every i,
// the columns of the rows it carries on the ring (a segment is `sr` rows
// of one slot, sr the widest of 64, 32, 16, 8 dividing N), and the only
// dependency between the blocks of a launch is the ring itself.  Each
// output element takes one slot, so applying slots as they land is the sum
// the one-shot update computes; slots suppressed by z (the lookahead's
// narrow column) and slots no rank holds are not applied at all (the TPU's
// first cut multiplies a masked full panel at every hop; for finite cp the
// results are the same, where cp holds Inf or NaN the masked product would
// spread NaN into columns that take no slot).  The rank's own slots are
// applied out of the accumulator, which holds its payload until the first
// merge (the same bytes, on the 16 bytes the update's copies need).
//
// B8.  The whole lookahead body in one launch per rank, spanning both grid
// axes: (1) the consume ring over 'r' as B6, the narrow column k+1
// included (on the ranks of column k+1 its slot is the suppressed one, so
// the bulk and the narrow update together are every slot); then the tail,
// on the factor-and-send body of csrc/factor_send.cuh that B7 runs:
// (2) every rank pulls the diagonal tile of step k+1 straight out of its
// owner's trailing stack into od, once the owner's column k+1 is complete;
// (3) every rank factors it with B1's cluster body on the blocks of its
// launch (flag-synchronised; B1's one-block body where B1's gate takes it);
// (4) the ranks of each ring over 'c' share the panel solve of the ring's
// root's column k+1 (B2's body, masked to the tiles below the diagonal),
// each reading the root's tiles where they lie, and pull the chunks they
// did not solve from the rank that did; an exit barrier over the grid.
// The phases hand over through device-scope flags: a rank of column k+1
// publishes that its column is complete once every block of its launch
// ended phase 1 (p1all), and the ranks that read its tiles wait for it.
// The consume ring keeps its landing slots, flags and entry barrier; the
// tail has no ring of landing slots left.
//
// Both launch 512 threads per block.  At the 'default' tier (NS = 0) a
// segment's update is the body of csrc/consume_gemm.cuh: the column panel
// as one matrix of ltr * M rows in 128 x 64 tiles (f64 64 x 64), one
// cp.async pipeline over the segment's tiles and k slices, both operands
// read through L2 only (landing slots are rewritten by other ranks during
// the launch), with B3's bits (csrc/fma_gemm.cuh): x after B6 is bit for
// bit B3 applied once to the merged panel with the slots not applied set
// to zero.  Under the split tiers the update is the split body of
// csrc/consume_split.cuh (NS = 2 bf16 slices per operand for 'bf16x3' and
// 3 for 'bf16x6'): the segment cut once into its slices and kept in shared
// memory, the column panel streamed by cp.async.cg through four pipelines
// of 32-deep slices cut in place, one per part of 4 warps, mma.sync
// products with one float32 accumulator per term, added in the JAX
// package's order, with B3-split's bits (csrc/split_gemm.cuh): x after B6
// is bit for bit B3-split applied once to the merged panel with the slots
// not applied set to zero.  The slice count is a template parameter of B6
// and of B8's consume phase only: B8's tail is the same code at every tier.  Each rank takes at most SMs / ranks blocks, as every ring
// kernel, so all ranks' launches are resident at once; the launchers refuse
// an instantiation that cannot hold one block on an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
//
// What bounds them on the H100: operations.  At N=16384, nb=512 on a 2x4
// grid one rank's consume update is 16 x 8 tiles of 2 * 512^3 flops (34
// GFlop; 275 GFlop over the grid) against 2 x 128 MiB of trailing matrix:
// 4.1 ms at the 67 TFLOP/s of f32 FMA, 0.83 ms for bf16x3's three products
// at the 989 TFLOP/s of the bf16 tensor cores.  A rank has 16 SMs of the
// card's 132, one 16-warp block on each, so the body keeps its FMA units
// fed with 16-byte operand loads, a register tile of 4 x 4 outputs and four
// stages of copies in flight rather than with more warps.

#include <cuda_runtime.h>

#include <string>

#include "consume_gemm.cuh"
#include "consume_split.cuh"
#include "factor_send.cuh"
#include "potrf.cuh"
#include "ring.cuh"

// the dynamic shared memory of every kernel here: the work area of its
// block bodies, then its int scratch
extern __shared__ __align__(16) unsigned char dlaf_smem[];

namespace {

using namespace dlaf_ring;

constexpr int kThreads = 512;
static_assert(dlaf_consume_split::kThreads == kThreads, "the split body's layout is a block");
static_assert(dlaf_ring_gemm::kThreads == kThreads, "the FMA body's layout is a block");

// bytes of shared memory apply_rows needs: the FMA body's stages (NS = 0)
// or the split body's stages and segment slices at pw columns a pass
template <typename T, int NS>
__host__ __device__ inline size_t gemm_smem(int K, int pw) {
  if constexpr (NS == 0) return dlaf_ring_gemm::Geom<T>::SMEM_BYTES;
  else return dlaf_consume_split::smem_bytes<T, NS>(K, pw);
}

// the split body's columns a pass at depth K, beside `scratch` bytes of
// int scratch in the dynamic shared memory (0 at 'default', or when not
// even 2 columns fit: the launcher refuses)
template <typename T, int NS>
int split_pass_cols(int K, size_t scratch) {
  if constexpr (NS == 0) return 0;
  else return dlaf_consume_split::pass_cols<T, NS>(K, (dlaf_potrf::kSmemLimit - scratch) / 16 * 16);
}

// rows of one ring segment of a [slots][n][k] panel: the widest of 64,
// 32, 16, 8 that divides n, so that no segment crosses a slot (0: none)
__host__ __device__ inline int segment_rows(int n) {
  for (int sr = 64; sr >= 8; sr /= 2)
    if (n % sr == 0) return sr;
  return 0;
}

// the consume geometry: x[i, j] (M x N) -= cp[i] (M x K) @ y[j]^T, y[j] N x K
template <typename T>
struct Panel {
  T* x;          // the trailing stack [ltr][ltc][M][N], updated in place
  const T* cp;   // the column panel [ltr][M][K]
  int ltr, ltc, M, N, K, sr;
  int pw;        // the split body's columns a pass (0 at 'default')
};

// x[i, j][:, r0 : r0 + sr] -= cp[i] @ src[0 : sr, :]^T for every i: the
// trailing contribution of rows [r0, r0 + sr) of panel slot j, `src`
// pointing at row r0 of the slot, at the tier of NS (0: the FMA body of
// consume_gemm.cuh; 2, 3: the split body of consume_split.cuh, in passes of
// p.pw columns), one pipeline over the segment.  Called by every thread of
// the block; `sm` holds gemm_smem<T, NS>(p.K, p.pw) bytes.
template <typename T, int NS>
__device__ void apply_rows(const Panel<T>& p, const T* src, int j, int r0, void* sm) {
  if constexpr (NS != 0) {
    for (int c = 0; c < p.sr; c += p.pw)
      dlaf_consume_split::update_pass<T, NS>(p.x, p.cp, src + (long long)c * p.K, p.ltr, p.ltc,
                                             j, p.M, p.N, p.K, min(p.pw, p.sr - c), r0 + c,
                                             sm);
  } else {
    dlaf_ring_gemm::update_segment<T>(p.x, p.cp, src, p.ltr, p.ltc, j, p.M, p.N, p.K, p.sr, r0,
                                      static_cast<T*>(sm));
  }
}

// The consume schedule's updates, spliced into ring_hops: this block's
// segments of the slots this rank holds on entry (out of the accumulator,
// which holds this rank's payload until the first merge), then after each
// hop's merge its segments of the fresh slots (out of the landing slot),
// each only where sh_apply[slot] is set.
template <typename T, int NS>
struct ConsumeHooks {
  Panel<T> p;
  const u32* acc;   // the accumulator (the block's segments: this rank's payload)
  const u32* land;  // landing slots [P][2][total] of this ring
  long long total;  // the panel's words
  int me;
  // the byte offset in dlaf_smem of have [slots] before the hop's merge,
  // then the hop's incoming have and the apply mask; the update's work
  // area is dlaf_smem's first gemm_smem<T, NS>(p.K, p.pw) bytes
  int sh;

  // segment q is rows [r0, r0 + sr) of slot q / (N / sr): a segment never
  // crosses a slot, so its slot and rows come from int arithmetic on q
  template <bool kFresh>
  __device__ void apply(const u32* base) {
    const int* sh_have = reinterpret_cast<const int*>(dlaf_smem + sh);
    const int* sh_hin = sh_have + p.ltc;
    const int* sh_apply = sh_hin + p.ltc;
    const int per_slot = p.N / p.sr, nseg = p.ltc * per_slot;
    for (int q = blockIdx.x; q < nseg; q += gridDim.x) {
      const int j = q / per_slot, r0 = (q - j * per_slot) * p.sr;
      const bool take = kFresh ? hop_take(sh_have[j], sh_hin[j]) : sh_have[j] != 0;
      if (!take || !sh_apply[j]) continue;
      const T* src = reinterpret_cast<const T*>(base) + (long long)q * p.sr * p.K;
      apply_rows<T, NS>(p, src, j, r0, dlaf_smem);
    }
    __syncthreads();  // the caller may change sh_have next
  }
  __device__ void on_entry() { apply<false>(acc); }
  __device__ void after_merge(int, int slot) {
    apply<true>(land + ((long long)me * 2 + slot) * total);
  }
};

// ---------------------------------------------------------------- B6

template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
consume_kernel(Ring r, Panel<T> p, const int* __restrict__ h, const int* __restrict__ z,
               int* __restrict__ oh) {
  const int work = (int)gemm_smem<T, NS>(p.K, p.pw);
  int* sh_have = reinterpret_cast<int*>(dlaf_smem + work);
  int* sh_hin = sh_have + r.slots;
  int* sh_apply = sh_hin + r.slots;
  int* sh_ok = sh_apply + r.slots;
  for (int i = threadIdx.x; i < r.slots; i += blockDim.x) {
    sh_have[i] = h[i];
    sh_apply[i] = z[i] == 0;
  }
  copy_segments(r.acc, r.y, r);  // the merged panel starts as this rank's payload
  __syncthreads();
  ConsumeHooks<T, NS> hooks{p, r.acc, r.land, r.total, r.me, work};
  if (!ring_hops(r, sh_have, sh_hin, sh_ok, hooks)) return;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < r.slots; i += blockDim.x) oh[i] = sh_have[i];
}

// ---------------------------------------------------------------- B8

template <typename T>
struct Step {
  Ring rc;    // 1: the consume ring over 'r' (y = the row-panel parts, acc = rp)
  Panel<T> p;
  const int* h;
  const int* z;
  int* oh;
  dlaf_fsend::Send<T> s;  // 4: the ring over 'c': its root's column k+1, every cp1
  const T* dtile;    // the diagonal tile of step k+1 in its owner's stack
  T* od;             // its copy on this rank [mb][mb]
  T* lkk;            // its factor
  u64* p1done;       // [G] of this rank: the block's consume phase is over
  u64* p1all;        // [ranks]: the rank's column k+1 is complete
  u64* fflags;       // [G] of this rank: the tail's barriers
  u64* done;         // [ranks][G]: the exit barrier
  T* dscr;           // [32][32] of this rank: the factor's diagonal block
  dlaf_fsend::Bound bd;
  u64 epoch;         // this rank's step count << 16
  int kc1, kr1, l_next, me_r, me_c, pc, ranks, fb;
  size_t work;       // bytes of the shared work area before the int scratch
};

// B8's consume phase (phase 1's ring with its update hooks) out of line.
// A thread of B8 has 128 registers; the consume body takes up to 128 and
// the tail (step_tail) as many, and in one body they spill into each other
// (f64: 64 bytes at 'default'), while the consume phase called out of line
// keeps none of its registers past the call.  f32 at 'default' (118
// registers) stays in line.  How the ring reaches the function decides the
// rest: through a pointer to the kernel's parameter at 'default', as a
// copy under the split tiers; the other ways spill 4-8 bytes in one
// instantiation or another (ptxas; PERF.md §6, B8).
template <typename T, int NS>
__device__ __noinline__ bool step_consume(const Ring* __restrict__ rq, const Panel<T> p, int work,
                                          int* sh_have, int* sh_hin, int* sh_ok) {
  if constexpr (NS == 0) {
    const Ring& r = *rq;
    ConsumeHooks<T, NS> hooks{p, r.acc, r.land, r.total, r.me, work};
    return ring_hops(r, sh_have, sh_hin, sh_ok, hooks);
  } else {
    const Ring r = *rq;
    ConsumeHooks<T, NS> hooks{p, r.acc, r.land, r.total, r.me, work};
    return ring_hops(r, sh_have, sh_hin, sh_ok, hooks);
  }
}

// B8's tail (phases 2-4 and the exit barrier) on the factor-and-send body,
// in line: it reads the kernel's parameters from the constant bank.
template <typename T>
__device__ __forceinline__ void step_tail(const Step<T>& a) {
  const int mb = a.p.M, ltc = a.p.ltc, b = blockIdx.x, G = gridDim.x;
  // -- 2. the diagonal tile of step k+1 from its owner, a part a block
  if (!dlaf_fsend::block_wait(a.p1all + a.kr1 * a.pc + a.kc1, a.epoch, a.bd, kErrPhase)) return;
  {
    const long long words = (long long)mb * mb * sizeof(T) / 16;
    const long long per = (words + G - 1) / G, lo = b * per, n = min(words, lo + per) - lo;
    if (n > 0) dlaf_fsend::copy_l2(a.od + lo * 16 / (long long)sizeof(T),
                                   a.dtile + lo * 16 / (long long)sizeof(T),
                                   n * 16 / (long long)sizeof(T));
  }
  if (!dlaf_fsend::team_barrier(a.fflags, G, b, a.epoch | 1, a.bd, kErrFactor)) return;

  // -- 3. its factor on this launch's blocks
  if (!dlaf_fsend::factor_stage<T>(a.od, a.lkk, mb, a.fb, a.fflags, a.epoch, 1, a.dscr, a.bd,
                                   dlaf_smem))
    return;

  // -- 4. the panel solve of the root's column k+1, shared by the ring
  // over 'c', and the pull of the other shares
  // (sidx [ltr + 1], the solved tiles, after the ring's int scratch)
  int* sidx = reinterpret_cast<int*>(dlaf_smem + a.work) + 3 * ltc + 1;
  if (!dlaf_fsend::solve_send<T>(a.s, a.lkk, a.p1all + a.me_r * a.pc + a.kc1, a.epoch, a.epoch,
                                 a.bd, sidx, reinterpret_cast<T*>(dlaf_smem)))
    return;
  dlaf_fsend::team_barrier(a.done, a.ranks * G, (a.me_r * a.pc + a.me_c) * G + b, a.epoch | 2,
                           a.bd, kErrDone);
}

template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const __grid_constant__ Step<T> a) {
  const int ltc = a.p.ltc, b = blockIdx.x, G = gridDim.x, tid = threadIdx.x;
  int* sh_have = reinterpret_cast<int*>(dlaf_smem + a.work);
  int* sh_hin = sh_have + ltc;
  int* sh_apply = sh_hin + ltc;
  int* sh_ok = sh_apply + ltc;
  const bool col1 = a.me_c == a.kc1;          // this rank holds column k+1

  // -- 1. consume ring over 'r', the narrow column k+1 included
  for (int i = tid; i < ltc; i += blockDim.x) {
    sh_have[i] = a.h[i];
    sh_apply[i] = a.z[i] == 0 || (col1 && i == a.l_next);
  }
  copy_segments(a.rc.acc, a.rc.y, a.rc);
  __syncthreads();
  if constexpr (NS == 0 && sizeof(T) == 4) {
    ConsumeHooks<T, NS> hooks{a.p, a.rc.acc, a.rc.land, a.rc.total, a.rc.me, (int)a.work};
    if (!ring_hops(a.rc, sh_have, sh_hin, sh_ok, hooks)) return;
  } else if (!step_consume<T, NS>(&a.rc, a.p, (int)a.work, sh_have, sh_hin, sh_ok)) {
    return;
  }
  if (b == 0)
    for (int i = tid; i < ltc; i += blockDim.x) a.oh[i] = sh_have[i];
  __syncthreads();
  if (tid == 0) publish(a.p1done + b, a.epoch);
  // column k+1 of this rank is complete once every block ended phase 1
  if (col1 && b == 0) {
    int ok = 1;
    if (tid == 0) {
      for (int q = 0; q < G && ok; ++q)
        ok = dlaf_fsend::wait_ge(a.p1done + q, a.epoch, a.bd, kErrPhase);
      if (ok) publish(a.p1all + a.me_r * a.pc + a.me_c, a.epoch);
    }
    if (!__syncthreads_and(ok)) return;
  }

  step_tail<T>(a);
}

// -------------------------------------------------------------- launchers

// Set the kernel's dynamic shared memory and check that an SM holds one of
// its blocks: a ring launch spins on flags its other blocks and ranks set,
// so every block must be resident.  Returns blocks per SM, or a negated
// CUDA error.
// the update's 16-byte copies read cp, the accumulator and the landing
// slots (every segment starts on 16 bytes when K * sizeof(T) does); the
// split body's epilogue reads and writes x in pairs of elements
inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > dlaf_potrf::kSmemLimit) return -(int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  return per_sm >= 1 ? per_sm : -(int)cudaErrorInvalidConfiguration;
}

inline size_t consume_scratch(int ltc) { return (3 * (size_t)ltc + 1) * sizeof(int); }

template <typename T, int NS>
size_t consume_smem(int ltc, int K, int pw) {
  return gemm_smem<T, NS>(K, pw) + consume_scratch(ltc);
}

template <typename T, int NS>
int launch_consume_ns(const Ring& r, Panel<T> p, const void* h, const void* z, void* oh, int G,
                      void* stream) {
  p.pw = split_pass_cols<T, NS>(p.K, consume_scratch(p.ltc));
  if (NS != 0 && p.pw == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = consume_smem<T, NS>(p.ltc, p.K, p.pw);
  const int per_sm = prepare(consume_kernel<T, NS>, smem);
  if (per_sm < 0) return -per_sm;
  consume_kernel<T, NS><<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      r, p, static_cast<const int*>(h), static_cast<const int*>(z), static_cast<int*>(oh));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_consume(const void* y, const void* h, const void* z, void* out, void* oh, void* x,
                   const void* cp, void* land, void* land_h, void* entry, void* rflag, void* aflag,
                   void* err, int ltr, int ltc, int M, int N, int K, int G, int P, int me,
                   int nslices, u64 epoch, u64 timeout_ns, void* stream) {
  const int sr = segment_rows(N);
  if (sr == 0 || ltr <= 0 || ltc <= 0 || M <= 0 || K <= 0 || G <= 0 || P < 1 ||
      (K * sizeof(T)) % 16)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(cp) || !aligned16(out) || !aligned16(land) || (nslices && !aligned16(x)))
    return (int)cudaErrorMisalignedAddress;
  const long long words_per_slot = (long long)N * K * sizeof(T) / 4;
  const long long total = ltc * words_per_slot;
  const long long seg = (long long)sr * K * sizeof(T) / 4;
  Ring r = make_ring(y, out, land, land_h, entry, rflag, aflag, err, total, words_per_slot, ltc,
                     seg, P, me, epoch, timeout_ns);
  Panel<T> p{static_cast<T*>(x), static_cast<const T*>(cp), ltr, ltc, M, N, K, sr, 0};
  switch (nslices) {
    case 0: return launch_consume_ns<T, 0>(r, p, h, z, oh, G, stream);
    case 2: return launch_consume_ns<T, 2>(r, p, h, z, oh, G, stream);
    case 3: return launch_consume_ns<T, 3>(r, p, h, z, oh, G, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The fused step's arguments as one int64 array: the head, the consume
// ring's DLAF_RING_FIELDS (named ring0_<field>) and the tail.  Each X-macro
// entry is (index, name); the library exports the names in this order
// (dlaf_fused_step_fields) and the wrapper in ops/trailing_update.py fills
// the array by name.  cp1_peers is a host array of the 'c' ring's cp1
// pointers, by ring position.
#define DLAF_STEP_HEAD(X) X(kCount, count) X(kErr, err) X(kTimeout, timeout) X(kG, G)
#define DLAF_RING_FIELDS(X)                                                             \
  X(kLand, land) X(kLandH, land_h) X(kEntry, entry) X(kRflag, rflag) X(kAflag, aflag) \
  X(kP, P) X(kMe, me) X(kRingEpoch, epoch)
#define DLAF_STEP_TAIL(X)                                                                  \
  X(kX, x) X(kCp, cp) X(kY, y) X(kH, h) X(kZ, z) X(kRp, rp) X(kOh, oh) X(kBelow, below)    \
  X(kOd, od) X(kLkk, lkk) X(kCp1Peers, cp1_peers) X(kXroot, xroot) X(kXstride, xstride)   \
  X(kDtile, dtile) X(kP1done, p1done) X(kP1all, p1all) X(kFflags, fflags) X(kDone, done)  \
  X(kChunk, chunk) X(kDscr, dscr) X(kEpoch, epoch) X(kLtr, ltr) X(kLtc, ltc) X(kMb, mb)    \
  X(kKc1, kc1) X(kKr1, kr1) X(kLnext, l_next) X(kMeR, me_r) X(kMeC, me_c) X(kPr, pr)       \
  X(kPc, pc)
#define DLAF_ENUM(e, name) e,
constexpr int kRingCount = 1;
// one ring: landing slots, their have, entry, recv and ack flags, ring
// length, position, epoch << 16
enum : int { DLAF_RING_FIELDS(DLAF_ENUM) kRingLen };
enum Desc : int {
  DLAF_STEP_HEAD(DLAF_ENUM)  // kCount: the number of entries, checked
  kRings,
  kLastRing = kRings + kRingCount * kRingLen - 1,
  DLAF_STEP_TAIL(DLAF_ENUM)
  kDescLen
};
#undef DLAF_ENUM

template <typename T>
Ring ring_of(const long long* d, int which, const void* y, void* acc, long long total, long long w,
             int slots, long long seg) {
  const long long* q = d + kRings + which * kRingLen;
  auto ptr = [](long long v) { return reinterpret_cast<void*>(v); };
  return make_ring(y, acc, ptr(q[kLand]), ptr(q[kLandH]), ptr(q[kEntry]), ptr(q[kRflag]),
                   ptr(q[kAflag]), ptr(d[kErr]), total, w, slots, seg, (int)q[kP], (int)q[kMe],
                   (u64)q[kRingEpoch], (u64)d[kTimeout]);
}

// B8's shared memory: the work area of the consume update and of the tail
// (the factor's and the solve's), then the int scratch of the ring and the
// solved-tile list
template <typename T, int NS>
size_t step_work(int mb, int pw, int fb) {
  size_t work = dlaf_fsend::factor_smem<T>(mb, fb);
  const size_t solve = dlaf_fsend::solve_smem<T>(mb);
  const size_t gemm = gemm_smem<T, NS>(mb, pw);
  if (solve > work) work = solve;
  if (gemm > work) work = gemm;
  return (work + 15) / 16 * 16;
}

inline size_t step_scratch(int ltr, int ltc) {
  return (3 * (size_t)ltc + 1 + (size_t)ltr + 1) * sizeof(int);
}

template <typename T, int NS>
size_t step_smem(int ltr, int ltc, int mb, int pw, int fb) {
  return step_work<T, NS>(mb, pw, fb) + step_scratch(ltr, ltc);
}

template <typename T, int NS>
int launch_fused_step_ns(Step<T>& a, int G, void* stream) {
  a.p.pw = split_pass_cols<T, NS>(a.p.M, step_scratch(a.p.ltr, a.p.ltc));
  if (NS != 0 && a.p.pw == 0) return (int)cudaErrorInvalidValue;
  a.work = step_work<T, NS>(a.p.M, a.p.pw, a.fb);
  const size_t smem = step_smem<T, NS>(a.p.ltr, a.p.ltc, a.p.M, a.p.pw, a.fb);
  const int per_sm = prepare(fused_step_kernel<T, NS>, smem);
  if (per_sm < 0) return -per_sm;
  fused_step_kernel<T, NS><<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused_step(const long long* d, int nslices, void* stream) {
  if (d[kCount] != kDescLen) return (int)cudaErrorInvalidValue;
  auto ptr = [](long long v) { return reinterpret_cast<void*>(v); };
  const int G = (int)d[kG], ltr = (int)d[kLtr], ltc = (int)d[kLtc], mb = (int)d[kMb];
  const int pr = (int)d[kPr], pc = (int)d[kPc];
  const int sr = segment_rows(mb);
  const int fb = dlaf_fsend::factor_blocks<T>(mb, G);
  if (G <= 0 || ltr <= 0 || ltc <= 0 || dlaf_potrf::panel_width<T>(mb) == 0 || sr == 0 ||
      mb % dlaf_panel_trsm::kW || mb > dlaf_fsend::kMaxNb || pc < 1 ||
      pc > dlaf_fsend::kMaxRanks || pr < 1 || fb < 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(ptr(d[kCp])) || !aligned16(ptr(d[kRp])) || !aligned16(ptr(d[kRings + kLand])) ||
      !aligned16(ptr(d[kOd])) || !aligned16(ptr(d[kLkk])) || !aligned16(ptr(d[kDtile])) ||
      (nslices && !aligned16(ptr(d[kX]))))
    return (int)cudaErrorMisalignedAddress;
  const long long tile_words = (long long)mb * mb * sizeof(T) / 4;
  Step<T> a;
  a.rc = ring_of<T>(d, 0, ptr(d[kY]), ptr(d[kRp]), ltc * tile_words, tile_words, ltc,
                    (long long)sr * mb * sizeof(T) / 4);
  a.p = Panel<T>{static_cast<T*>(ptr(d[kX])), static_cast<const T*>(ptr(d[kCp])), ltr, ltc, mb,
                 mb, mb, sr, 0};
  a.h = static_cast<const int*>(ptr(d[kH]));
  a.z = static_cast<const int*>(ptr(d[kZ]));
  a.oh = static_cast<int*>(ptr(d[kOh]));
  a.s.xc = static_cast<const T*>(ptr(d[kXroot]));
  a.s.xstride = d[kXstride];
  const long long* peers = reinterpret_cast<const long long*>(d[kCp1Peers]);
  for (int q = 0; q < dlaf_fsend::kMaxRanks; ++q) {
    a.s.cp[q] = q < pc ? static_cast<T*>(ptr(peers[q])) : nullptr;
    if (q < pc && !aligned16(a.s.cp[q])) return (int)cudaErrorMisalignedAddress;
  }
  a.s.below = static_cast<const int*>(ptr(d[kBelow]));
  a.s.chunk = static_cast<u64*>(ptr(d[kChunk]));
  a.s.ltr = ltr;
  a.s.nb = mb;
  a.s.P = pc;
  a.s.me = (int)d[kMeC];
  a.s.root = (int)d[kKc1];
  a.dtile = static_cast<const T*>(ptr(d[kDtile]));
  a.od = static_cast<T*>(ptr(d[kOd]));
  a.lkk = static_cast<T*>(ptr(d[kLkk]));
  a.p1done = static_cast<u64*>(ptr(d[kP1done]));
  a.p1all = static_cast<u64*>(ptr(d[kP1all]));
  a.fflags = static_cast<u64*>(ptr(d[kFflags]));
  a.done = static_cast<u64*>(ptr(d[kDone]));
  a.dscr = static_cast<T*>(ptr(d[kDscr]));
  a.bd = dlaf_fsend::Bound{static_cast<int*>(ptr(d[kErr])), (u64)d[kTimeout]};
  a.epoch = (u64)d[kEpoch];
  a.kc1 = (int)d[kKc1];
  a.kr1 = (int)d[kKr1];
  a.l_next = (int)d[kLnext];
  a.me_r = (int)d[kMeR];
  a.me_c = (int)d[kMeC];
  a.pc = pc;
  a.ranks = pr * pc;
  a.fb = fb;
  switch (nslices) {
    case 0: return launch_fused_step_ns<T, 0>(a, G, stream);
    case 2: return launch_fused_step_ns<T, 2>(a, G, stream);
    case 3: return launch_fused_step_ns<T, 3>(a, G, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// blocks per SM of one instantiation (B6: step = 0, at depth K; B8: step
// = 1, at side mb, ltr row tiles and G blocks a launch), or a negated CUDA
// error
template <typename T, int NS>
int blocks_per_sm_ns(int step, int ltr, int ltc, int mb, int K, int G) {
  if (step) {
    const int pw = split_pass_cols<T, NS>(mb, step_scratch(ltr, ltc));
    const int fb = dlaf_fsend::factor_blocks<T>(mb, G);
    if (fb < 0) return -(int)cudaErrorInvalidConfiguration;
    return prepare(fused_step_kernel<T, NS>, step_smem<T, NS>(ltr, ltc, mb, pw, fb));
  }
  const int pw = split_pass_cols<T, NS>(K, consume_scratch(ltc));
  return prepare(consume_kernel<T, NS>, consume_smem<T, NS>(ltc, K, pw));
}

template <typename T>
int blocks_per_sm(int step, int nslices, int ltr, int ltc, int mb, int K, int G) {
  switch (nslices) {
    case 0: return blocks_per_sm_ns<T, 0>(step, ltr, ltc, mb, K, G);
    case 2: return blocks_per_sm_ns<T, 2>(step, ltr, ltc, mb, K, G);
    case 3: return blocks_per_sm_ns<T, 3>(step, ltr, ltc, mb, K, G);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// B6: this rank's launch of the consume ring over a [ltc][N][K] row panel;
// nslices 0 ('default'), 2 ('bf16x3') or 3 ('bf16x6').
int dlaf_dma_ring_consume_f32(const void* y, const void* h, const void* z, void* out, void* oh,
                              void* x, const void* cp, void* land, void* land_h, void* entry,
                              void* rflag, void* aflag, void* err, int ltr, int ltc, int M, int N,
                              int K, int G, int P, int me, int nslices, unsigned long long epoch,
                              unsigned long long timeout_ns, void* stream) {
  return launch_consume<float>(y, h, z, out, oh, x, cp, land, land_h, entry, rflag, aflag, err,
                               ltr, ltc, M, N, K, G, P, me, nslices, epoch, timeout_ns, stream);
}

int dlaf_dma_ring_consume_f64(const void* y, const void* h, const void* z, void* out, void* oh,
                              void* x, const void* cp, void* land, void* land_h, void* entry,
                              void* rflag, void* aflag, void* err, int ltr, int ltc, int M, int N,
                              int K, int G, int P, int me, int nslices, unsigned long long epoch,
                              unsigned long long timeout_ns, void* stream) {
  return launch_consume<double>(y, h, z, out, oh, x, cp, land, land_h, entry, rflag, aflag, err,
                                ltr, ltc, M, N, K, G, P, me, nslices, epoch, timeout_ns, stream);
}

// B8: the names of the Desc array's entries, in order, comma-separated.
const char* dlaf_fused_step_fields() {
  static const std::string names = [] {
    std::string out;
#define DLAF_NAME(e, name) out += #name ",";
#define DLAF_RING_NAME(e, name) out += "ring" + std::to_string(q) + "_" #name ",";
    DLAF_STEP_HEAD(DLAF_NAME)
    for (int q = 0; q < kRingCount; ++q) { DLAF_RING_FIELDS(DLAF_RING_NAME) }
    DLAF_STEP_TAIL(DLAF_NAME)
#undef DLAF_NAME
#undef DLAF_RING_NAME
    out.pop_back();
    return out;
  }();
  return names.c_str();
}

// B8: this rank's launch of the fused lookahead step (the Desc array
// above), its consume phase at nslices 0, 2 or 3 as B6.
int dlaf_fused_step_f32(const long long* desc, int nslices, void* stream) {
  return launch_fused_step<float>(desc, nslices, stream);
}

int dlaf_fused_step_f64(const long long* desc, int nslices, void* stream) {
  return launch_fused_step<double>(desc, nslices, stream);
}

// Blocks per SM of B6 (step = 0) or B8 (step = 1) at nslices, for ltr x
// ltc tiles of side mb, B6's update depth K and G blocks a launch (B8's work
// areas depend on mb, ltr and G, B6's split body's on K; B8 ignores K), or
// a negated CUDA error.
int dlaf_ring_consumer_blocks_per_sm(int step, int f64, int nslices, int ltr, int ltc, int mb,
                                     int K, int G) {
  return f64 ? blocks_per_sm<double>(step, nslices, ltr, ltc, mb, K, G)
             : blocks_per_sm<float>(step, nslices, ltr, ltc, mb, K, G);
}

}  // extern "C"
