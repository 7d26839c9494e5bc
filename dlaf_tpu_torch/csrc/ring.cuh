// The ring protocol of the 'pallas' collectives tier, shared by the hop
// ring (csrc/panel_exchange.cu: B5's reference kernel) and the ring
// consumers (csrc/consume.cu: B6, B8's consume phase), as the TPU kernels
// share
// pallas_panel_exchange._ring_hops.  See panel_exchange.cu for the protocol:
// landing slots in device memory, 64-bit flags valued (epoch << 16) | hop
// that never reset, an entry barrier, a recv flag per hop and a capacity
// ack per slot, every spin bounded by %globaltimer.
//
// ring_hops takes two hooks, which the consumers use to splice their
// trailing update into the protocol where the TPU's _consume_hops does:
// on_entry() right after the entry barrier, and after_merge(s, j) after
// hop s has been merged out of landing slot j and before that slot is
// acked (sh_have is still the have before the merge, sh_hin the incoming
// one).  Both are called by every thread of the block.
#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>

namespace dlaf_ring {

using u32 = unsigned int;
using u64 = unsigned long long;
using flag_ref = cuda::atomic_ref<u64, cuda::thread_scope_device>;
using err_ref = cuda::atomic_ref<int, cuda::thread_scope_device>;

// which wait ran out (the error word's value; -1 is set by the host)
enum : int {
  kErrEntry = 1,   // an entry barrier, or the root's panel
  kErrAck = 2,
  kErrRecv = 3,
  kErrFactor = 4,  // a barrier of the factor (factor_send.cuh)
  kErrPhase = 5,
  kErrDone = 6,    // an exit barrier (a reader's done flag never came)
  kErrChunk = 7,   // a chunk flag of the shared panel solve (factor_send.cuh)
};

__device__ __forceinline__ u64 globaltimer() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The hop merge of one slot: take the incoming word only where this rank
// has no contribution yet and the sender has one (B4's select; the pull
// and every hop of the rings of B6 and B8 decide a slot's take with it).
__device__ __forceinline__ bool hop_take(int have, int have_in) {
  return have == 0 && have_in != 0;
}

struct Ring {
  const u32* y;        // this rank's payload (input), total words
  u32* acc;            // the accumulator, which is the output
  u32* land;           // landing slots [P][2][total]
  int* land_h;         // have of the landing slots [P][2][G][slots]
  u64* entry;          // [P][G]
  u64* rflag;          // [P][2][G]
  u64* aflag;          // [P][2][G]
  int* err;            // the grid's sticky error word
  long long total;     // payload words
  long long w;         // words per have slot (total = slots * w)
  long long seg;       // words per segment
  int slots;
  int P, me;
  u64 epoch;           // this call's epoch << 16
  u64 timeout_ns;
};

// This thread: wait until *flag >= target; false when `timeout_ns` ran out
// (the error word is then set to `code`) or another block set the error
// word.  Every spin of the ring kernels is this one.
__device__ inline bool wait_ge(const u64* flag, u64 target, int* err, u64 timeout_ns, int code) {
  flag_ref f(*const_cast<u64*>(flag));
  err_ref e(*err);
  const u64 t0 = globaltimer();
  while (f.load(cuda::memory_order_acquire) < target) {
    if (e.load(cuda::memory_order_relaxed) != 0) return false;
    if (globaltimer() - t0 > timeout_ns) {
      int zero = 0;
      e.compare_exchange_strong(zero, code, cuda::memory_order_relaxed);
      return false;
    }
    __nanosleep(128);
  }
  return true;
}

// Thread 0 of a hop ring's block: wait_ge under the ring's bound.
__device__ inline bool wait_flag(u64* flag, u64 target, const Ring& r, int code) {
  return wait_ge(flag, target, r.err, r.timeout_ns, code);
}

__device__ __forceinline__ void publish(u64* flag, u64 value) {
  __threadfence();
  flag_ref(*flag).store(value, cuda::memory_order_release);
}

// Block-uniform result of a wait done by thread 0.
__device__ inline bool block_ok(bool ok_thread0, int* sh_ok) {
  if (threadIdx.x == 0) *sh_ok = ok_thread0;
  __syncthreads();
  const bool ok = *sh_ok;
  __syncthreads();
  return ok;
}

// dst[i] = src[i] over this block's segments (16-byte accesses when the
// segment layout allows them).
__device__ inline void copy_segments(u32* __restrict__ dst, const u32* __restrict__ src, const Ring& r) {
  const bool vec = (r.seg % 4 == 0) && (r.total % 4 == 0);
  for (long long lo = (long long)blockIdx.x * r.seg; lo < r.total; lo += (long long)gridDim.x * r.seg) {
    const long long hi = min(lo + r.seg, r.total);
    if (vec) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src + lo);
      uint4* d4 = reinterpret_cast<uint4*>(dst + lo);
      for (long long i = threadIdx.x; i < (hi - lo) / 4; i += blockDim.x) d4[i] = __ldcg(s4 + i);
    } else {
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) dst[i] = __ldcg(src + i);
    }
  }
}

// acc[i] = land[i] where hop_take(have[slot(i)], have_in[slot(i)]).  One
// division a segment finds its first slot; the walk then goes from slot
// boundary to slot boundary, deciding each slot's take once and copying
// only the words it takes (16 bytes at a time where the layout allows).
// The consumers' segments never cross a slot; B5's hop ring's may.
__device__ inline void merge_segments(u32* __restrict__ acc, const u32* __restrict__ land,
                                      const int* sh_have, const int* sh_hin, const Ring& r) {
  const bool vec = (r.seg % 4 == 0) && (r.total % 4 == 0) && (r.w % 4 == 0);
  for (long long lo = (long long)blockIdx.x * r.seg; lo < r.total; lo += (long long)gridDim.x * r.seg) {
    const long long hi = min(lo + r.seg, r.total);
    int slot = (int)(lo / r.w);
    for (long long a = lo; a < hi; ++slot) {
      const long long b = min(hi, (slot + 1) * r.w);
      if (hop_take(sh_have[slot], sh_hin[slot])) {
        if (vec) {  // a and b are multiples of 4 words
          const uint4* l4 = reinterpret_cast<const uint4*>(land + a);
          uint4* a4 = reinterpret_cast<uint4*>(acc + a);
          for (long long i = threadIdx.x; i < (b - a) / 4; i += blockDim.x) a4[i] = __ldcg(l4 + i);
        } else {
          for (long long i = a + threadIdx.x; i < b; i += blockDim.x) acc[i] = __ldcg(land + i);
        }
      }
      a = b;
    }
  }
}

struct NoHooks {
  __device__ void on_entry() {}
  __device__ void after_merge(int, int) {}
};

// The P - 1 hops of one block's ring (the TPU kernel's _ring_hops).
// sh_have holds this rank's have on entry and the merged have on exit;
// sh_hin and sh_ok are scratch.  False when a wait failed.
template <typename Hooks = NoHooks>
__device__ bool ring_hops(const Ring& r, int* sh_have, int* sh_hin, int* sh_ok,
                          Hooks hooks = Hooks()) {
  const int b = blockIdx.x, G = gridDim.x, tid = threadIdx.x, nt = blockDim.x;
  const int dst = (r.me + 1) % r.P, src = (r.me + r.P - 1) % r.P;
  const int nhops = r.P - 1;

  bool ok = true;
  if (tid == 0) {
    publish(&r.entry[(long long)r.me * G + b], r.epoch);
    ok = wait_flag(&r.entry[(long long)dst * G + b], r.epoch, r, kErrEntry) &&
         wait_flag(&r.entry[(long long)src * G + b], r.epoch, r, kErrEntry);
  }
  if (!block_ok(ok, sh_ok)) return false;
  hooks.on_entry();

  for (int s = 0; s < nhops; ++s) {
    const int j = s & 1;
    if (s >= 2) {
      // the downstream rank has merged my hop s - 2 copy out of slot j
      ok = tid != 0 || wait_flag(&r.aflag[((long long)dst * 2 + j) * G + b],
                                 r.epoch | (u64)(s - 1), r, kErrAck);
      if (!block_ok(ok, sh_ok)) return false;
    }
    // send: the accumulator into the downstream rank's slot j
    copy_segments(r.land + ((long long)dst * 2 + j) * r.total, r.acc, r);
    int* dh = r.land_h + (((long long)dst * 2 + j) * G + b) * r.slots;
    for (int i = tid; i < r.slots; i += nt) dh[i] = sh_have[i];
    __syncthreads();
    ok = true;
    if (tid == 0) {
      publish(&r.rflag[((long long)dst * 2 + j) * G + b], r.epoch | (u64)(s + 1));
      ok = wait_flag(&r.rflag[((long long)r.me * 2 + j) * G + b], r.epoch | (u64)(s + 1), r,
                     kErrRecv);
      __threadfence();
    }
    if (!block_ok(ok, sh_ok)) return false;
    // merge my slot j
    const int* mh = r.land_h + (((long long)r.me * 2 + j) * G + b) * r.slots;
    for (int i = tid; i < r.slots; i += nt) sh_hin[i] = __ldcg(mh + i);
    __syncthreads();
    merge_segments(r.acc, r.land + ((long long)r.me * 2 + j) * r.total, sh_have, sh_hin, r);
    __syncthreads();
    hooks.after_merge(s, j);
    for (int i = tid; i < r.slots; i += nt) sh_have[i] |= sh_hin[i];
    __syncthreads();
    if (s + 2 < nhops && tid == 0) {
      // slot j consumed: the upstream writer may reuse it at hop s + 2
      publish(&r.aflag[((long long)r.me * 2 + j) * G + b], r.epoch | (u64)(s + 1));
    }
  }
  return true;
}

inline Ring make_ring(const void* y, void* acc, void* land, void* land_h, void* entry, void* rflag,
               void* aflag, void* err, long long total, long long w, int slots, long long seg,
               int P, int me, u64 epoch, u64 timeout_ns) {
  Ring r;
  r.y = static_cast<const u32*>(y);
  r.acc = static_cast<u32*>(acc);
  r.land = static_cast<u32*>(land);
  r.land_h = static_cast<int*>(land_h);
  r.entry = static_cast<u64*>(entry);
  r.rflag = static_cast<u64*>(rflag);
  r.aflag = static_cast<u64*>(aflag);
  r.err = static_cast<int*>(err);
  r.total = total;
  r.w = w;
  r.seg = seg;
  r.slots = slots;
  r.P = P;
  r.me = me;
  r.epoch = epoch;
  r.timeout_ns = timeout_ns;
  return r;
}

}  // namespace dlaf_ring
