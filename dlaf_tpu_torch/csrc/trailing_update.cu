// Trailing update x[i, j] -= a[i] @ op(b[j]) over a batch of tile pairs,
// written in place (B3), and the one-shot panel contraction (B9).
//
// Replaces dlaf_tpu/ops/pallas_trailing_update.py (trailing_update /
// _update_kernel, tier 'default'; the one-rank branch of
// fused_transpose_update).  Two forms, picked by b_is_nk:
//   b_is_nk = 1: 'iab,jcb->ijac', x[i, j] -= a[i] @ b[j]^T, b [C, N, K]
//   b_is_nk = 0: 'iab,jbc->ijac', x[i, j] -= a[i] @ b[j],   b [C, K, N]
// with x [L, C, M, N] and a [L, M, K], all row-major.
//
// What bounds it on the H100: operations.  At N=16384, nb=512 (x is
// [32, 32, 512, 512]) one update is 275 GFlop over 2.2 GB, in full f32 (the
// default tier may not use the tensor cores).  A 256-thread block computes
// one 128 x 128 tile (f64: 64 x 64) of one (i, j) pair with the FMA body
// of csrc/fma_gemm.cuh: 8 x 8 outputs a thread, k slices copied by
// cp.async into a four-stage shared-memory ring.  The grid is
// one-dimensional, L*C*ceil(M/128)*ceil(N/128) blocks, so it never meets
// the 65535 limit of gridDim.y and gridDim.z.  Masked zero slots are
// computed like any other, as the TPU kernel does.
//
// The first body, csrc/trailing_update.cuh's dlaf_tu::tile_gemm (64 x 64
// tiles, 4 x 4 a thread, one unpipelined stage of scalar loads), stays in
// the reference kernels below (the *_ref_* entry points): the new body
// gives its bits, and only the card's checks and scripts launch the
// reference.
//
// B9 replaces dlaf_tpu/ops/pallas_trailing_update.py (panel_contract /
// _contract_kernel): out = contract(subscripts, a, b) for the two TRTRI
// forms, a sum across panel slots that is written, not subtracted (the
// caller negates: 0 - x and -x differ at signed zeros):
//   form 0, 'ijab,jbc->iac': out[i] = sum_j a[i, j] @ b[j]
//     (a [L, C, M, K], b [C, K, N], out [L, M, N]);
//   form 1, 'iab,ijbc->jac': out[j] = sum_i a[i] @ b[i, j]
//     (a [L, M, K], b [L, C, K, N], out [C, M, N]).
// The same FMA body, its slot loop summing over j (or i) in one fixed
// order, never per hop: the sum crosses slots.  Bound by operations, as B3:
// at TRTRI's widest step on a 2x4 grid at N=16384 (a [16, 8, 512, 512]) one
// rank's contraction is 34 GFlop over 0.5 GB.
//
// Under the split tiers (tier 'bf16x3' / 'bf16x6', the _update_kernel and
// _contract_kernel bodies tracing tile.contract's bf16 split) B3 and B9
// launch the split-tier kernels below instead, on the split body of
// csrc/split_gemm.cuh: a pre-pass that cuts each operand once into bf16
// planes in a workspace the caller allocates (b's K x N slots transposed),
// then a pipelined mma.sync GEMM over the planes, one float32 accumulator
// per term, the same slot loop.  Their bound is the tensor cores' rate: B3
// at 32 x 32 x 512^2 under bf16x3 is 0.83 ms of bf16 operations, where the
// default tier's is 4.1 ms of f32 FMA.

#include <cuda_runtime.h>

#include "fma_gemm.cuh"
#include "split_gemm.cuh"
#include "trailing_update.cuh"

namespace {

using dlaf_tu::kBM;
using dlaf_tu::kBN;
using dlaf_tu::kThreads;

// B3: one tile of one (i, j) pair per block, the FMA body of fma_gemm.cuh.
// kVec: 16-byte copies (the launcher has checked the alignment).
template <typename T, bool kBIsNK, bool kVec>
__global__ void __launch_bounds__(dlaf_fma::kThreads)
trailing_update_fma_kernel(T* __restrict__ x, const T* __restrict__ a, const T* __restrict__ b,
                           int C, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char fma_smem[];
  using G = dlaf_fma::Geom<T, kBIsNK>;
  const int tiles_n = (N + G::BN - 1) / G::BN, tiles_m = (M + G::BM - 1) / G::BM;
  long long bid = blockIdx.x;
  const int tn = (int)(bid % tiles_n);
  bid /= tiles_n;
  const int tm = (int)(bid % tiles_m);
  bid /= tiles_m;
  const int j = (int)(bid % C);
  const long long i = bid / C;

  T acc[G::TM][G::TN];
  dlaf_fma::gemm<T, kBIsNK, kVec>(acc, a + i * M * (long long)K, 0, K, b + (long long)j * N * K,
                                  0, kBIsNK ? K : N, 1, M, N, K, tm * G::BM, tn * G::BN,
                                  reinterpret_cast<T*>(fma_smem));
  dlaf_fma::store<T, kBIsNK, true>(x + (i * C + j) * (long long)M * N, N, M, N, tm * G::BM,
                                   tn * G::BN, acc);
}

// B9: one tile of one output slot per block, the FMA body of fma_gemm.cuh.
template <typename T, int kForm, bool kVec>
__global__ void __launch_bounds__(dlaf_fma::kThreads)
panel_contract_fma_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                          int L, int C, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char fma_smem[];
  using G = dlaf_fma::Geom<T, false>;
  const int tiles_n = (N + G::BN - 1) / G::BN, tiles_m = (M + G::BM - 1) / G::BM;
  long long bid = blockIdx.x;
  const int tn = (int)(bid % tiles_n);
  bid /= tiles_n;
  const int tm = (int)(bid % tiles_m);
  const long long o = bid / tiles_m;  // the output slot: i (form 0) or j (form 1)
  const long long mk = (long long)M * K, kn = (long long)K * N;

  T acc[G::TM][G::TN];
  T* sm = reinterpret_cast<T*>(fma_smem);
  if (kForm == 0)  // sum over j of a[i, j] @ b[j]
    dlaf_fma::gemm<T, false, kVec>(acc, a + o * C * mk, mk, K, b, kn, N, C, M, N, K, tm * G::BM,
                                   tn * G::BN, sm);
  else  // sum over i of a[i] @ b[i, j]
    dlaf_fma::gemm<T, false, kVec>(acc, a, mk, K, b + o * kn, C * kn, N, L, M, N, K, tm * G::BM,
                                   tn * G::BN, sm);
  dlaf_fma::store<T, false, false>(out + o * M * (long long)N, N, M, N, tm * G::BM, tn * G::BN,
                                   acc);
}

// The reference kernels: the first default-tier B3 and B9, on the body of
// trailing_update.cuh (one 64 x 64 tile per block).
template <typename T, bool kBIsNK>
__global__ void __launch_bounds__(kThreads)
trailing_update_kernel(T* __restrict__ x, const T* __restrict__ a, const T* __restrict__ b,
                       int C, int M, int N, int K) {
  __shared__ __align__(16) T sm[dlaf_tu::kSmemElems];
  const int tiles_n = (N + kBN - 1) / kBN, tiles_m = (M + kBM - 1) / kBM;
  long long bid = blockIdx.x;
  const int tn = (int)(bid % tiles_n);
  bid /= tiles_n;
  const int tm = (int)(bid % tiles_m);
  bid /= tiles_m;
  const int j = (int)(bid % C);
  const long long i = bid / C;

  T acc[dlaf_tu::kTM][dlaf_tu::kTN];
  dlaf_tu::tile_gemm<T, kBIsNK>(acc, a + i * M * (long long)K, 0, K,
                                       b + (long long)j * N * K, 0, kBIsNK ? K : N, 1, M, N, K,
                                       tm * kBM, tn * kBN, threadIdx.x, sm);
  dlaf_tu::tile_store<T, true>(x + (i * C + j) * (long long)M * N, N, M, N, tm * kBM, tn * kBN,
                               acc, threadIdx.x);
}

template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads)
panel_contract_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                      int L, int C, int M, int N, int K) {
  __shared__ __align__(16) T sm[dlaf_tu::kSmemElems];
  const int tiles_n = (N + kBN - 1) / kBN, tiles_m = (M + kBM - 1) / kBM;
  long long bid = blockIdx.x;
  const int tn = (int)(bid % tiles_n);
  bid /= tiles_n;
  const int tm = (int)(bid % tiles_m);
  const long long o = bid / tiles_m;  // the output slot: i (form 0) or j (form 1)
  const long long mk = (long long)M * K, kn = (long long)K * N;

  T acc[dlaf_tu::kTM][dlaf_tu::kTN];
  if (kForm == 0)  // sum over j of a[i, j] @ b[j]
    dlaf_tu::tile_gemm<T, false>(acc, a + o * C * mk, mk, K, b, kn, N, C, M, N, K,
                                        tm * kBM, tn * kBN, threadIdx.x, sm);
  else  // sum over i of a[i] @ b[i, j]
    dlaf_tu::tile_gemm<T, false>(acc, a, mk, K, b + o * kn, C * kn, N, L, M, N, K,
                                        tm * kBM, tn * kBN, threadIdx.x, sm);
  dlaf_tu::tile_store<T, false>(out + o * M * (long long)N, N, M, N, tm * kBM, tn * kBN, acc,
                                threadIdx.x);
}

// B3-split and B9-split, the pre-pass: blocks [0, blocks_a) cut a's
// rows_a rows of K into its planes, the others b's rows_b plane rows: rows
// of K, or (kKN) slots of K x N in tiles of 32 k by 64 n.  vec_a, vec_b:
// every row of a (b's rows of K) lies on 16 bytes.
template <typename T, int NS, bool kKN>
__global__ void __launch_bounds__(256)
split_cut_kernel(const T* __restrict__ a, const T* __restrict__ b, unsigned char* __restrict__ pa,
                 unsigned char* __restrict__ pb, long long pitch, long long rows_a,
                 long long rows_b, int K, int N, int blocks_a, int vec_a, int vec_b) {
  __shared__ T tile[kKN ? 32 : 1][65];
  const int groups = (int)(pitch / dlaf_split::Body<NS>::GB);
  if ((int)blockIdx.x < blocks_a) {
    for (long long i = blockIdx.x * 256LL + threadIdx.x; i < rows_a * groups;
         i += blocks_a * 256LL)
      dlaf_split::cut_item<T, NS>(pa, pitch, a, K, groups, i, vec_a);
  } else if constexpr (kKN) {
    const long long tiles = rows_b / N * (groups / 4) * ((N + 63) / 64);
    for (long long i = blockIdx.x - blocks_a; i < tiles; i += gridDim.x - blocks_a)
      dlaf_split::cut_tile_kn<T, NS>(pb, pitch, b, K, N, i, tile);
  } else {
    for (long long i = (blockIdx.x - blocks_a) * 256LL + threadIdx.x; i < rows_b * groups;
         i += (gridDim.x - blocks_a) * 256LL)
      dlaf_split::cut_item<T, NS>(pb, pitch, b, K, groups, i, vec_b);
  }
}

// The split body's tile: 128 x 64 for B3 (whose epilogue reads x too: more,
// smaller tiles), 128 x 128 for B9 at bf16x3 in f32 (deep sums over the
// slots, written once; in f64 its epilogue spilled), 64 x 64 at bf16x6
// (scripts/split_variants.py)
template <typename T, int NS, bool kSub>
using SplitBody = dlaf_split::Body<NS, !kSub && sizeof(T) == 4>;

// B3-split (kSub: x -= the product) and B9-split (out = the sum over
// slots): the split body of split_gemm.cuh over the planes, each block on
// the tiles blockIdx.x, blockIdx.x + gridDim.x, ...
template <typename T, int NS, bool kSub>
__global__ void __launch_bounds__(SplitBody<T, NS, kSub>::kThreads, 1)
split_gemm_kernel(T* __restrict__ x, const unsigned char* __restrict__ pa,
                  const unsigned char* __restrict__ pb, dlaf_split::Job j) {
  extern __shared__ __align__(16) unsigned char split_smem[];
  dlaf_split::run<T, SplitBody<T, NS, kSub>, kSub>(x, pa, pb, j, split_smem);
}

template <typename T>
int launch_trailing_update_ref(void* x, const void* a, const void* b, int L, int C, int M, int N,
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

template <typename T>
int launch_panel_contract_ref(const void* a, const void* b, void* out, int form, int L, int C, int M,
                          int N, int K, void* stream) {
  if (L <= 0 || C <= 0 || M <= 0 || N <= 0) return 0;
  if (form != 0 && form != 1) return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)(form == 0 ? L : C) * ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0)
    panel_contract_kernel<T, 0><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), L, C, M, N, K);
  else
    panel_contract_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), L, C, M, N, K);
  return (int)cudaGetLastError();
}

// Lets `kernel` take `bytes` of dynamic shared memory (above the 48 KB
// that needs no opt-in), with the most shared memory the SM can give.
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

// Whether every row of the operands starts on 16 bytes: the bases aligned
// and the row lengths multiples of 16 bytes (the 16-byte copies).
inline bool rows_aligned16(const void* a, const void* b, long long lda, long long ldb,
                           int elem) {
  return reinterpret_cast<unsigned long long>(a) % 16 == 0 &&
         reinterpret_cast<unsigned long long>(b) % 16 == 0 && lda * elem % 16 == 0 &&
         ldb * elem % 16 == 0;
}

template <typename T, bool kBIsNK, bool kVec>
int launch_tu_fma(T* x, const T* a, const T* b, int C, int M, int N, int K, unsigned blocks,
                  cudaStream_t s) {
  auto* kernel = &trailing_update_fma_kernel<T, kBIsNK, kVec>;
  constexpr size_t smem = dlaf_fma::Geom<T, kBIsNK>::SMEM_BYTES;
  static const cudaError_t e = allow_smem(kernel, smem);  // once per instantiation
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, dlaf_fma::kThreads, smem, s>>>(x, a, b, C, M, N, K);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_trailing_update(void* x, const void* a, const void* b, int L, int C, int M, int N,
                           int K, int b_is_nk, void* stream) {
  if (L <= 0 || C <= 0 || M <= 0 || N <= 0) return 0;
  constexpr int BM = dlaf_fma::Geom<T, true>::BM, BN = dlaf_fma::Geom<T, true>::BN;
  const long long blocks = (long long)L * C * ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* xt = static_cast<T*>(x);
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  const unsigned nblk = (unsigned)blocks;
  const bool vec = rows_aligned16(a, b, K, b_is_nk ? K : N, (int)sizeof(T));
  if (b_is_nk)
    return vec ? launch_tu_fma<T, true, true>(xt, at, bt, C, M, N, K, nblk, s)
               : launch_tu_fma<T, true, false>(xt, at, bt, C, M, N, K, nblk, s);
  return vec ? launch_tu_fma<T, false, true>(xt, at, bt, C, M, N, K, nblk, s)
             : launch_tu_fma<T, false, false>(xt, at, bt, C, M, N, K, nblk, s);
}

template <typename T, int kForm, bool kVec>
int launch_pc_fma(const T* a, const T* b, T* out, int L, int C, int M, int N, int K,
                  unsigned blocks, cudaStream_t s) {
  auto* kernel = &panel_contract_fma_kernel<T, kForm, kVec>;
  constexpr size_t smem = dlaf_fma::Geom<T, false>::SMEM_BYTES;
  static const cudaError_t e = allow_smem(kernel, smem);  // once per instantiation
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, dlaf_fma::kThreads, smem, s>>>(a, b, out, L, C, M, N, K);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_panel_contract(const void* a, const void* b, void* out, int form, int L, int C, int M,
                          int N, int K, void* stream) {
  if (L <= 0 || C <= 0 || M <= 0 || N <= 0) return 0;
  if (form != 0 && form != 1) return (int)cudaErrorInvalidValue;
  constexpr int BM = dlaf_fma::Geom<T, false>::BM, BN = dlaf_fma::Geom<T, false>::BN;
  const long long blocks =
      (long long)(form == 0 ? L : C) * ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  const unsigned nblk = (unsigned)blocks;
  const bool vec = rows_aligned16(a, b, K, N, (int)sizeof(T));
  if (form == 0)
    return vec ? launch_pc_fma<T, 0, true>(at, bt, ot, L, C, M, N, K, nblk, s)
               : launch_pc_fma<T, 0, false>(at, bt, ot, L, C, M, N, K, nblk, s);
  return vec ? launch_pc_fma<T, 1, true>(at, bt, ot, L, C, M, N, K, nblk, s)
             : launch_pc_fma<T, 1, false>(at, bt, ot, L, C, M, N, K, nblk, s);
}

// One split call: the pre-pass (phases & 1) cuts a (rows_a rows of K)
// and b (rows_b plane rows; b_kn: slots of K x N) into their planes at the
// start of ws, a's first; the body (phases & 2) computes job j's output
// tiles from them, one block an SM.  ws holds at least
// (rows_a + rows_b) * plane_pitch(K) bytes.
template <typename T, int NS, bool kSub>
int launch_split(T* x, const T* a, const T* b, bool b_kn, void* ws, long long ws_bytes,
                 long long rows_a, long long rows_b, dlaf_split::Job j, int K, int phases,
                 cudaStream_t s) {
  using G = dlaf_split::Body<NS>;
  j.pitch = dlaf_split::plane_pitch<NS>(K);
  j.nk = (int)(j.pitch / G::RB);
  if ((rows_a + rows_b) * j.pitch > ws_bytes) return (int)cudaErrorInvalidValue;
  unsigned char* pa = static_cast<unsigned char*>(ws);
  unsigned char* pb = pa + rows_a * j.pitch;
  const long long groups = j.pitch / G::GB;
  if ((phases & 1) && groups > 0) {
    // a's and b's blocks in proportion to their bytes, 132 * 16 in all at most
    const long long want_a = (rows_a * groups + 255) / 256;
    const long long want_b = b_kn ? rows_b / j.N * (groups / 4) * ((j.N + 63) / 64)
                                  : (rows_b * groups + 255) / 256;
    const long long cap = 132 * 16, want = want_a + want_b;
    const int blocks = (int)(want <= cap ? want : cap);  // want >= 2: each has a row
    const int blocks_a = (int)max(1LL, min((long long)blocks - 1, want_a * blocks / want));
    const bool vec_a = reinterpret_cast<unsigned long long>(a) % 16 == 0 && K * sizeof(T) % 16 == 0;
    const bool vec_b = reinterpret_cast<unsigned long long>(b) % 16 == 0 && K * sizeof(T) % 16 == 0;
    if (b_kn)
      split_cut_kernel<T, NS, true><<<blocks, 256, 0, s>>>(a, b, pa, pb, j.pitch, rows_a, rows_b,
                                                           K, j.N, blocks_a, vec_a, vec_b);
    else
      split_cut_kernel<T, NS, false><<<blocks, 256, 0, s>>>(a, b, pa, pb, j.pitch, rows_a,
                                                            rows_b, K, j.N, blocks_a, vec_a, vec_b);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (phases & 2) {
    using B = SplitBody<T, NS, kSub>;
    const long long tiles =
        (long long)j.O * ((j.M + B::BM - 1) / B::BM) * ((j.N + B::BN - 1) / B::BN);
    auto* kernel = &split_gemm_kernel<T, NS, kSub>;
    constexpr int smem = B::SMEM_BYTES + dlaf_split::Out<T, B>::BYTES;
    static const cudaError_t e = allow_smem(kernel, smem);  // once per instantiation
    if (e != cudaSuccess) return (int)e;
    static const int sms = [] {  // the card's SMs, one block each (0 if unknown: refused)
      int dev = 0, n = 0;
      if (cudaGetDevice(&dev) != cudaSuccess ||
          cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 0;
      return n;
    }();
    if (sms <= 0) return (int)cudaErrorInvalidDevice;
    // a block's tiles and slices are counted in ints
    if ((tiles + sms - 1) / sms * j.S * (long long)j.nk > 0x7fffffffLL)
      return (int)cudaErrorInvalidConfiguration;
    const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);
    kernel<<<blocks, B::kThreads, smem, s>>>(x, pa, pb, j);
  }
  return (int)cudaGetLastError();
}

// B3-split: x [L, C, M, N] -= a [L, M, K] @ op(b[j]), b [C, N, K] (b_is_nk)
// or [C, K, N]; output slot o = i C + j
template <typename T>
int launch_trailing_update_split(void* x, const void* a, const void* b, void* ws,
                                 long long ws_bytes, int L, int C, int M, int N, int K,
                                 int b_is_nk, int nslices, int phases, void* stream) {
  if (nslices != 2 && nslices != 3) return (int)cudaErrorInvalidValue;
  if (L <= 0 || C <= 0 || M <= 0 || N <= 0) return 0;
  if ((long long)L * C > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dlaf_split::Job j{L * C, C, 1, 0, M, N, M, 0, 0, N, 0, 0, 0};
  const long long rows_a = (long long)L * M, rows_b = (long long)C * N;
  T* xt = static_cast<T*>(x);
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nslices == 2)
    return launch_split<T, 2, true>(xt, at, bt, !b_is_nk, ws, ws_bytes, rows_a, rows_b, j, K,
                                    phases, s);
  return launch_split<T, 3, true>(xt, at, bt, !b_is_nk, ws, ws_bytes, rows_a, rows_b, j, K,
                                  phases, s);
}

// B9-split: form 0 out[i] = sum_j a[i, j] @ b[j] (a [L, C, M, K], b
// [C, K, N]); form 1 out[j] = sum_i a[i] @ b[i, j] (a [L, M, K], b
// [L, C, K, N])
template <typename T>
int launch_panel_contract_split(const void* a, const void* b, void* out, void* ws,
                                long long ws_bytes, int form, int L, int C, int M, int N, int K,
                                int nslices, int phases, void* stream) {
  if (nslices != 2 && nslices != 3) return (int)cudaErrorInvalidValue;
  if (form != 0 && form != 1) return (int)cudaErrorInvalidValue;
  if (L <= 0 || C <= 0 || M <= 0 || N <= 0) return 0;
  const long long cm = (long long)C * M, cn = (long long)C * N;
  const dlaf_split::Job j = form == 0 ? dlaf_split::Job{L, 1, C, 0, M, N, cm, 0, 0, 0, M, N, 0}
                                      : dlaf_split::Job{C, 1, L, 0, M, N, 0, 0, N, 0, M, cn, 0};
  const long long rows_a = form == 0 ? L * cm : (long long)L * M;
  const long long rows_b = form == 0 ? cn : L * cn;
  T* ot = static_cast<T*>(out);
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nslices == 2)
    return launch_split<T, 2, false>(ot, at, bt, true, ws, ws_bytes, rows_a, rows_b, j, K,
                                     phases, s);
  return launch_split<T, 3, false>(ot, at, bt, true, ws, ws_bytes, rows_a, rows_b, j, K, phases,
                                   s);
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

// B9: form 0 'ijab,jbc->iac', form 1 'iab,ijbc->jac'
int dlaf_panel_contract_f32(const void* a, const void* b, void* out, int form, int L, int C, int M,
                            int N, int K, void* stream) {
  return launch_panel_contract<float>(a, b, out, form, L, C, M, N, K, stream);
}

int dlaf_panel_contract_f64(const void* a, const void* b, void* out, int form, int L, int C, int M,
                            int N, int K, void* stream) {
  return launch_panel_contract<double>(a, b, out, form, L, C, M, N, K, stream);
}

// the reference kernels (the first B3 and B9 body), same arguments
int dlaf_trailing_update_ref_f32(void* x, const void* a, const void* b, int L, int C, int M, int N,
                                 int K, int b_is_nk, void* stream) {
  return launch_trailing_update_ref<float>(x, a, b, L, C, M, N, K, b_is_nk, stream);
}

int dlaf_trailing_update_ref_f64(void* x, const void* a, const void* b, int L, int C, int M, int N,
                                 int K, int b_is_nk, void* stream) {
  return launch_trailing_update_ref<double>(x, a, b, L, C, M, N, K, b_is_nk, stream);
}

int dlaf_panel_contract_ref_f32(const void* a, const void* b, void* out, int form, int L, int C,
                                int M, int N, int K, void* stream) {
  return launch_panel_contract_ref<float>(a, b, out, form, L, C, M, N, K, stream);
}

int dlaf_panel_contract_ref_f64(const void* a, const void* b, void* out, int form, int L, int C,
                                int M, int N, int K, void* stream) {
  return launch_panel_contract_ref<double>(a, b, out, form, L, C, M, N, K, stream);
}

// B3 and B9 under the split tiers: nslices 2 (bf16x3) or 3 (bf16x6); ws
// the planes' workspace of ws_bytes (64 nslices bytes for every 32 k of K,
// rounded up, a row of a and of b); phases 1 the pre-pass, 2 the body, 3
// both
int dlaf_trailing_update_split_f32(void* x, const void* a, const void* b, void* ws,
                                   long long ws_bytes, int L, int C, int M, int N, int K,
                                   int b_is_nk, int nslices, int phases, void* stream) {
  return launch_trailing_update_split<float>(x, a, b, ws, ws_bytes, L, C, M, N, K, b_is_nk,
                                             nslices, phases, stream);
}

int dlaf_trailing_update_split_f64(void* x, const void* a, const void* b, void* ws,
                                   long long ws_bytes, int L, int C, int M, int N, int K,
                                   int b_is_nk, int nslices, int phases, void* stream) {
  return launch_trailing_update_split<double>(x, a, b, ws, ws_bytes, L, C, M, N, K, b_is_nk,
                                              nslices, phases, stream);
}

int dlaf_panel_contract_split_f32(const void* a, const void* b, void* out, void* ws,
                                  long long ws_bytes, int form, int L, int C, int M, int N,
                                  int K, int nslices, int phases, void* stream) {
  return launch_panel_contract_split<float>(a, b, out, ws, ws_bytes, form, L, C, M, N, K,
                                            nslices, phases, stream);
}

int dlaf_panel_contract_split_f64(const void* a, const void* b, void* out, void* ws,
                                  long long ws_bytes, int form, int L, int C, int M, int N,
                                  int K, int nslices, int phases, void* stream) {
  return launch_panel_contract_split<double>(a, b, out, ws, ws_bytes, form, L, C, M, N, K,
                                             nslices, phases, stream);
}

}  // extern "C"
