// Band -> tridiagonal reduction via Givens bulge chasing (Schwarz/Rutishauser),
// with threaded accumulation of the unitary transformation Q.
//
// Native host-stage analogue of the reference band_to_tridiag
// (reference: include/dlaf/eigensolver/band_to_tridiag/mc.h — BandBlock +
// SweepWorker bulge chasing, CPU-only there as well, api.h:40-46).  The
// reduction itself touches only the band: O(N^2 * b) flops.  Accumulating Q
// explicitly is O(N^3) but embarrassingly parallel over row stripes; the
// rotation stream is buffered in chunks so worker threads replay it over
// their own stripe without per-rotation synchronization.
//
// Storage: lower band, column-major with leading dimension (b+2) — one
// extra sub-band row for the transient bulge:
//   ab[i + j*(b+2)] = A[j+i, j],  0 <= i <= b+1.
// Q is n x n row-major; rotations update adjacent column pairs (cache-local).
//
// Exposed as extern "C" for ctypes (no pybind11 in this image).

#include <atomic>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <class T>
struct Real {
  using type = T;
};
template <class T>
struct Real<std::complex<T>> {
  using type = T;
};

template <class T>
using real_t = typename Real<T>::type;

template <class T>
inline real_t<T> abs2(T x) {
  return std::norm(x);
}
inline double abs2(double x) { return x * x; }
inline float abs2(float x) { return x * x; }

template <class T>
inline T conj_(T x) {
  return x;
}
template <class T>
inline std::complex<T> conj_(std::complex<T> x) {
  return std::conj(x);
}

// Givens rotation zeroing `g` against pivot `f`:
//   [ c        s ] [f]   [r]
//   [-conj(s)  c ] [g] = [0],  c real >= 0, |c|^2 + |s|^2 = 1.
template <class T>
inline void make_givens(T f, T g, real_t<T>& c, T& s, T& r) {
  using R = real_t<T>;
  R af2 = abs2(f), ag2 = abs2(g);
  if (ag2 == R(0)) {
    c = R(1);
    s = T(0);
    r = f;
    return;
  }
  R d = std::sqrt(af2 + ag2);
  if (af2 == R(0)) {
    c = R(0);
    s = conj_(g) / d * T(1);  // s = conj(g)/|g| scaled
    // r = s * g ... with f = 0: r = conj(g)/d * g = |g|^2/d = d
    r = T(d);
    return;
  }
  // scale by phase of f so r keeps f's phase
  c = std::sqrt(af2) / d;
  T fs = f / T(std::sqrt(af2));
  s = fs * conj_(g) / T(d);
  r = fs * T(d);
}

struct RotRec {
  int64_t col;  // left column index p (pair is (p, p+1))
  double c;
  double s_re;
  double s_im;
};

// Apply buffered rotations to Q stripe rows [r0, r1): Q := Q * G^H for each,
// i.e. for G = [[c, s], [-conj(s), c]] acting on coords (p, p+1):
//   Q[:, p]   =  c*Q[:,p] - conj(s)*Q[:,p+1]  ... derive: (Q G^H) columns:
//   G^H = [[c, -s], [conj(s), c]]
//   newQ[:,p]   = c*Q[:,p] + conj(s)*Q[:,p+1]
//   newQ[:,p+1] = -s*Q[:,p] + c*Q[:,p+1]
template <class T>
void apply_chunk(T* q, int64_t n, int64_t r0, int64_t r1,
                 const std::vector<RotRec>& rots) {
  for (const auto& rec : rots) {
    const int64_t p = rec.col;
    T s;
    if constexpr (std::is_same_v<T, std::complex<double>> ||
                  std::is_same_v<T, std::complex<float>>) {
      s = T(typename T::value_type(rec.s_re), typename T::value_type(rec.s_im));
    } else {
      s = T(rec.s_re);
    }
    const real_t<T> c = real_t<T>(rec.c);
    for (int64_t i = r0; i < r1; ++i) {
      T* row = q + i * n;
      T a = row[p], b = row[p + 1];
      row[p] = c * a + conj_(s) * b;
      row[p + 1] = -s * a + c * b;
    }
  }
}

template <class T>
class QAccumulator {
 public:
  QAccumulator(T* q, int64_t n, int nthreads)
      : q_(q), n_(n), nthreads_(q ? std::max(1, nthreads) : 0) {
    if (q_) {
      std::memset(static_cast<void*>(q_), 0, sizeof(T) * n_ * n_);
      for (int64_t i = 0; i < n_; ++i) q_[i * n_ + i] = T(1);
      buf_.reserve(kChunk);
    }
  }

  void push(int64_t p, real_t<T> c, T s) {
    if (!q_) return;
    double sre, sim;
    if constexpr (std::is_same_v<T, std::complex<double>> ||
                  std::is_same_v<T, std::complex<float>>) {
      sre = double(s.real());
      sim = double(s.imag());
    } else {
      sre = double(s);
      sim = 0.0;
    }
    buf_.push_back(RotRec{p, double(c), sre, sim});
    if (buf_.size() >= kChunk) flush();
  }

  void flush() {
    if (!q_ || buf_.empty()) return;
    if (nthreads_ == 1) {
      apply_chunk(q_, n_, 0, n_, buf_);
    } else {
      std::vector<std::thread> ws;
      int64_t step = (n_ + nthreads_ - 1) / nthreads_;
      for (int t = 0; t < nthreads_; ++t) {
        int64_t r0 = t * step, r1 = std::min(n_, r0 + step);
        if (r0 >= r1) break;
        ws.emplace_back([this, r0, r1] { apply_chunk(q_, n_, r0, r1, buf_); });
      }
      for (auto& w : ws) w.join();
    }
    buf_.clear();
  }

 private:
  static constexpr size_t kChunk = 1 << 21;  // ~2M rotations per replay
  T* q_;
  int64_t n_;
  int nthreads_;
  std::vector<RotRec> buf_;
};

// Rotate the Hermitian band for the coordinate pair (p, p+1):
// A := G A G^H with G as above.  Band accessor: lower storage, the bulge row
// is i == b+1.
template <class T>
struct Band {
  T* ab;
  int64_t n;
  int64_t b;    // bandwidth (sub-diagonals)
  int64_t ld;   // b + 2

  inline T get(int64_t i, int64_t j) const {  // i >= j, i - j <= b+1
    return ab[(i - j) + j * ld];
  }
  inline void set(int64_t i, int64_t j, T v) { ab[(i - j) + j * ld] = v; }

  // A(i,j) for any order, reading the lower triangle
  inline T full(int64_t i, int64_t j) const {
    if (i >= j) return get(i, j);
    return conj_(get(j, i));
  }
  inline void full_set(int64_t i, int64_t j, T v) {
    if (i >= j)
      set(i, j, v);
    else
      set(j, i, conj_(v));
  }
};

template <class T>
void rotate_band(Band<T>& A, int64_t p, real_t<T> c, T s) {
  const int64_t n = A.n, b = A.b;
  const int64_t q = p + 1;
  // affected region: rows/cols max(0, p-b-1) .. min(n-1, q+b+1), but only
  // entries within band+bulge of (p, q)
  const int64_t lo = std::max<int64_t>(0, p - (b + 1));
  const int64_t hi = std::min<int64_t>(n - 1, q + (b + 1));
  // 1) rows p,q for columns k < p (within band)
  for (int64_t k = lo; k < p; ++k) {
    if (p - k > b + 1) continue;
    T ap = (p - k <= b + 1) ? A.get(p, k) : T(0);
    T aq = (q - k <= b + 1) ? A.get(q, k) : T(0);
    T np_ = c * ap + s * aq;
    T nq = -conj_(s) * ap + c * aq;
    if (p - k <= b + 1) A.set(p, k, np_);
    if (q - k <= b + 1) A.set(q, k, nq);
  }
  // 2) columns p,q for rows k > q (within band)
  for (int64_t k = q + 1; k <= hi; ++k) {
    if (k - p > b + 1) continue;
    T ap = (k - p <= b + 1) ? A.get(k, p) : T(0);
    T aq = (k - q <= b + 1) ? A.get(k, q) : T(0);
    // right-multiplication by G^H on columns: new col p gets conj coefs
    T np_ = c * ap + conj_(s) * aq;
    T nq = -s * ap + c * aq;
    if (k - p <= b + 1) A.set(k, p, np_);
    if (k - q <= b + 1) A.set(k, q, nq);
  }
  // 3) the 2x2 diagonal block (p,p),(q,p),(q,q)
  T app = A.get(p, p), aqp = A.get(q, p), aqq = A.get(q, q);
  // B = G * [app conj(aqp); aqp aqq] * G^H
  T t_pp = c * app + s * aqp;
  T t_pq = c * conj_(aqp) + s * aqq;
  T t_qp = -conj_(s) * app + c * aqp;
  T t_qq = -conj_(s) * conj_(aqp) + c * aqq;
  T n_pp = t_pp * c + t_pq * conj_(s);
  T n_qp = t_qp * c + t_qq * conj_(s);
  T n_qq = -(t_qp * s) + t_qq * c;
  A.set(p, p, n_pp);
  A.set(q, p, n_qp);
  A.set(q, q, n_qq);
}

// forward declaration; definition below shares the reduction loop between
// the Q-accumulating and stream-recording variants
template <class T, class Acc>
int band2trid_acc(int64_t n, int64_t b, T* ab, real_t<T>* d, T* e, Acc& acc);

template <class T>
int band2trid(int64_t n, int64_t b, T* ab, real_t<T>* d, T* e, T* q,
              int nthreads) {
  QAccumulator<T> acc(q, n, nthreads);
  return band2trid_acc<T>(n, b, ab, d, e, acc);
}

// ---- rotation-stream variant -----------------------------------------------
// Reduce once, retain the Givens stream, then apply Q = G_1^H G_2^H ... to an
// arbitrary n x k eigenvector block later (removes the N x N Q and makes
// partial-spectrum back-transforms cost O(R * k) — the reference's
// compact-transformation strategy, bt_band_to_tridiag/impl.h).

struct RotStream {
  std::vector<RotRec> rots;
};

template <class T>
class StreamRecorder {
 public:
  explicit StreamRecorder(RotStream* s) : s_(s) {}
  void push(int64_t p, real_t<T> c, T s) {
    double sre, sim;
    if constexpr (std::is_same_v<T, std::complex<double>> ||
                  std::is_same_v<T, std::complex<float>>) {
      sre = double(s.real());
      sim = double(s.imag());
    } else {
      sre = double(s);
      sim = 0.0;
    }
    s_->rots.push_back(RotRec{p, double(c), sre, sim});
  }
  void flush() {}

 private:
  RotStream* s_;
};

template <class T, class Acc>
int band2trid_acc(int64_t n, int64_t b, T* ab, real_t<T>* d, T* e, Acc& acc) {
  // shared reduction loop: annihilate column tails, chase bulges; Acc
  // either accumulates Q or records the rotation stream
  if (n <= 0) return 0;
  Band<T> A{ab, n, b, b + 2};
  if (b > 1) {
    for (int64_t j = 0; j + 2 < n; ++j) {
      const int64_t rmax = std::min(j + b, n - 1);
      for (int64_t r = rmax; r >= j + 2; --r) {
        if (abs2(A.get(r, j)) == real_t<T>(0)) continue;
        real_t<T> c;
        T s, rr;
        make_givens(A.get(r - 1, j), A.get(r, j), c, s, rr);
        rotate_band(A, r - 1, c, s);
        A.set(r, j, T(0));
        acc.push(r - 1, c, s);
        int64_t i = r;
        while (i + b < n) {
          const int64_t br = i + b;
          const int64_t bc = i - 1;
          if (abs2(A.get(br, bc)) == real_t<T>(0)) break;
          real_t<T> c2;
          T s2, r2;
          make_givens(A.get(br - 1, bc), A.get(br, bc), c2, s2, r2);
          rotate_band(A, br - 1, c2, s2);
          A.set(br, bc, T(0));
          acc.push(br - 1, c2, s2);
          i += b;
        }
      }
    }
  }
  acc.flush();
  for (int64_t j = 0; j < n; ++j) {
    if constexpr (std::is_same_v<T, std::complex<double>> ||
                  std::is_same_v<T, std::complex<float>>) {
      d[j] = A.get(j, j).real();
    } else {
      d[j] = A.get(j, j);
    }
    if (j + 1 < n) e[j] = A.get(j + 1, j);
  }
  return 0;
}

// Apply Q (= G_1^H G_2^H ... G_R^H, i.e. the stream in REVERSE with G^H) to
// rows of the n x k row-major block E: E := Q E.  Threads stripe columns.
template <class T>
void apply_stream_rows(const RotStream& s, T* ev, int64_t n, int64_t k,
                       int64_t c0, int64_t c1) {
  for (auto it = s.rots.rbegin(); it != s.rots.rend(); ++it) {
    const int64_t p = it->col;
    T sv;
    if constexpr (std::is_same_v<T, std::complex<double>> ||
                  std::is_same_v<T, std::complex<float>>) {
      sv = T(typename T::value_type(it->s_re), typename T::value_type(it->s_im));
    } else {
      sv = T(it->s_re);
    }
    const real_t<T> c = real_t<T>(it->c);
    T* rp = ev + p * k;
    T* rq = ev + (p + 1) * k;
    for (int64_t j = c0; j < c1; ++j) {
      T a = rp[j], bv = rq[j];
      rp[j] = c * a - sv * bv;
      rq[j] = conj_(sv) * a + c * bv;
    }
  }
}

template <class T>
int apply_stream(const RotStream& s, T* ev, int64_t n, int64_t k, int nthreads) {
  nthreads = std::max(1, nthreads);
  if (nthreads == 1 || k < 64) {
    apply_stream_rows(s, ev, n, k, 0, k);
    return 0;
  }
  std::vector<std::thread> ws;
  int64_t step = (k + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t c0 = t * step, c1 = std::min<int64_t>(k, c0 + step);
    if (c0 >= c1) break;
    ws.emplace_back([&s, ev, n, k, c0, c1] { apply_stream_rows(s, ev, n, k, c0, c1); });
  }
  for (auto& w : ws) w.join();
  return 0;
}

// ---- Householder sweep variant ------------------------------------------
// Same reduction (band -> tridiagonal) expressed as length-<=b Householder
// reflectors instead of Givens rotations (the reference's SweepWorker
// formulation, band_to_tridiag/mc.h:477-537: per step, two-sided Hermitian
// apply on [j, j+n), right-apply to the m x n bulge block, new reflector
// from the bulge's first column, left-apply to the remaining bulge columns).
// Reflector (s, m) has head row 1 + s + m*b and length min(b, n - head);
// it exists iff head <= n-2.  Storing reflectors (b values each + tau)
// enables the BLOCKED back-transform: groups of g consecutive sweeps at one
// chase level form a compact-WY factor applied to eigenvectors as GEMMs on
// the accelerator (bt_band_to_tridiag/impl.h's grouped-apply capability).
//
// Working storage: column-major (2b+1) x n, W[off + j*ld] = A[j+off, j].

template <class T>
void larfg_(int64_t L, T* x, T& tau, T* v) {
  // H = I - tau v v^H, H x = beta e1 (beta real), v[0] = 1.
  using R = real_t<T>;
  v[0] = T(1);
  for (int64_t i = 1; i < L; ++i) v[i] = T(0);
  if (L <= 1) {
    tau = T(0);
    return;
  }
  R xnorm2 = R(0);
  for (int64_t i = 1; i < L; ++i) xnorm2 += abs2(x[i]);
  T alpha = x[0];
  R alphi;
  if constexpr (std::is_same_v<T, std::complex<double>> ||
                std::is_same_v<T, std::complex<float>>) {
    alphi = alpha.imag();
  } else {
    alphi = R(0);
  }
  if (xnorm2 == R(0) && alphi == R(0)) {
    tau = T(0);
    return;
  }
  R alphr;
  if constexpr (std::is_same_v<T, std::complex<double>> ||
                std::is_same_v<T, std::complex<float>>) {
    alphr = alpha.real();
  } else {
    alphr = alpha;
  }
  R beta = -std::copysign(std::sqrt(abs2(alpha) + xnorm2), alphr);
  tau = (T(beta) - alpha) / T(beta);
  T scale = T(1) / (alpha - T(beta));
  for (int64_t i = 1; i < L; ++i) v[i] = scale * x[i];
  x[0] = T(beta);
  for (int64_t i = 1; i < L; ++i) x[i] = T(0);
}

template <class T>
struct WBand {
  T* w;
  int64_t n, b, ld;  // ld = 2b+1
  inline T& at(int64_t off, int64_t j) { return w[off + j * ld]; }  // A[j+off, j]
  inline T full(int64_t r, int64_t c) {
    if (r >= c) return at(r - c, c);
    return conj_(at(c - r, r));
  }
  inline void full_set(int64_t r, int64_t c, T val) {
    if (r >= c)
      at(r - c, c) = val;
    else
      at(c - r, r) = conj_(val);
  }
};

// A[j:j+nlen, j:j+nlen] <- H^H A H, H = I - tau v v^H.
// larfg's H satisfies H^H x = beta e1, so the similarity uses H^H on the
// left; the full transformation is then Q = H_1 H_2 ... H_R (taus
// unconjugated in the back-transform's compact-WY accumulation).
// her2k-style in-place form:  with w = A v, alpha = v^H w (real),
// z = tau w - (|tau|^2 alpha / 2) v:   A' = A - z v^H - v z^H
// (expand: A - conj(tau) v w^H - tau w v^H + |tau|^2 alpha v v^H) —
// two passes over the stored lower triangle, no dense scratch.
template <class T>
void hh_two_sided(WBand<T>& A, int64_t j, int64_t nlen, const T* v, T tau,
                  T* work) {
  T* w = work;
  for (int64_t r = 0; r < nlen; ++r) w[r] = T(0);
  // w = A v over the stored lower triangle (and its conjugate mirror)
  for (int64_t c = 0; c < nlen; ++c) {
    const T vc = v[c];
    T acc = T(0);  // accumulates conj(strict-lower column c) . v
    T* colp = &A.at(0, j + c);
    w[c] += colp[0] * vc;  // diagonal
    for (int64_t r = c + 1; r < nlen; ++r) {
      const T arc = colp[r - c];
      w[r] += arc * vc;
      acc += conj_(arc) * v[r];
    }
    w[c] += acc;
  }
  T alpha = T(0);
  for (int64_t r = 0; r < nlen; ++r) alpha += conj_(v[r]) * w[r];
  const T coeff = tau * conj_(tau) * alpha * T(real_t<T>(0.5));
  for (int64_t r = 0; r < nlen; ++r) w[r] = tau * w[r] - coeff * v[r];
  // A -= z v^H + v z^H on the stored lower triangle (z in w)
  for (int64_t c = 0; c < nlen; ++c) {
    const T cv = conj_(v[c]);
    const T cz = conj_(w[c]);
    T* colp = &A.at(0, j + c);
    for (int64_t r = c; r < nlen; ++r) colp[r - c] -= w[r] * cv + v[r] * cz;
  }
}

// rows [r0, r0+m) x cols [j, j+nlen): A <- A H (right apply)
template <class T>
void hh_right(WBand<T>& A, int64_t r0, int64_t m, int64_t j, int64_t nlen,
              const T* v, T tau) {
  for (int64_t r = r0; r < r0 + m; ++r) {
    T z = T(0);
    for (int64_t c = 0; c < nlen; ++c) z += A.at(r - (j + c), j + c) * v[c];
    z *= tau;
    for (int64_t c = 0; c < nlen; ++c) A.at(r - (j + c), j + c) -= z * conj_(v[c]);
  }
}

// rows [r0, r0+m) x cols [c0, c0+w): A <- H^H A (left apply)
template <class T>
void hh_left(WBand<T>& A, int64_t r0, int64_t m, int64_t c0, int64_t w,
             const T* v, T tau) {
  T ct = conj_(tau);
  for (int64_t c = c0; c < c0 + w; ++c) {
    T z = T(0);
    for (int64_t r = r0; r < r0 + m; ++r) z += conj_(v[r - r0]) * A.at(r - c, c);
    z *= ct;
    for (int64_t r = r0; r < r0 + m; ++r) A.at(r - c, c) -= z * v[r - r0];
  }
}

int64_t b2t_hh_count(int64_t n, int64_t b) {
  if (b <= 1 || n <= 2) return 0;
  int64_t total = 0;
  for (int64_t s = 0; s <= n - 3; ++s) total += (n - 3 - s) / b + 1;
  return total;
}

// One full sweep s: reflector (s, 0) from column s's band tail, then chase.
// Writes only slots [slot0, slot0 + count(s)) of v_out/tau_out and the band
// region rows/cols [s, last]; iteration m touches rows/cols
// [1+s+mb, s+mb+2b], so under pipelining it may run as soon as sweep s-1
// has completed iteration m+2 (regions of (s-1, m') with m' >= m+3 start at
// row s+mb+3b, strictly past this iteration's last row).
template <class T>
void run_sweep(WBand<T>& W, int64_t n, int64_t b, int64_t s, int64_t slot0,
               T* v_out, T* tau_out, T* work, T* vcur,
               std::atomic<int64_t>* progress) {
  auto wait_prev = [&](int64_t m) {
    if (s == 0) return;
    const std::atomic<int64_t>& prev = progress[s - 1];
    int64_t spins = 0;
    while (prev.load(std::memory_order_acquire) < m + 3) {
      if (++spins > 1024) {
        std::this_thread::yield();
        spins = 0;
      }
    }
  };
  int64_t slot = slot0;
  int64_t j = s + 1;
  int64_t L = std::min(b, n - j);
  wait_prev(0);
  T tau;
  larfg_(L, &W.at(1, s), tau, vcur);
  for (int64_t i = 0; i < b; ++i) v_out[i + slot * b] = i < L ? vcur[i] : T(0);
  tau_out[slot] = tau;
  ++slot;
  int64_t m_it = 0;
  while (true) {
    int64_t nlen = std::min(b, n - j);
    int64_t m = std::min(b, n - b - j);
    hh_two_sided(W, j, nlen, vcur, tau, work);
    if (m > 0) hh_right(W, j + nlen, m, j, nlen, vcur, tau);
    if (m <= 1) break;
    larfg_(m, &W.at(nlen, j), tau, vcur);
    for (int64_t i = 0; i < b; ++i) v_out[i + slot * b] = i < m ? vcur[i] : T(0);
    tau_out[slot] = tau;
    ++slot;
    hh_left(W, j + nlen, m, j + 1, nlen - 1, vcur, tau);
    j += b;
    ++m_it;
    progress[s].store(m_it, std::memory_order_release);
    wait_prev(m_it);
  }
  progress[s].store(int64_t(1) << 40, std::memory_order_release);  // done
}

// ab: (b+2) x n input band storage (only rows 0..b read); v_out: b x R
// column-major (slot order: sweep asc, step asc), tau_out: R.
// Sweeps are pipelined over worker threads (the reference's SweepWorker
// task pipeline, band_to_tridiag/mc.h — here with an atomic progress array
// enforcing the 3-step chase distance between consecutive sweeps).
template <class T>
int band2trid_hh(int64_t n, int64_t b, const T* ab, real_t<T>* d, T* e,
                 T* v_out, T* tau_out, int nthreads) {
  if (n <= 0) return 0;
  const int64_t ld = 2 * b + 1;
  std::vector<T> wbuf(size_t(ld) * size_t(n), T(0));
  WBand<T> W{wbuf.data(), n, b, ld};
  for (int64_t j = 0; j < n; ++j)
    for (int64_t off = 0; off <= b && j + off < n; ++off)
      W.at(off, j) = ab[off + j * (b + 2)];
  if (b > 1 && n > 2) {
    const int64_t nsweeps = n - 2;
    std::vector<int64_t> slot0(nsweeps + 1, 0);
    for (int64_t s = 0; s < nsweeps; ++s)
      slot0[s + 1] = slot0[s] + ((n - 3 - s) / b + 1);
    std::vector<std::atomic<int64_t>> progress(nsweeps);
    for (auto& p : progress) p.store(0, std::memory_order_relaxed);
    // pipeline depth: sweep s+1 trails sweep s by 3 chase steps, so at most
    // ~(steps per sweep)/3 sweeps can be in flight — more threads only spin
    const int64_t depth = std::max<int64_t>(1, (n / b + 2) / 3);
    nthreads = std::max(
        1, int(std::min<int64_t>(int64_t(nthreads), std::min<int64_t>(nsweeps, depth))));
    if (nthreads == 1) {
      std::vector<T> work(2 * b);
      std::vector<T> vcur(b);
      for (int64_t s = 0; s < nsweeps; ++s)
        run_sweep(W, n, b, s, slot0[s], v_out, tau_out, work.data(),
                  vcur.data(), progress.data());
    } else {
      std::atomic<int64_t> next{0};
      std::vector<std::thread> ws;
      for (int t = 0; t < nthreads; ++t) {
        ws.emplace_back([&] {
          std::vector<T> work(2 * b);
          std::vector<T> vcur(b);
          while (true) {
            int64_t s = next.fetch_add(1, std::memory_order_relaxed);
            if (s >= nsweeps) break;
            run_sweep(W, n, b, s, slot0[s], v_out, tau_out, work.data(),
                      vcur.data(), progress.data());
          }
        });
      }
      for (auto& w : ws) w.join();
    }
    if (slot0[nsweeps] != b2t_hh_count(n, b)) return -2;
  }
  for (int64_t j = 0; j < n; ++j) {
    if constexpr (std::is_same_v<T, std::complex<double>> ||
                  std::is_same_v<T, std::complex<float>>) {
      d[j] = W.at(0, j).real();
    } else {
      d[j] = W.at(0, j);
    }
    if (j + 1 < n) e[j] = W.at(1, j);
  }
  return 0;
}

}  // namespace

extern "C" {

int64_t dlaf_b2t_hh_count(int64_t n, int64_t b) { return b2t_hh_count(n, b); }

int dlaf_band2trid_hh_d(int64_t n, int64_t b, const double* ab, double* d,
                        double* e, double* v_out, double* tau_out,
                        int nthreads) {
  return band2trid_hh<double>(n, b, ab, d, e, v_out, tau_out, nthreads);
}

int dlaf_band2trid_hh_s(int64_t n, int64_t b, const float* ab, float* d,
                        float* e, float* v_out, float* tau_out, int nthreads) {
  return band2trid_hh<float>(n, b, ab, d, e, v_out, tau_out, nthreads);
}

int dlaf_band2trid_hh_z(int64_t n, int64_t b, const void* ab, double* d,
                        void* e, void* v_out, void* tau_out, int nthreads) {
  return band2trid_hh<std::complex<double>>(
      n, b, reinterpret_cast<const std::complex<double>*>(ab), d,
      reinterpret_cast<std::complex<double>*>(e),
      reinterpret_cast<std::complex<double>*>(v_out),
      reinterpret_cast<std::complex<double>*>(tau_out), nthreads);
}

int dlaf_band2trid_hh_c(int64_t n, int64_t b, const void* ab, float* d,
                        void* e, void* v_out, void* tau_out, int nthreads) {
  return band2trid_hh<std::complex<float>>(
      n, b, reinterpret_cast<const std::complex<float>*>(ab), d,
      reinterpret_cast<std::complex<float>*>(e),
      reinterpret_cast<std::complex<float>*>(v_out),
      reinterpret_cast<std::complex<float>*>(tau_out), nthreads);
}

void* dlaf_band2trid_stream_d(int64_t n, int64_t b, double* ab, double* d,
                              double* e) {
  auto* s = new RotStream();
  StreamRecorder<double> rec(s);
  band2trid_acc<double>(n, b, ab, d, e, rec);
  return s;
}

void* dlaf_band2trid_stream_z(int64_t n, int64_t b, void* ab, double* d,
                              void* e) {
  auto* s = new RotStream();
  StreamRecorder<std::complex<double>> rec(s);
  band2trid_acc<std::complex<double>>(
      n, b, reinterpret_cast<std::complex<double>*>(ab), d,
      reinterpret_cast<std::complex<double>*>(e), rec);
  return s;
}

void* dlaf_band2trid_stream_s(int64_t n, int64_t b, float* ab, float* d,
                              float* e) {
  auto* s = new RotStream();
  StreamRecorder<float> rec(s);
  band2trid_acc<float>(n, b, ab, d, e, rec);
  return s;
}

void* dlaf_band2trid_stream_c(int64_t n, int64_t b, void* ab, float* d,
                              void* e) {
  auto* s = new RotStream();
  StreamRecorder<std::complex<float>> rec(s);
  band2trid_acc<std::complex<float>>(
      n, b, reinterpret_cast<std::complex<float>*>(ab), d,
      reinterpret_cast<std::complex<float>*>(e), rec);
  return s;
}

int64_t dlaf_stream_size(void* handle) {
  return int64_t(reinterpret_cast<RotStream*>(handle)->rots.size());
}

int dlaf_stream_apply_d(void* handle, double* ev, int64_t n, int64_t k,
                        int nthreads) {
  return apply_stream<double>(*reinterpret_cast<RotStream*>(handle), ev, n, k,
                              nthreads);
}

int dlaf_stream_apply_z(void* handle, void* ev, int64_t n, int64_t k,
                        int nthreads) {
  return apply_stream<std::complex<double>>(
      *reinterpret_cast<RotStream*>(handle),
      reinterpret_cast<std::complex<double>*>(ev), n, k, nthreads);
}

int dlaf_stream_apply_s(void* handle, float* ev, int64_t n, int64_t k,
                        int nthreads) {
  return apply_stream<float>(*reinterpret_cast<RotStream*>(handle), ev, n, k,
                             nthreads);
}

int dlaf_stream_apply_c(void* handle, void* ev, int64_t n, int64_t k,
                        int nthreads) {
  return apply_stream<std::complex<float>>(
      *reinterpret_cast<RotStream*>(handle),
      reinterpret_cast<std::complex<float>*>(ev), n, k, nthreads);
}

void dlaf_stream_free(void* handle) {
  delete reinterpret_cast<RotStream*>(handle);
}

// Export the raw stream (in recorded order) for device-side blocked
// application: caller allocates arrays of dlaf_stream_size() entries.
void dlaf_stream_export(void* handle, int64_t* cols, double* c, double* s_re,
                        double* s_im) {
  const auto& rots = reinterpret_cast<RotStream*>(handle)->rots;
  for (size_t i = 0; i < rots.size(); ++i) {
    cols[i] = rots[i].col;
    c[i] = rots[i].c;
    s_re[i] = rots[i].s_re;
    s_im[i] = rots[i].s_im;
  }
}

int dlaf_band2trid_d(int64_t n, int64_t b, double* ab, double* d, double* e,
                     double* q, int nthreads) {
  return band2trid<double>(n, b, ab, d, e, q, nthreads);
}

int dlaf_band2trid_s(int64_t n, int64_t b, float* ab, float* d, float* e,
                     float* q, int nthreads) {
  return band2trid<float>(n, b, ab, d, e, q, nthreads);
}

int dlaf_band2trid_z(int64_t n, int64_t b, void* ab, double* d, void* e,
                     void* q, int nthreads) {
  return band2trid<std::complex<double>>(
      n, b, reinterpret_cast<std::complex<double>*>(ab), d,
      reinterpret_cast<std::complex<double>*>(e),
      reinterpret_cast<std::complex<double>*>(q), nthreads);
}

int dlaf_band2trid_c(int64_t n, int64_t b, void* ab, float* d, void* e,
                     void* q, int nthreads) {
  return band2trid<std::complex<float>>(
      n, b, reinterpret_cast<std::complex<float>*>(ab), d,
      reinterpret_cast<std::complex<float>*>(e),
      reinterpret_cast<std::complex<float>*>(q), nthreads);
}
}
