// vb_math's arithmetic over float32 arrays on the host, and the whole
// subclone VB evaluation, with a plain C interface (loaded with ctypes).
//
// Each function is the same sequence of IEEE operations as its torch form in
// core/models/vb_math.py and core/models/subclone_vb.py, so the two give the
// same bits: float32 +, -, *, / where the torch form works in float32, float64
// where it works in float64, and each fused multiply-add as the float64 sum
// of an exact float64 product rounded once to float32. The torch forms stay
// the ones a CUDA card runs; these spare the CPU the dispatch of a few
// hundred small tensor operations a VB round.
//
//   vb_fexp, vb_flog        fexp (Cephes' expf), flog (Cephes' logf)
//   vb_fsum_xla             fsum_xla: XLA:CPU's windows of 32
//   vb_subclone_host        subclone_vb.vb_subclone_ops, one call an
//                           evaluation: alpha from the seeds, n_iter rounds,
//                           the ELBO
//
// vb_subclone_host keeps vb_subclone_ops's order within each (genotype,
// seed) block: a round takes e_ln_weights (fsum of the concentrations, its
// sequence or tree; fdigamma of each and of the sum; the differences), adds
// them to the reads' lnL, takes each read's max over K, fexp of the
// difference, fsum over K and the division, then fsum_xla over the reads
// and alpha0 plus that. The ELBO adds, in this order, ll_term, z_prior,
// z_entropy (-total of resp and flog(max(resp, 1e-30))), w_prior and
// w_entropy, each total an fdot chain over the flattened (K, N) when
// 0 < N <= 32 and fsum_xla of the products over (K, N) otherwise. Blocks
// are independent, so loops run across the reads, and across windows and
// rows where their chains are independent, without moving a rounding.
//
// Build with -ffp-contract=off and without -ffast-math, so that the compiler
// fuses and reorders nothing (-fno-trapping-math only lets it vectorise the
// selects).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr double kLn2Hi = 0.693359375;
constexpr double kLn2Lo = -0.00021219444170128554;
constexpr double kLog2e = 1.44269502162933349609375;
constexpr float kExpLo = -87.80000305175781f;
constexpr float kExpHi = 88.80000305175781f;
constexpr double kExpP[6] = {1.9875691214110702e-4, 1.398199936375022e-3,
                             8.333452045917511e-3, 4.166579619050026e-2,
                             0.1666666567325592, 0.5};
constexpr float kFltMin = 1.1754943508222875e-38f;
constexpr float kSqrtH = 0.7071067690849304f;
constexpr double kLogP[3][3] = {
    {0.07037683576345444, -0.11514610052108765, 0.11676998436450958},
    {-0.12420140951871872, 0.14249323308467865, -0.16668057441711426},
    {0.2000071406364441, -0.24999994039535522, 0.3333333134651184}};

// vb_math's float32 constants (pi, ln pi, ln(2 pi) / 2, ln 7.5, 1 / 7.5,
// the Lanczos g = 7 coefficients, sqrt(2) - 1), bit for bit
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kLogPi = 0x1.250d04p+0f;
constexpr float kHalfLog2Pi = 0x1.d67f1cp-1f;
constexpr float kLogGHalf = 0x1.01e858p+1f;
constexpr float kInvGHalf = 0x1.111112p-3f;
constexpr float kLanczos[8] = {0x1.52429cp+9f,  -0x1.3ac8e8p+10f,
                               0x1.81a966p+9f,  -0x1.613ae6p+7f,
                               0x1.903c28p+3f,  -0x1.1bcb2ap-3f,
                               0x1.4f0514p-17f, 0x1.435508p-23f};
constexpr float kLog1pSmall = 0x1.a8279ap-2f;
constexpr double kLog1pNum[7] = {0x1.7bc096p-15, 0x1.fe818ap-2, 0x1.a509f4p+2,
                                 0x1.de9738p+4,  0x1.e798ecp+5, 0x1.c8e75ap+5,
                                 0x1.40a202p+4};
constexpr double kLog1pDen[7] = {0x1p+0,        0x1.e2035ap+3, 0x1.4c30b6p+6,
                                 0x1.bb865ap+7, 0x1.351946p+8, 0x1.b0db14p+7,
                                 0x1.e0f304p+5};
// glibc's sinf/cosf (sincosf_data.c): pi/2, 2/pi, the cosine's c0-c4, the
// sine's s1-s3
constexpr double kHpi = 0x1.921fb54442d18p+0;
constexpr double kHpiInv = 0x1.45f306dc9c883p-1;
constexpr double kCosC[5] = {0x1p+0, -0x1.ffffffd0c621cp-2,
                             0x1.55553e1068f19p-5, -0x1.6c087e89a359dp-10,
                             0x1.99343027bf8c3p-16};
constexpr double kSinS[3] = {-0x1.555545995a603p-3, 0x1.1107605230bc4p-7,
                             -0x1.994eb3774cf24p-13};
constexpr float kRespMin = 0x1.4484cp-100f;  // float32(1e-30): the clamp
constexpr int64_t kWindow = 32;              // fsum_xla's window

// vb_math.ffma: a * b + c in float64 (the product of float32 values is
// exact there), rounded once to float32
inline float ffma(double a, double b, double c) {
  return static_cast<float>(a * b + c);
}

inline float from_bits(int32_t b) {
  float f;
  std::memcpy(&f, &b, sizeof f);
  return f;
}

inline int32_t to_bits(float f) {
  int32_t b;
  std::memcpy(&b, &f, sizeof b);
  return b;
}

// branch-free (selects, loops unrolled), so that g++ vectorises the loops
// over the arrays
inline float fexp(float x) {
  x = std::min(std::max(x, kExpLo), kExpHi);  // as torch.clamp: NaN passes
  float n = std::floor(ffma(x, kLog2e, 0.5));
  n = std::min(std::max(n, -127.0f), 127.0f);
  const double n64 = n;
  const double r = ffma(n64, -kLn2Lo, ffma(n64, -kLn2Hi, x));
  float p = ffma(r, kExpP[0], kExpP[1]);
  p = ffma(p, r, kExpP[2]);
  p = ffma(p, r, kExpP[3]);
  p = ffma(p, r, kExpP[4]);
  p = ffma(p, r, kExpP[5]);
  const float rr = static_cast<float>(r * r);
  float y = ffma(p, rr, r) + 1.0f;
  y = y * from_bits((static_cast<int32_t>(n) + 127) << 23);
  return y < kFltMin ? 0.0f : y;  // flushed
}

inline float flog(float x) {
  x = x > kFltMin ? x : kFltMin;
  const int32_t bits = to_bits(x);
  float e = static_cast<float>((bits >> 23) - 127) + 1.0f;
  const float m = from_bits((bits & 0x7FFFFF) | 0x3F000000);  // [0.5, 1)
  const bool lt = m < kSqrtH;
  e = e - (lt ? 1.0f : 0.0f);
  const float f = (m - 1.0f) + (lt ? m : 0.0f);
  const float z = f * f;
  const double f64 = f;
  const double f3 = z * f;
  const float a = ffma(ffma(f64, kLogP[0][0], kLogP[0][1]), f64, kLogP[0][2]);
  const float b = ffma(ffma(f64, kLogP[1][0], kLogP[1][1]), f64, kLogP[1][2]);
  const float c = ffma(ffma(f64, kLogP[2][0], kLogP[2][1]), f64, kLogP[2][2]);
  float y = ffma(ffma(a, f3, b), f3, c);
  y = ffma(y, f3, e * static_cast<float>(kLn2Lo));
  return ffma(e, kLn2Hi, (f - 0.5f * z) + y);
}

// vb_math.flog1p: Cephes' rational form below sqrt(2) - 1, else flog
inline float flog1p(float x) {
  if (std::fabs(x) < kLog1pSmall) {
    const double x64 = x;
    float num = static_cast<float>(kLog1pNum[0]);
    float den = static_cast<float>(kLog1pDen[0]);
    for (int i = 1; i < 7; ++i) {
      num = ffma(num, x64, kLog1pNum[i]);
      den = ffma(den, x64, kLog1pDen[i]);
    }
    const float x2 = x * x;
    return x + ffma(x2, -0.5, (x * x2) * (num / den));
  }
  return flog(x + 1.0f);
}

inline double sin_poly(double x, double x2) {
  const double x3 = x * x2;
  const double s1 = kSinS[1] + x2 * kSinS[2];
  return (x + x3 * kSinS[0]) + (x3 * x2) * s1;
}

inline double cos_poly(double x2) {
  const double x4 = x2 * x2;
  const double c2 = kCosC[3] + x2 * kCosC[4];
  const double c1 = kCosC[0] + x2 * kCosC[1];
  return (c1 + x4 * kCosC[2]) + (x4 * x2) * c2;
}

// vb_math._sincos: glibc's sinf and cosf of a in [0, pi/2], in double
inline void fsincos(float a, float* sin, float* cos) {
  const double x = a;
  const double n = a >= 0.75f ? std::floor(x * kHpiInv + 0.5) : 0.0;
  const double r = x - n * kHpi;
  const double r2 = r * r;
  const bool odd = n == 1.0;
  *sin = static_cast<float>(odd ? cos_poly(r2) : sin_poly(r, r2));
  *cos = static_cast<float>(odd ? sin_poly(-r, r2) : cos_poly(r2));
}

// vb_math._lanczos_z: z (-x below 1/2, reflected; x - 1 above) and z + i
inline bool lanczos_z(float x, float* z, float zi[8]) {
  const bool reflect = x < 0.5f;
  *z = reflect ? -x : x - 1.0f;
  for (int i = 0; i < 8; ++i) zi[i] = *z + static_cast<float>(i + 1);
  return reflect;
}

// vb_math._log_t: ln(z + 7.5) as ln 7.5 + log1p(z / 7.5)
inline float log_t(float z) { return flog1p(z * kInvGHalf) + kLogGHalf; }

// vb_math.flgamma
float flgamma(float x) {
  float z, zi[8];
  const bool reflect = lanczos_z(x, &z, zi);
  float a = kLanczos[0] / zi[0] + 1.0f;
  for (int i = 1; i < 8; ++i) a = a + kLanczos[i] / zi[i];
  const float t = z + 7.5f;
  const float lt = log_t(z);
  const float log_y = ffma((z + 0.5f) - t / lt, lt, kHalfLog2Pi) + flog(a);
  if (!reflect) return log_y;
  float frac = x - std::floor(x);
  frac = frac > 0.5f ? 1.0f - frac : frac;
  float sin, cos;
  fsincos(frac * kPi, &sin, &cos);
  return (kLogPi - flog(sin)) - log_y;
}

// vb_math.fdigamma
float fdigamma(float x) {
  float z, zi[8];
  const bool reflect = lanczos_z(x, &z, zi);
  float num = 0.0f;
  float den = kLanczos[0] / zi[0] + 1.0f;
  for (int i = 0; i < 8; ++i) {
    num = num - kLanczos[i] / (zi[i] * zi[i]);
    if (i) den = den + kLanczos[i] / zi[i];
  }
  const float y = (log_t(z) + num / den) - 7.0f / (z + 7.5f);
  if (!reflect) return y;
  float sin, cos;
  fsincos((x + std::fabs(std::floor(x + 0.5f))) * kPi, &sin, &cos);
  return y - (cos * kPi) / sin;
}

template <float (*F)(float)>
void run(const float* __restrict x, float* __restrict y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] = F(x[i]);
}

template <float (*F)(float)>
void apply(const float* x, float* y, int64_t n, int threads) {
  if (threads <= 1 || n < (int64_t{1} << 16)) {
    run<F>(x, y, n);
    return;
  }
  const int64_t chunk = (n + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int64_t lo = 0; lo < n; lo += chunk) {
    pool.emplace_back(run<F>, x + lo, y + lo, std::min(n - lo, chunk));
  }
  for (auto& t : pool) t.join();
}

// the scratch arrays of one thread's evaluations: window sums, the next
// level's, and rows (fsum's tree, a total's products)
struct Scratch {
  std::vector<float> sums, outer, rows;
};

inline float* sized(std::vector<float>& v, int64_t n) {
  if (static_cast<int64_t>(v.size()) < n) v.resize(n);
  return v.data();
}

// vb_math.fsum over `rows` rows of `n` values (row r at x + r * n), each of
// the n sums into out: in sequence up to 8 rows, else a pairwise tree over
// the rows padded with zero rows to a power of two
void fsum_rows(const float* x, int64_t rows, int64_t n, float* out,
               std::vector<float>& tree) {
  if (rows <= 8) {
    std::copy(x, x + n, out);
    for (int64_t r = 1; r < rows; ++r) {
      const float* row = x + r * n;
      for (int64_t i = 0; i < n; ++i) out[i] = out[i] + row[i];
    }
    return;
  }
  int64_t size = 1;
  while (size < rows) size *= 2;
  float* t = sized(tree, size * n);
  std::copy(x, x + rows * n, t);
  std::fill(t + rows * n, t + size * n, 0.0f);
  while (size > 1) {
    size /= 2;
    for (int64_t i = 0; i < size * n; ++i) t[i] = t[i] + t[i + size * n];
  }
  std::copy(t, t + n, out);
}

// fsum_xla's first level over `lead` rows of `n` values, row r at
// x + r * stride: window w's sum adds, one after another, row 0's values in
// [w * window, (w + 1) * window) (zeros past n), then row 1's, and so on.
// The windows' chains are independent and advance together.
void window_sums(const float* x, int64_t lead, int64_t stride, int64_t n,
                 int64_t window, float* sums) {
  const int64_t nw = (n + window - 1) / window;
  const int64_t full = n / window;  // windows with no padding
  for (int64_t w = 0; w < nw; ++w) sums[w] = x[w * window];
  for (int64_t k = 0; k < lead; ++k) {
    const float* row = x + k * stride;
    for (int64_t j = k == 0 ? 1 : 0; j < window; ++j) {
      for (int64_t w = 0; w < full; ++w) {
        sums[w] = sums[w] + row[w * window + j];
      }
      if (full < nw) {
        const int64_t i = full * window + j;
        sums[full] = sums[full] + (i < n ? row[i] : 0.0f);
      }
    }
  }
}

// vb_math.fsum_xla of one block of `lead` rows of n values (row r at
// x + r * stride): the window sums, added in windows again while there are
// more than `window` of them, then one after another
float fsum_xla(const float* x, int64_t lead, int64_t stride, int64_t n,
               int64_t window, Scratch& s) {
  if (n == 0) return 0.0f;
  int64_t nw = (n + window - 1) / window;
  float* sums = sized(s.sums, nw);
  window_sums(x, lead, stride, n, window, sums);
  while (nw > window) {
    const int64_t next = (nw + window - 1) / window;
    float* outer = sized(s.outer, next);
    window_sums(sums, 1, nw, nw, window, outer);
    std::copy(outer, outer + next, sums);
    nw = next;
  }
  float acc = sums[0];
  for (int64_t w = 1; w < nw; ++w) acc = acc + sums[w];
  return acc;
}

// vb_math.fdot: a[0] * b[0], then a multiply-add a step
float fdot(const float* a, const float* b, int64_t n) {
  float acc = a[0] * b[0];
  for (int64_t i = 1; i < n; ++i) acc = ffma(a[i], b[i], acc);
  return acc;
}

// subclone_vb.e_ln_weights of K concentrations: digamma of each less
// digamma of their fsum
void e_ln_weights(const float* conc, int64_t K, float* out, Scratch& s) {
  float total;
  fsum_rows(conc, K, 1, &total, s.rows);
  const float d_total = fdigamma(total);
  for (int64_t k = 0; k < K; ++k) out[k] = fdigamma(conc[k]) - d_total;
}

struct Subclone {
  const float* lnl;        // (G, K, N)
  const float* alpha0;     // (K,)
  const float* resp_init;  // (S, K, N)
  float* elbo;             // (G, S)
  float* alpha;            // (G, S, K)
  float* resp;             // (G, S, K, N)
  int64_t G, S, K, N, n_iter;
};

// vb_subclone_ops's total: the sum over (K, N) of a * b
float total(const Subclone& p, const float* a, const float* b, Scratch& s) {
  const int64_t KN = p.K * p.N;
  if (p.N > 0 && p.N <= kWindow) return fdot(a, b, KN);
  float* prod = sized(s.rows, KN);
  for (int64_t i = 0; i < KN; ++i) prod[i] = a[i] * b[i];
  return fsum_xla(prod, p.K, p.N, p.N, kWindow, s);
}

// one round of step() for the block (g, s): resp from conc, then
// alpha_out = alpha0 + fsum_xla(resp) (alpha_out may be conc)
void step(const Subclone& p, const float* lnl_g, const float* conc,
          float* resp, float* alpha_out, Scratch& s, float* elw, float* col) {
  const int64_t K = p.K, N = p.N;
  e_ln_weights(conc, K, elw, s);
  for (int64_t k = 0; k < K; ++k) {
    const float e = elw[k];
    const float* l = lnl_g + k * N;
    float* x = resp + k * N;
    for (int64_t n = 0; n < N; ++n) x[n] = e + l[n];
  }
  // fsoftmax over K: the max (NaN wins, as in amax), fexp of the
  // difference, over the fsum
  std::copy(resp, resp + N, col);
  for (int64_t k = 1; k < K; ++k) {
    const float* x = resp + k * N;
    for (int64_t n = 0; n < N; ++n) {
      col[n] = (x[n] > col[n] || x[n] != x[n]) ? x[n] : col[n];
    }
  }
  for (int64_t k = 0; k < K; ++k) {
    float* x = resp + k * N;
    for (int64_t n = 0; n < N; ++n) x[n] = fexp(x[n] - col[n]);
  }
  fsum_rows(resp, K, N, col, s.rows);
  for (int64_t k = 0; k < K; ++k) {
    float* x = resp + k * N;
    for (int64_t n = 0; n < N; ++n) x[n] = x[n] / col[n];
  }
  for (int64_t k = 0; k < K; ++k) {
    alpha_out[k] = p.alpha0[k] + fsum_xla(resp + k * N, 1, N, N, kWindow, s);
  }
}

// genotype rows [lo, hi): every seed's rounds and ELBO
void subclone_rows(const Subclone& p, float w_prior0, int64_t lo, int64_t hi) {
  const int64_t S = p.S, K = p.K, N = p.N, KN = K * N;
  Scratch s;
  std::vector<float> elw(K), a0m1(K), am1(K), lg(K), col(N), logs(KN);
  std::vector<float> bcast(KN), init(S * K);
  for (int64_t i = 0; i < S * K; ++i) {
    init[i] = p.alpha0[i % K] +
              fsum_xla(p.resp_init + i * N, 1, N, N, kWindow, s);
  }
  for (int64_t k = 0; k < K; ++k) a0m1[k] = p.alpha0[k] - 1.0f;
  for (int64_t g = lo; g < hi; ++g) {
    const float* lnl_g = p.lnl + g * KN;
    for (int64_t j = 0; j < S; ++j) {
      float* resp = p.resp + (g * S + j) * KN;
      float* alpha = p.alpha + (g * S + j) * K;
      const float* seed = p.resp_init + j * KN;
      std::copy(init.data() + j * K, init.data() + (j + 1) * K, alpha);
      if (p.n_iter < 1) std::copy(seed, seed + KN, resp);
      for (int64_t it = 0; it < p.n_iter; ++it) {
        step(p, lnl_g, alpha, resp, alpha, s, elw.data(), col.data());
      }
      // the ELBO
      e_ln_weights(alpha, K, elw.data(), s);
      const float ll_term = total(p, resp, lnl_g, s);
      for (int64_t k = 0; k < K; ++k) {
        std::fill(bcast.data() + k * N, bcast.data() + (k + 1) * N, elw[k]);
      }
      const float z_prior = total(p, resp, bcast.data(), s);
      for (int64_t i = 0; i < KN; ++i) {
        const float r = resp[i];
        logs[i] = flog(r < kRespMin ? kRespMin : r);  // NaN passes
      }
      const float z_entropy = -total(p, resp, logs.data(), s);
      const float w_prior = w_prior0 + fdot(a0m1.data(), elw.data(), K);
      float sum;
      fsum_rows(alpha, K, 1, &sum, s.rows);
      for (int64_t k = 0; k < K; ++k) lg[k] = flgamma(alpha[k]);
      float lg_sum;
      fsum_rows(lg.data(), K, 1, &lg_sum, s.rows);
      for (int64_t k = 0; k < K; ++k) am1[k] = alpha[k] - 1.0f;
      const float w_entropy =
          -((flgamma(sum) - lg_sum) + fdot(am1.data(), elw.data(), K));
      p.elbo[g * S + j] =
          (((ll_term + z_prior) + z_entropy) + w_prior) + w_entropy;
    }
  }
}

}  // namespace

extern "C" {

// x (outer, lead, n) contiguous -> out (outer,)
void vb_fsum_xla(const float* x, float* out, int64_t outer, int64_t lead,
                 int64_t n, int64_t window, int threads) {
  auto rows = [=](int64_t lo, int64_t hi) {
    Scratch s;
    for (int64_t o = lo; o < hi; ++o) {
      out[o] = fsum_xla(x + o * lead * n, lead, n, n, window, s);
    }
  };
  if (threads <= 1 || outer * lead * n < (int64_t{1} << 16)) {
    rows(0, outer);
    return;
  }
  const int64_t chunk = (outer + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int64_t lo = 0; lo < outer; lo += chunk) {
    pool.emplace_back(rows, lo, std::min(outer, lo + chunk));
  }
  for (auto& t : pool) t.join();
}

void vb_fexp(const float* x, float* y, int64_t n, int threads) {
  apply<fexp>(x, y, n, threads);
}

void vb_flog(const float* x, float* y, int64_t n, int threads) {
  apply<flog>(x, y, n, threads);
}

// subclone_vb.vb_subclone_ops over contiguous float32 arrays (shapes at
// Subclone), K >= 1; genotype rows split over `threads` from 2^18
// element-rounds
void vb_subclone_host(const float* lnl, const float* alpha0,
                      const float* resp_init, float* elbo, float* alpha,
                      float* resp, int64_t G, int64_t S, int64_t K, int64_t N,
                      int64_t n_iter, int threads) {
  const Subclone p{lnl, alpha0, resp_init, elbo, alpha, resp,
                   G, S, K, N, n_iter};
  // w_prior's part without e_ln_w: lgamma of alpha0's fsum less the fsum
  // of alpha0's lgammas
  Scratch s;
  float sum, lg_sum;
  fsum_rows(alpha0, K, 1, &sum, s.rows);
  std::vector<float> lg(K);
  for (int64_t k = 0; k < K; ++k) lg[k] = flgamma(alpha0[k]);
  fsum_rows(lg.data(), K, 1, &lg_sum, s.rows);
  const float w_prior0 = flgamma(sum) - lg_sum;
  const int64_t work = G * S * K * N * std::max<int64_t>(n_iter, 1);
  const int64_t parts = std::min<int64_t>(threads, G);
  if (parts <= 1 || work < (int64_t{1} << 18)) {
    subclone_rows(p, w_prior0, 0, G);
    return;
  }
  const int64_t chunk = (G + parts - 1) / parts;
  std::vector<std::thread> pool;
  for (int64_t lo = 0; lo < G; lo += chunk) {
    pool.emplace_back(subclone_rows, std::cref(p), w_prior0, lo,
                      std::min(G, lo + chunk));
  }
  for (auto& t : pool) t.join();
}

}  // extern "C"
