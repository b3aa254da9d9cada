// vb_math's exp and log over float32 arrays on the host, with a plain C
// interface (loaded with ctypes).
//
// Each function is the same sequence of IEEE operations as its torch form in
// core/models/vb_math.py (fexp: Cephes' expf; flog: Cephes' logf), so the
// two give the same bits: float32 +, -, * where the torch form works in
// float32, and each fused multiply-add as the float64 sum of an exact
// float64 product rounded once to float32. The torch form stays the one a
// CUDA card runs; this one spares the CPU the float64 temporaries of a
// tensor-at-a-time evaluation. Build with -ffp-contract=off and without
// -ffast-math, so that the compiler fuses and reorders nothing
// (-fno-trapping-math only lets it vectorise the selects).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
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

// vb_math._seq over `n` values of which those at or past `real` are the
// zeros of XLA's padding: the first value, then each next one added
float seq(const float* v, int64_t stride, int64_t n, int64_t real) {
  float acc = real > 0 ? v[0] : 0.0f;
  for (int64_t i = 1; i < n; ++i) acc = acc + (i < real ? v[i * stride] : 0.0f);
  return acc;
}

// vb_math.fsum_xla of one (lead, n) block: windows of `window` along n
// (zero-padded), each window's lead * window values one after another
// (lead-major), then the window sums the same way, in windows again while
// there are more than `window` of them
float fsum_xla(const float* x, int64_t lead, int64_t n, int64_t window,
               std::vector<float>& sums) {
  const int64_t nw = (n + window - 1) / window;
  sums.assign(nw, 0.0f);
  for (int64_t w = 0; w < nw; ++w) {
    const int64_t lo = w * window;
    const int64_t real = std::min(window, n - lo);
    float acc = 0.0f;
    for (int64_t k = 0; k < lead; ++k) {
      const float* v = x + k * n + lo;
      for (int64_t j = 0; j < window; ++j) {
        const float e = j < real ? v[j] : 0.0f;
        acc = (k == 0 && j == 0) ? e : acc + e;
      }
    }
    sums[w] = acc;
  }
  if (nw > window) {
    std::vector<float> inner;
    std::vector<float> outer(sums);
    return fsum_xla(outer.data(), 1, nw, window, inner);
  }
  return seq(sums.data(), 1, nw, nw);
}

}  // namespace

extern "C" {

// x (outer, lead, n) contiguous -> out (outer,)
void vb_fsum_xla(const float* x, float* out, int64_t outer, int64_t lead,
                 int64_t n, int64_t window, int threads) {
  auto run = [=](int64_t lo, int64_t hi) {
    std::vector<float> sums;
    for (int64_t o = lo; o < hi; ++o) {
      out[o] = fsum_xla(x + o * lead * n, lead, n, window, sums);
    }
  };
  if (threads <= 1 || outer * lead * n < (int64_t{1} << 16)) {
    run(0, outer);
    return;
  }
  const int64_t chunk = (outer + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int64_t lo = 0; lo < outer; lo += chunk) {
    pool.emplace_back(run, lo, std::min(outer, lo + chunk));
  }
  for (auto& t : pool) t.join();
}

void vb_fexp(const float* x, float* y, int64_t n, int threads) {
  apply<fexp>(x, y, n, threads);
}

void vb_flog(const float* x, float* y, int64_t n, int threads) {
  apply<flog>(x, y, n, threads);
}

}  // extern "C"
