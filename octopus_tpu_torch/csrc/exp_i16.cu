// Experiment i16_probe on Hopper, sm_90a: the pair-HMM's op mix in int16.
//
// Replaces experiments/i16_probe.py's TPU kernel (`run`, kernel `kern`,
// pl.pallas_call at :35), which asked whether the TPU toolchain lowers
// int16 vector min, shift, compare and select in a fori_loop. The function,
// on a (D, B) int16 pair a, b with INF16 = 16000 and m = a, i = b at first:
// fifty rounds of
//   shifted = m one row down (row 0: INF16)
//   mn      = min(m + a, min(i, shifted))
//   u       = (a == b) ? mn : i + 2
//   u       = min(u, u shifted down s rows, INF16 in the first s), s = 1, 2, 4
//   m, i    = mn, u
// then out = min(m, i). Sums wrap as int16 (JAX's). Its plain version is
// `kern_plain` in kernel_experiments/i16_probe.py.
//
// The question on this card: do two int16 lanes in one 32-bit register
// halve the instructions? PACK = 2 holds two batch columns a register
// (int16x2 words, the natural layout of a row-major int16 (D, B) array)
// with the D = 16 rows in registers, so the row shift is a register rename.
// A round is, per word (two elements): __viaddmin_s16x2 (m + a, then min)
// and __vmins2 (i, shifted) for mn; __viaddmax_s16x2 (i + 2, then max with
// -32768, i.e. the wrapped sum) for i + 2; one LOP3 for the select under
// the loop-invariant __vcmpeq2 mask; three __vmins2 for the prefix min:
// 7 instructions for two elements where each intrinsic is one packed
// instruction (VIADDMNMX / VIMNMX with .S16x2 in SASS). PACK = 1 is the same kernel one int16 a
// thread in 32-bit registers (sign-extended, truncated after each sum).
// The DPX forms used here are the non-saturating ones (no _relu).
//
// What bounds it: int operations (7 an element a round, each DPX form
// one, against 6 bytes an element moved once). chip_smoke.py reads the
// built library's SASS (cuobjdump -sass) for the .S16x2 forms and the
// loop's instructions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 16;
constexpr int ROUNDS = 50;
constexpr short INF16 = 16000;
constexpr unsigned INF16X2 = 0x3E803E80u;  // 16000 in both halves

template <int PACK>
__global__ void __launch_bounds__(256)
i16_kernel(const void* __restrict__ a_, const void* __restrict__ b_,
           void* __restrict__ out_, int B) {
  const int cols = B / PACK;  // words a row
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  if constexpr (PACK == 2) {
    const unsigned* a = static_cast<const unsigned*>(a_);
    const unsigned* b = static_cast<const unsigned*>(b_);
    unsigned* out = static_cast<unsigned*>(out_);
    unsigned av[D], eq[D], m[D], i[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      av[d] = a[(size_t)d * cols + c];
      i[d] = b[(size_t)d * cols + c];
      m[d] = av[d];
      eq[d] = __vcmpeq2(av[d], i[d]);
    }
#pragma unroll 1
    for (int r = 0; r < ROUNDS; ++r) {
      unsigned mn[D], u[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const unsigned shifted = d == 0 ? INF16X2 : m[d > 0 ? d - 1 : 0];
        mn[d] = __viaddmin_s16x2(m[d], av[d], __vmins2(i[d], shifted));
        const unsigned ip2 = __viaddmax_s16x2(i[d], 0x00020002u, 0x80008000u);
        u[d] = (mn[d] & eq[d]) | (ip2 & ~eq[d]);
      }
#pragma unroll
      for (int s = 1; s < 8; s <<= 1) {
#pragma unroll
        for (int d = D - 1; d >= 0; --d)
          u[d] = __vmins2(u[d], d >= s ? u[d >= s ? d - s : 0] : INF16X2);
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        m[d] = mn[d];
        i[d] = u[d];
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) out[(size_t)d * cols + c] = __vmins2(m[d], i[d]);
  } else {
    const short* a = static_cast<const short*>(a_);
    const short* b = static_cast<const short*>(b_);
    short* out = static_cast<short*>(out_);
    int av[D], m[D], i[D];
    bool eq[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      av[d] = a[(size_t)d * cols + c];
      i[d] = b[(size_t)d * cols + c];
      m[d] = av[d];
      eq[d] = av[d] == i[d];
    }
#pragma unroll 1
    for (int r = 0; r < ROUNDS; ++r) {
      int mn[D], u[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int shifted = d == 0 ? INF16 : m[d > 0 ? d - 1 : 0];
        mn[d] = min((int)(short)(m[d] + av[d]), min(i[d], shifted));
        u[d] = eq[d] ? mn[d] : (int)(short)(i[d] + 2);
      }
#pragma unroll
      for (int s = 1; s < 8; s <<= 1) {
#pragma unroll
        for (int d = D - 1; d >= 0; --d)
          u[d] = min(u[d], d >= s ? u[d >= s ? d - s : 0] : (int)INF16);
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        m[d] = mn[d];
        i[d] = u[d];
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) out[(size_t)d * cols + c] = (short)min(m[d], i[d]);
  }
}

}  // namespace

// Plain C entry point for ctypes: a, b and out are (D, B) int16 device
// arrays, row-major; D = 16; pack = 2 (two int16 a 32-bit register, B
// even, 4-byte aligned rows) or 1 (one a thread). Returns the cudaError_t.
extern "C" int exp_i16_launch(const void* a, const void* b, void* out, int D_,
                              int B, int pack, void* stream) {
  if (D_ != D || B <= 0 || (pack != 1 && pack != 2) || B % pack)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const int blocks = (B / pack + threads - 1) / threads;
  if (pack == 2)
    i16_kernel<2><<<blocks, threads, 0, s>>>(a, b, out, B);
  else
    i16_kernel<1><<<blocks, threads, 0, s>>>(a, b, out, B);
  return (int)cudaGetLastError();
}
