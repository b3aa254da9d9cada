// Banded pair-HMM (integer-phred Viterbi) over a precomputed match-cost
// tensor, for Hopper, sm_90a.
//
// Replaces the reference package's TPU kernel #4,
// octopus_tpu/core/likelihood/pairhmm_batch.py:
//   pairhmm_scores_pallas_v2 / _pallas_kernel_v2
// which runs the row wavefront over an (R*D, B) match-cost tensor that XLA
// builds outside the kernel (_match_cost_tensor). Here the port's torch
// _match_cost_tensor builds it outside the kernel in the same way, and the
// kernel reads it with the opn and ext tracks. Its plain twin is
// pairhmm_scores_cost_plain in octopus_tpu_torch/core/likelihood/
// pairhmm_batch.py (the XLA wavefront with its log-step min-plus deletion
// scan); the two agree bit for bit.
//
// Semantics (pair b, D = 2*pad diagonals, rows y = 1..R, lane d of row y
// pairs read base y-1 with window base j = y-1+d):
//   M'd  = cm[(y-1)*D + d] + min(Md, Id, Dd)
//   I'd  = nuc_prior + min(Mg[d+1] + opn[j], I[d+1] + ext[j])  (lane D: INF)
//   bv_d = min(M'[d-1], I'[d-1]) + opn[j]                       (lane -1: INF)
//   D'd  = min(bv_d, D'[d-1] + ext[j])                          (D'[-1] = INF)
// Mg is the parity-masked M0 on row 1 (0 at odd d, INF at even d) and M
// afterwards; row 0's deletions come from opn/ext shifted down one lane. The
// chain D'd is v2's _deletion_scan (the min-plus scan of the maps
// v -> min(bv_d, v + ext[j]) fed v = INF) run sequentially: the same
// integers, lane 0 included (int32 sums of INF = 1<<29 terms stay below
// 2^31).
//
// Design: one thread per pair, M/I/D as int[D] register arrays, the D loop
// unrolled. Tracks are in kernel layout, cm (R*D, B) and opn/ext (W, B), so
// a warp's 32 threads read 32 adjacent pairs of one row in one coalesced
// load. The ragged batch edge is a bounds check (v2's B % 128 assertion is
// dropped).
//
// What bounds it: bytes. The kernel's own work reads cm once (R*D int32 per
// pair) and opn/ext once ((2W) int32 per pair) and does 11 int32 ops per
// cell (the 8 match-cost ops ran outside, when cm was built): at 4 bytes of
// cm per cell against 11 ops, device memory at 3.35 TB/s is the limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = 1 << 29;
constexpr int BLOCK = 128;

template <int D>
__global__ void __launch_bounds__(BLOCK)
pairhmm_cost_kernel(const int* __restrict__ cm, const int* __restrict__ opn,
                    const int* __restrict__ ext, int* __restrict__ out, int B,
                    int R, int nuc_prior) {
  const int b = blockIdx.x * BLOCK + threadIdx.x;
  if (b >= B) return;  // ragged batch edge
  const size_t stride = B;

  int M[D], I[D], Dl[D];
  // row 0: M = 0; I = INF; deletions from the parity-masked M0 with opn and
  // ext shifted down one lane (fills INF and 0)
  {
    int prev = INF;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      M[d] = 0;
      I[d] = INF;
      const int m_gap_prev = (d == 0) ? INF : (((d - 1) & 1) ? 0 : INF);
      const int o = (d == 0) ? INF : __ldg(opn + (d - 1) * stride + b);
      const int e = (d == 0) ? 0 : __ldg(ext + (d - 1) * stride + b);
      const int bv = m_gap_prev + o;
      prev = min(bv, prev + e);
      Dl[d] = prev;
    }
  }

  for (int y = 1; y <= R; ++y) {
    const int* cm_row = cm + (size_t)(y - 1) * D * stride + b;
    const int* o_row = opn + (size_t)(y - 1) * stride + b;
    const int* e_row = ext + (size_t)(y - 1) * stride + b;
    const bool first = (y == 1);
    int m_prev = INF, i_prev = INF, d_prev = INF;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int c = __ldg(cm_row + d * stride);
      const int o = __ldg(o_row + d * stride);
      const int e = __ldg(e_row + d * stride);
      const int mn = c + min(min(M[d], I[d]), Dl[d]);
      int m_up, i_up;
      if (d + 1 < D) {
        m_up = first ? (((d + 1) & 1) ? 0 : INF) : M[d + 1];
        i_up = I[d + 1];
      } else {
        m_up = INF;
        i_up = INF;
      }
      const int in = nuc_prior + min(m_up + o, i_up + e);
      const int bv = ((d == 0) ? INF : min(m_prev, i_prev)) + o;
      d_prev = min(bv, d_prev + e);
      M[d] = mn;
      I[d] = in;
      Dl[d] = d_prev;
      m_prev = mn;
      i_prev = in;
    }
  }

  int best = INF;
#pragma unroll
  for (int d = 0; d < D; ++d) best = min(best, min(min(M[d], I[d]), Dl[d]));
  out[b] = best;
}

template <int D>
cudaError_t launch(const int* cm, const int* opn, const int* ext, int* out,
                   int B, int R, int nuc_prior, cudaStream_t stream) {
  const int grid = (B + BLOCK - 1) / BLOCK;
  pairhmm_cost_kernel<D><<<grid, BLOCK, 0, stream>>>(cm, opn, ext, out, B, R,
                                                     nuc_prior);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. cm is an int32 device pointer in (R*D, B)
// layout (row (y-1)*D + d pairs read base y-1 with window base y-1+d),
// opn/ext (W, B) with W = R + 2*pad - 1. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int pairhmm_cost_launch(const int* cm, const int* opn,
                                   const int* ext, int* out, int B, int R,
                                   int W, int pad, int nuc_prior,
                                   void* stream) {
  if (B <= 0 || R <= 0 || W != R + 2 * pad - 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pad) {
    case 8:
      return (int)launch<16>(cm, opn, ext, out, B, R, nuc_prior, s);
    case 16:
      return (int)launch<32>(cm, opn, ext, out, B, R, nuc_prior, s);
    case 32:
      return (int)launch<64>(cm, opn, ext, out, B, R, nuc_prior, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
