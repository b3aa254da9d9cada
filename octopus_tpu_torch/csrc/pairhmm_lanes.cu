// Banded pair-HMM (integer-phred Viterbi), v8's formulation with the band on
// a warp's lanes, for Hopper, sm_90a.
//
// Replaces the reference package's TPU kernel #3,
// octopus_tpu/core/likelihood/pairhmm_batch.py:
//   pairhmm_scores_pallas_v8 / _pallas_kernel_v8 (row loop unrolled)
// Its plain twin is pairhmm_scores_lanes_plain in
// octopus_tpu_torch/core/likelihood/pairhmm_batch.py, which ports
// _pallas_kernel_v8's own arithmetic (pre = cumsum(ext), _min_scan); the two
// agree bit for bit.
//
// Semantics are those of csrc/pairhmm.cu (the same function); what differs is
// how a row is computed. v8 computes one row as a vector over the band of
// D = 2*pad diagonals:
//   Mn = cm + min(M, I, D)
//   In = nuc_prior + min(up(Mg) + opn, up(I) + ext)        (up: d <- d+1)
//   bv = down(min(Mn, In)) + opn                            (down: d <- d-1)
//   Dn = min_scan(bv - pre) + pre,  pre[j] = ext[0] + ... + ext[j]
// where the running minimum over bv - pre is the deletion chain
// D_d = min(bv_d, D_{d-1} + ext_d) unrolled: D_d = min_{k<=d} bv_k + sum of
// ext over (k, d]. Mg is the parity-masked M0 on row 1 and M afterwards.
//
// Design: the band lives on a warp's lanes. A pair owns LW = min(D, 32)
// consecutive lanes, and each lane holds K = D / LW diagonals, diagonal
// d = k*LW + lane: two pairs a warp at D = 16, one at D = 32, two diagonals a
// lane at D = 64. The up and down shifts are __shfl_{down,up}_sync of width
// LW (plus one broadcast across the K slots), and the running minimum is a
// log2(LW)-step shuffle scan (plus a carry across the K slots). Tracks are
// batch-major, (B, R) and (B, W), so the LW lanes of a pair read LW
// contiguous elements of its window row each row (one coalesced load per
// track) and the wrapper needs no transposes. pre is computed in the kernel,
// not taken as a cumsum track: each lane starts from an exclusive prefix sum
// of ext[0..D-1] (a shuffle scan) and adds the ext value it loads each row,
// since its window index advances by one a row.
//
// What bounds it: operations, as for csrc/pairhmm.cu (19 int32 ops per band
// cell are what the function needs). This design issues more per cell (the
// shuffles and the log2(LW) scan steps), but a pair's chain of dependent
// work per row is log2(LW) shuffle steps instead of a D-step serial chain in
// one thread, and each lane keeps K diagonals of state (3K + a few
// registers) instead of 8D, so no band spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = 1 << 29;
constexpr int N_CODE = 4;
constexpr int N_SCORE = 2;
constexpr int BLOCK = 128;
constexpr unsigned FULL = 0xffffffffu;

// out[d] = x[d-1]; out[0] = fill
template <int LW, int K>
__device__ __forceinline__ void shift_down(const int (&x)[K], int (&out)[K],
                                           int fill, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int up = __shfl_up_sync(FULL, x[k], 1, LW);
    const int prev = __shfl_sync(FULL, x[k > 0 ? k - 1 : 0], LW - 1, LW);
    const int carry = (k > 0) ? prev : fill;
    out[k] = (lane == 0) ? carry : up;
  }
}

// out[d] = x[d+1]; out[D-1] = fill
template <int LW, int K>
__device__ __forceinline__ void shift_up(const int (&x)[K], int (&out)[K],
                                         int fill, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int down = __shfl_down_sync(FULL, x[k], 1, LW);
    const int next = __shfl_sync(FULL, x[k + 1 < K ? k + 1 : k], 0, LW);
    const int carry = (k + 1 < K) ? next : fill;
    out[k] = (lane == LW - 1) ? carry : down;
  }
}

// inclusive running minimum along d
template <int LW, int K>
__device__ __forceinline__ void min_scan(int (&u)[K], int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int s = 1; s < LW; s <<= 1) {
      const int t = __shfl_up_sync(FULL, u[k], s, LW);
      if (lane >= s) u[k] = min(u[k], t);
    }
  }
#pragma unroll
  for (int k = 1; k < K; ++k)
    u[k] = min(u[k], __shfl_sync(FULL, u[k - 1], LW - 1, LW));
}

// inclusive prefix sum along d
template <int LW, int K>
__device__ __forceinline__ void sum_scan(int (&u)[K], int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int s = 1; s < LW; s <<= 1) {
      const int t = __shfl_up_sync(FULL, u[k], s, LW);
      if (lane >= s) u[k] += t;
    }
  }
#pragma unroll
  for (int k = 1; k < K; ++k)
    u[k] += __shfl_sync(FULL, u[k - 1], LW - 1, LW);
}

template <int D>
__global__ void __launch_bounds__(BLOCK)
pairhmm_lanes_kernel(const int* __restrict__ tgt, const int* __restrict__ qual,
                     const int* __restrict__ win, const int* __restrict__ opn,
                     const int* __restrict__ ext, const int* __restrict__ mask,
                     const int* __restrict__ prior, int* __restrict__ out,
                     int B, int R, int W, int nuc_prior) {
  constexpr int LW = D < 32 ? D : 32;  // lanes a pair
  constexpr int K = D / LW;            // diagonals a lane
  constexpr int PAIRS_PER_WARP = 32 / LW;
  const int lane = threadIdx.x & (LW - 1);
  const int warp = (blockIdx.x * BLOCK + threadIdx.x) >> 5;
  const int first_pair = warp * PAIRS_PER_WARP;
  if (first_pair >= B) return;  // the whole warp lies past the batch edge
  const int pair = first_pair + (threadIdx.x & 31) / LW;
  // ragged edge: a segment past B recomputes pair B-1 (every lane of the
  // warp must take part in the shuffles) and stores nothing
  const bool valid = pair < B;
  const size_t b = valid ? pair : B - 1;
  const int* trow = tgt + b * R;
  const int* qrow = qual + b * R;
  const int* wrow = win + b * W;
  const int* orow = opn + b * W;
  const int* erow = ext + b * W;
  const int* mrow = mask + b * W;
  const int* prow = prior + b * W;

  int M[K], I[K], Dl[K], pre[K], mg0[K];
  // row 0: M = 0, I = INF; pre = exclusive prefix sum of ext[0..D-1];
  // D0 = min_scan(down(Mg0) + down(opn) - pre) + pre, with Mg0 = 0 at odd d
  // and INF at even d (gaps out of row 0 start only at odd offsets)
  {
    int e0[K], o0[K], s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = k * LW + lane;
      e0[k] = __ldg(erow + d);
      o0[k] = __ldg(orow + d);
      s[k] = e0[k];
      mg0[k] = (d & 1) ? 0 : INF;
      M[k] = 0;
      I[k] = INF;
    }
    sum_scan<LW, K>(s, lane);
    int mg_dn[K], o_dn[K];
    shift_down<LW, K>(mg0, mg_dn, INF, lane);
    shift_down<LW, K>(o0, o_dn, INF, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      pre[k] = s[k] - e0[k];
      Dl[k] = mg_dn[k] + o_dn[k] - pre[k];
    }
    min_scan<LW, K>(Dl, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) Dl[k] += pre[k];
  }

#pragma unroll 2
  for (int y = 1; y <= R; ++y) {
    const int t = __ldg(trow + y - 1);
    const int q = __ldg(qrow + y - 1);
    int cm[K], o[K], e[K], mg[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = y - 1 + k * LW + lane;  // window index of diagonal d
      const int w = __ldg(wrow + j);
      int c = (__ldg(mrow + j) == t) ? min(q, __ldg(prow + j)) : q;
      c = (t == w) ? 0 : c;
      cm[k] = (w == N_CODE) ? min(c, N_SCORE) : c;
      o[k] = __ldg(orow + j);
      e[k] = __ldg(erow + j);
      pre[k] += e[k];  // pre[j] = pre[j-1] + ext[j]
      mg[k] = (y == 1) ? mg0[k] : M[k];
    }
    int mg_up[K], i_up[K], mi[K], mi_dn[K];
    shift_up<LW, K>(mg, mg_up, INF, lane);
    shift_up<LW, K>(I, i_up, INF, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int mn = cm[k] + min(min(M[k], I[k]), Dl[k]);
      const int in = nuc_prior + min(mg_up[k] + o[k], i_up[k] + e[k]);
      M[k] = mn;
      I[k] = in;
      mi[k] = min(mn, in);
    }
    shift_down<LW, K>(mi, mi_dn, INF, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) Dl[k] = mi_dn[k] + o[k] - pre[k];
    min_scan<LW, K>(Dl, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) Dl[k] += pre[k];
  }

  // the score: min over the band of min(M, I, D) after row R
  int best = INF;
#pragma unroll
  for (int k = 0; k < K; ++k) best = min(best, min(min(M[k], I[k]), Dl[k]));
#pragma unroll
  for (int s = LW / 2; s > 0; s >>= 1)
    best = min(best, __shfl_xor_sync(FULL, best, s, LW));
  if (valid && lane == 0) out[b] = best;
}

template <int D>
cudaError_t launch(const int* tgt, const int* qual, const int* win,
                   const int* opn, const int* ext, const int* mask,
                   const int* prior, int* out, int B, int R, int W,
                   int nuc_prior, cudaStream_t stream) {
  constexpr int LW = D < 32 ? D : 32;
  constexpr int PAIRS_PER_BLOCK = (BLOCK / 32) * (32 / LW);
  const int grid = (B + PAIRS_PER_BLOCK - 1) / PAIRS_PER_BLOCK;
  pairhmm_lanes_kernel<D><<<grid, BLOCK, 0, stream>>>(
      tgt, qual, win, opn, ext, mask, prior, out, B, R, W, nuc_prior);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Tracks are int32 device pointers in
// batch-major layout: tgt/qual (B, R), the window tracks (B, W) with
// W = R + 2*pad - 1. Returns the cudaError_t of the launch (0 = success).
extern "C" int pairhmm_lanes_launch(const int* tgt, const int* qual,
                                    const int* win, const int* opn,
                                    const int* ext, const int* mask,
                                    const int* prior, int* out, int B, int R,
                                    int W, int pad, int nuc_prior,
                                    void* stream) {
  if (B <= 0 || R <= 0 || W != R + 2 * pad - 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pad) {
    case 8:
      return (int)launch<16>(tgt, qual, win, opn, ext, mask, prior, out, B, R,
                             W, nuc_prior, s);
    case 16:
      return (int)launch<32>(tgt, qual, win, opn, ext, mask, prior, out, B, R,
                             W, nuc_prior, s);
    case 32:
      return (int)launch<64>(tgt, qual, win, opn, ext, mask, prior, out, B, R,
                             W, nuc_prior, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
