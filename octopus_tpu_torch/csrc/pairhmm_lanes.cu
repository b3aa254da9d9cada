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
// What bounds it on the H100: as for csrc/pairhmm.cu, operations at the
// bench shape (at least 14 fused int32 instructions a band cell are what
// the function needs) and, at the main path's 1-519 pairs, the latency of a
// pair's 160 dependent rows: a row is three shifts of two shuffles and a
// log2(LW)-step shuffle scan, and were its tracks read from device memory,
// each row would also start on seven loads a lane (tgt, qual and five
// window words) that its chain waits on.
//
// Design: the band lives on a warp's lanes. A pair owns LW consecutive lanes
// (template: min(D, 32) or half of it), and each lane holds K = D / LW
// diagonals, diagonal d = k*LW + lane. The up and down shifts are
// __shfl_{down,up}_sync of width LW (plus one broadcast across the K slots),
// and the running minimum is a log2(LW)-step shuffle scan, one shuffle and
// one minimum a step (plus a carry across the K slots): a smaller LW trades
// shuffle steps on the row's critical path for K diagonals a lane. A block
// is one warp and scores 32/LW pairs; it stages their batch-major rows into
// shared-memory rings by cp.async, two chunks in flight ahead of the row
// loop (csrc/pairhmm_stage.cuh), so no row waits on device memory. At one
// diagonal a lane (the latency variant, below 8192 pairs) chunks are 32
// rows, so few chunk turns sit on the chain of rows; at half the lanes (the
// throughput variant) chunks are D/2 rows and the rings small, so more
// pairs fit on an SM. The window rings have a pitch of the ring plus LW
// words, so the pairs of a warp read distinct banks. pre is computed in the
// kernel, not taken as a cumsum track: each lane starts from an exclusive
// prefix sum of ext[0..D-1] (a shuffle scan) and adds the staged ext value
// of its window index each row, since that index advances by one a row.
// DPX: M's minimum of three and I's minimum of two sums as __vimin3_s32 and
// __viaddmin_s32; timed against the plain int32 form, the two tied, so only
// the DPX form is built. The wrapper needs no transposes.

#include "pairhmm_stage.cuh"

namespace {

using namespace pairhmm;

template <int D, int LW>
struct Geometry {
  static_assert(LW <= 32 && D % LW == 0, "a pair's lanes lie in one warp");
  static constexpr int K = D / LW;   // diagonals a lane
  static constexpr int P = 32 / LW;  // pairs a block (one warp)
  // one diagonal a lane (LW = min(D, 32)) serves launches of a few hundred
  // pairs: 32-row chunks; half the lanes serves batches that fill the card:
  // chunks of D/2 rows and small rings, so that more pairs fit on an SM.
  // The window pitch is the ring plus LW words, so the pairs of a warp read
  // distinct banks.
  static constexpr bool LATENCY = (LW == (D < 32 ? D : 32));
  static constexpr int C = LATENCY ? 32 : D / 2;
  static constexpr int RW = LATENCY ? 128 : 2 * D;
  static constexpr int RT = LATENCY ? 64 : D;
  using Rings = Ring<D, P, C, RW, RT, RW + LW, RT + 1>;
};

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

// inclusive running minimum along d. Below offset s a shuffle up returns
// the lane's own value and min(u, u) = u, so no lane test: each step is one
// shuffle and one minimum on the row's critical path.
template <int LW, int K>
__device__ __forceinline__ void min_scan(int (&u)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int s = 1; s < LW; s <<= 1)
      u[k] = min(u[k], __shfl_up_sync(FULL, u[k], s, LW));
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

template <int D, int LW>
__global__ void __launch_bounds__(32)
pairhmm_lanes_kernel(const int* __restrict__ tgt, const int* __restrict__ qual,
                     const int* __restrict__ win, const int* __restrict__ opn,
                     const int* __restrict__ ext, const int* __restrict__ mask,
                     const int* __restrict__ prior, int* __restrict__ out,
                     int B, int R, int W, int nuc_prior) {
  using G = Geometry<D, LW>;
  using Rings = typename G::Rings;
  constexpr int K = G::K;
  constexpr int P = G::P;
  constexpr int C = Rings::C;
  extern __shared__ int smem[];

  const int first = blockIdx.x * P;
  const int nvalid = min(P, B - first);
  const int lane = threadIdx.x & (LW - 1);
  const int p_own = threadIdx.x / LW;
  // ragged edge: a segment past B recomputes the block's last pair (every
  // lane of the warp must take part in the shuffles) and stores nothing
  const int p = min(p_own, nvalid - 1);

  const int* win_g[N_WINDOW] = {win, mask, prior, opn, ext};
  Rings::stage(smem, 0, tgt, qual, win_g, R, W, first, nvalid);
  Rings::stage(smem, 1, tgt, qual, win_g, R, W, first, nvalid);
  const int* sw = Rings::window(smem, WIN, p);
  const int* sm = Rings::window(smem, MASK, p);
  const int* sp = Rings::window(smem, PRIOR, p);
  const int* so = Rings::window(smem, OPN, p);
  const int* se = Rings::window(smem, EXT, p);
  const int* st = Rings::tgt(smem, p);
  const int* sq = Rings::qual(smem, p);

  int M[K], I[K], Dl[K], pre[K], mg0[K];
  const int nchunks = (R + C - 1) / C;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<1>();
    __syncwarp();
    if (c == 0) {
      // row 0: M = 0, I = INF; pre = exclusive prefix sum of ext[0..D-1];
      // D0 = min_scan(down(Mg0) + down(opn) - pre) + pre, with Mg0 = 0 at
      // odd d and INF at even d (gaps out of row 0 start only at odd offsets)
      int e0[K], o0[K], s[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = k * LW + lane;
        e0[k] = se[d];
        o0[k] = so[d];
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
      min_scan<LW, K>(Dl);
#pragma unroll
      for (int k = 0; k < K; ++k) Dl[k] += pre[k];
    }
    const int y_end = min((c + 1) * C, R);
#pragma unroll 2
    for (int y = c * C + 1; y <= y_end; ++y) {
      const int t = st[(y - 1) & (Rings::RT - 1)];
      const int q = sq[(y - 1) & (Rings::RT - 1)];
      int cm[K], o[K], e[K], mg[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // window index of diagonal d, in its ring
        const int j = (y - 1 + k * LW + lane) & (Rings::RW - 1);
        const int w = sw[j];
        int cost = (sm[j] == t) ? min(q, sp[j]) : q;
        cost = (t == w) ? 0 : cost;
        cm[k] = (w == N_CODE) ? min(cost, N_SCORE) : cost;
        o[k] = so[j];
        e[k] = se[j];
        pre[k] += e[k];  // pre[j] = pre[j-1] + ext[j]
        mg[k] = (y == 1) ? mg0[k] : M[k];
      }
      int mg_up[K], i_up[K], mi[K], mi_dn[K];
      shift_up<LW, K>(mg, mg_up, INF, lane);
      shift_up<LW, K>(I, i_up, INF, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int mn = cm[k] + min3(M[k], I[k], Dl[k]);
        const int in = nuc_prior + addmin(i_up[k], e[k], mg_up[k] + o[k]);
        M[k] = mn;
        I[k] = in;
        mi[k] = min(mn, in);
      }
      shift_down<LW, K>(mi, mi_dn, INF, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) Dl[k] = mi_dn[k] + o[k] - pre[k];
      min_scan<LW, K>(Dl);
#pragma unroll
      for (int k = 0; k < K; ++k) Dl[k] += pre[k];
    }
    __syncwarp();  // every lane is done with chunk c before c+2 lands on it
    Rings::stage(smem, c + 2, tgt, qual, win_g, R, W, first, nvalid);
  }
  cp_async_wait<0>();

  // the score: min over the band of min(M, I, D) after row R
  int best = INF;
#pragma unroll
  for (int k = 0; k < K; ++k) best = min(best, min3(M[k], I[k], Dl[k]));
#pragma unroll
  for (int s = LW / 2; s > 0; s >>= 1)
    best = min(best, __shfl_xor_sync(FULL, best, s, LW));
  if (p_own < nvalid && lane == 0) out[first + p_own] = best;
}

template <int D, int LW>
cudaError_t launch(const int* tgt, const int* qual, const int* win,
                   const int* opn, const int* ext, const int* mask,
                   const int* prior, int* out, int B, int R, int W,
                   int nuc_prior, cudaStream_t stream) {
  using G = Geometry<D, LW>;
  constexpr size_t smem = G::Rings::BYTES;
  static SmemOptIn opt_in;
  const cudaError_t opted = opt_in(pairhmm_lanes_kernel<D, LW>, smem);
  if (opted != cudaSuccess) return opted;
  const int grid = (B + G::P - 1) / G::P;
  pairhmm_lanes_kernel<D, LW><<<grid, 32, smem, stream>>>(
      tgt, qual, win, opn, ext, mask, prior, out, B, R, W, nuc_prior);
  return cudaGetLastError();
}

// the two lane widths of a band: LW0 = min(D, 32) lanes a pair, or half
template <int D>
cudaError_t launch_d(int lanes, const int* tgt, const int* qual,
                     const int* win, const int* opn, const int* ext,
                     const int* mask, const int* prior, int* out, int B, int R,
                     int W, int nuc_prior, cudaStream_t s) {
  constexpr int LW0 = D < 32 ? D : 32;
  if (lanes == LW0)
    return launch<D, LW0>(tgt, qual, win, opn, ext, mask, prior, out, B, R, W,
                          nuc_prior, s);
  if (lanes == LW0 / 2)
    return launch<D, LW0 / 2>(tgt, qual, win, opn, ext, mask, prior, out, B,
                              R, W, nuc_prior, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point for ctypes. Tracks are int32 device pointers in
// batch-major layout: tgt/qual (B, R), the window tracks (B, W) with
// W = R + 2*pad - 1, each row contiguous (any alignment). `lanes` is LW,
// lanes a pair: min(2*pad, 32) or half of it. Returns the cudaError_t of
// the launch (0 = success).
extern "C" int pairhmm_lanes_launch(const int* tgt, const int* qual,
                                    const int* win, const int* opn,
                                    const int* ext, const int* mask,
                                    const int* prior, int* out, int B, int R,
                                    int W, int pad, int nuc_prior, int lanes,
                                    void* stream) {
  if (B <= 0 || R <= 0 || W != R + 2 * pad - 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pad) {
    case 8:
      return (int)launch_d<16>(lanes, tgt, qual, win, opn, ext, mask,
                               prior, out, B, R, W, nuc_prior, s);
    case 16:
      return (int)launch_d<32>(lanes, tgt, qual, win, opn, ext, mask,
                               prior, out, B, R, W, nuc_prior, s);
    case 32:
      return (int)launch_d<64>(lanes, tgt, qual, win, opn, ext, mask,
                               prior, out, B, R, W, nuc_prior, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block (bytes) at this pad and LW, or -1.
extern "C" int pairhmm_lanes_smem_bytes(int pad, int lanes) {
  switch (pad * 100 + lanes) {
    case 816:
      return (int)Geometry<16, 16>::Rings::BYTES;
    case 808:
      return (int)Geometry<16, 8>::Rings::BYTES;
    case 1632:
      return (int)Geometry<32, 32>::Rings::BYTES;
    case 1616:
      return (int)Geometry<32, 16>::Rings::BYTES;
    case 3232:
      return (int)Geometry<64, 32>::Rings::BYTES;
    case 3216:
      return (int)Geometry<64, 16>::Rings::BYTES;
    default:
      return -1;
  }
}
