// Experiment v10_kernel on Hopper, sm_90a: fewer instructions a cell, more
// bytes a pair.
//
// Replaces experiments/v10_kernel.py's TPU kernel (`scores_v10`,
// `_kernel_v10`, pl.pallas_call at :135). A prologue outside the kernel
// (kernel_experiments/v10_kernel.py, torch element-wise ops and a cumsum, as
// XLA ran it) precomputes five tracks, so the kernel reads ten: tgt, qual
// (R, B) and win, mask, prior, capN, opn_nuc_dn, ext_nuc_dn, ompre, pre
// (W, B), where
//   capN       = N_SCORE where win is N, else INF (the N cap in one min);
//   opn_nuc_dn = opn + nuc_prior one row down (row 0 INF), so the insertion
//                sum needs no nuc_prior add and reads the window one
//                diagonal up;
//   ext_nuc_dn = the same for ext;
//   pre        = cumsum(ext) over window rows, ompre = opn - pre, so the
//                deletion chain is a running minimum in primed space
//                (D'_d = min_{k<=d}(bv_k - pre_k) + pre_d).
// Its plain version is `v10_rows_plain` in kernel_experiments/v10_kernel.py,
// v10's own arithmetic in torch.
//
// On this card, a cell costs 12 int32 instructions in the fused DPX forms
// where #1's cost 14 (OPS_PER_CELL): the match cost 5 (two compares with a
// predicated update, a min with capN), M 2, I 2 (an add and VIADDMNMX), the
// deletion 3 (a min, VIADDMNMX on the running minimum, the + pre). A pair
// reads (2R + 8W) * 4 bytes instead of (2R + 5W) * 4, and stages 8 window
// rings instead of 5 (1,152 bytes of shared memory a pair instead of 768).
// Everything else is csrc/exp_rows.cuh's: K pairs a thread, chains
// interleaved, rows staged by cp.async, #pragma unroll 2. At K = 8 the block
// is 16 lanes (128 pairs, 144 KB), so that it fits in shared memory.
//
// Exactness: opn/ext < 2^22 and R < 2^20 keep every sum below 2^31; the
// INF-valued cells (the last diagonal's insertion) are INF exactly, as
// v10's shift_up fills them, and never reach a score.

#include "exp_rows.cuh"

using namespace exp_rows;

namespace {

// window tracks in ring order
enum V10Track { VWIN = 0, VMASK, VPRIOR, VCAPN, VOPN_DN, VEXT_DN, VOMPRE,
                VPRE, V10_WINDOW };

template <int K, int L>
struct V10Pairs {
  static constexpr int P = K * L;
  using Rings = RowRings<V10_WINDOW, P>;
  int M[K][D], I[K][D], Dl[K][D];

  // row 0: M = 0, I = INF; D0 = min_scan(bv0) + pre0 with
  // bv0 = shift_down(M0_gap, INF) + shift_down(ompre, 0) and
  // pre0 = shift_down(pre, 0)
  __device__ __forceinline__ void row0(const int* s, int lane) {
    const int* som = Rings::window(s, VOMPRE);
    const int* spr = Rings::window(s, VPRE);
#pragma unroll
    for (int g = 0; g < K; ++g) {
      const int col = g * L + lane;
      int run = INF;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int m_gap_prev = (d == 0) ? INF : (((d - 1) & 1) ? 0 : INF);
        const int om = (d == 0) ? 0 : som[(d - 1) * P + col];
        const int pre = (d == 0) ? 0 : spr[(d - 1) * P + col];
        run = min(run, m_gap_prev + om);
        Dl[g][d] = run + pre;
        M[g][d] = 0;
        I[g][d] = INF;
      }
    }
  }

  __device__ __forceinline__ void row(const int* s, int lane, int y) {
    const int* sw = Rings::window(s, VWIN) + lane;
    const int* sk = Rings::window(s, VMASK) + lane;
    const int* sp = Rings::window(s, VPRIOR) + lane;
    const int* sc = Rings::window(s, VCAPN) + lane;
    const int* sod = Rings::window(s, VOPN_DN) + lane;
    const int* sed = Rings::window(s, VEXT_DN) + lane;
    const int* som = Rings::window(s, VOMPRE) + lane;
    const int* spr = Rings::window(s, VPRE) + lane;
    const int rt = ((y - 1) & (Rings::RT - 1)) * P + lane;
    const bool row1 = (y == 1);
    int ty[K], q[K], mi_prev[K], run[K];
#pragma unroll
    for (int g = 0; g < K; ++g) {
      ty[g] = s[Rings::TGT + rt + g * L];
      q[g] = s[Rings::QUAL + rt + g * L];
      mi_prev[g] = INF;
      run[g] = INF;
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int j = ((y - 1 + k) & (Rings::RW - 1)) * P;
      const int j1 = ((y + k) & (Rings::RW - 1)) * P;  // one diagonal up
#pragma unroll
      for (int g = 0; g < K; ++g) {
        const int jg = j + g * L;
        const int w = sw[jg];
        const int capped = (sk[jg] == ty[g]) ? min(q[g], sp[jg]) : q[g];
        const int cm = min((ty[g] == w) ? 0 : capped, sc[jg]);
        int in = INF;
        if (k + 1 < D) {
          const int mg = row1 ? (((k + 1) & 1) ? 0 : INF) : M[g][up1(k)];
          in = addmin(I[g][up1(k)], sed[j1 + g * L], mg + sod[j1 + g * L]);
        }
        const int mn = cm + min3(M[g][k], I[g][k], Dl[g][k]);
        run[g] = addmin(mi_prev[g], som[jg], run[g]);
        Dl[g][k] = run[g] + spr[jg];
        M[g][k] = mn;
        I[g][k] = in;
        mi_prev[g] = min(mn, in);
      }
    }
  }

  __device__ __forceinline__ void store(int* out, int first, int lane) const {
#pragma unroll
    for (int g = 0; g < K; ++g) {
      int best = INF;
#pragma unroll
      for (int k = 0; k < D; ++k)
        best = min(best, min3(M[g][k], I[g][k], Dl[g][k]));
      out[first + g * L + lane] = best;
    }
  }
};

template <int K, int L>
__global__ void __launch_bounds__(L)
v10_kernel(const int* __restrict__ tgt, const int* __restrict__ qual,
           const int* __restrict__ win, const int* __restrict__ mask,
           const int* __restrict__ prior, const int* __restrict__ capn,
           const int* __restrict__ opn_dn, const int* __restrict__ ext_dn,
           const int* __restrict__ ompre, const int* __restrict__ pre,
           int* __restrict__ out, int B, int R, int W) {
  using Pairs = V10Pairs<K, L>;
  using Rings = typename Pairs::Rings;
  constexpr int C = Rings::C;
  extern __shared__ __align__(16) int smem[];
  const int first = blockIdx.x * Pairs::P;
  const int lane = threadIdx.x;
  const int* win_g[V10_WINDOW] = {win, mask, prior, capn,
                                  opn_dn, ext_dn, ompre, pre};
  Rings::stage(smem, 0, win_g, tgt, qual, R, W, B, first);
  Rings::stage(smem, 1, win_g, tgt, qual, R, W, B, first);

  Pairs st;
  const int nchunks = (R + C - 1) / C;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<1>();
    __syncthreads();  // every lane's copies of chunk c have landed
    if (c == 0) st.row0(smem, lane);
    const int y_end = min((c + 1) * C, R);
#pragma unroll 2
    for (int y = c * C + 1; y <= y_end; ++y) st.row(smem, lane, y);
    __syncthreads();  // every lane is done with chunk c before c+2 lands
    Rings::stage(smem, c + 2, win_g, tgt, qual, R, W, B, first);
  }
  cp_async_wait<0>();
  st.store(out, first, lane);
}

template <int K, int L>
cudaError_t launch(const int* const* t, int* out, int B, int R, int W,
                   cudaStream_t stream) {
  constexpr int P = K * L;
  constexpr size_t smem = V10Pairs<K, L>::Rings::BYTES;
  if (B % P) return cudaErrorInvalidValue;
  static SmemOptIn opt_in;
  const cudaError_t opted = opt_in(v10_kernel<K, L>, smem);
  if (opted != cudaSuccess) return opted;
  v10_kernel<K, L><<<B / P, L, smem, stream>>>(
      t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8], t[9], out, B, R, W);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes: the ten kernel-layout int32 device
// pointers in the order tgt, qual (R, B), win, mask, prior, capN,
// opn_nuc_dn, ext_nuc_dn, ompre, pre (W, B), W = R + 15; B % (32 K) == 0
// (the wrapper asks for B % (128 K)); pad 8; K in 1, 2, 4, 8 (nuc_prior is
// folded into the tracks). Returns the cudaError_t of the launch.
extern "C" int exp_v10_launch(const int* tgt, const int* qual, const int* win,
                              const int* mask, const int* prior,
                              const int* capn, const int* opn_dn,
                              const int* ext_dn, const int* ompre,
                              const int* pre, int* out, int B, int R, int W,
                              int pad, int K, void* stream) {
  if (!shape_ok(B, R, W, pad)) return (int)cudaErrorInvalidValue;
  const int* t[10] = {tgt, qual, win, mask, prior, capn,
                      opn_dn, ext_dn, ompre, pre};
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1:
      return (int)launch<1, 32>(t, out, B, R, W, s);
    case 2:
      return (int)launch<2, 32>(t, out, B, R, W, s);
    case 4:
      return (int)launch<4, 32>(t, out, B, R, W, s);
    case 8:
      return (int)launch<8, 16>(t, out, B, R, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
