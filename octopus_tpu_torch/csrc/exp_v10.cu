// Experiment v10_kernel on Hopper, sm_90a: fewer instructions a cell.
//
// Replaces experiments/v10_kernel.py's TPU kernel (`scores_v10`,
// `_kernel_v10`, pl.pallas_call at :135), which computes v9's banded score
// in another arithmetic from five per-position values that an XLA prologue
// builds outside the kernel:
//   capN       = N_SCORE where win is N, else INF (the N cap in one min);
//   opn_nuc_dn = opn + nuc_prior one row down (row 0 INF), so the insertion
//                sum needs no nuc_prior add (diagonal k of row y reads
//                opn[y-1+k] + nuc_prior, its own position's);
//   ext_nuc_dn = the same for ext;
//   pre        = cumsum(ext) over window rows, ompre = opn - pre, so the
//                deletion chain is a running minimum in primed space
//                (D'_d = min_{k<=d}(bv_k - pre_k) + pre_d).
// Its plain version is `v10_rows_plain` in kernel_experiments/v10_kernel.py
// on those tracks (`v10_tracks`), and `v10_schedule_plain` this file's
// order of work on the seven raw tracks.
//
// A cell costs 12 int32 instructions in the fused DPX forms where #1's
// cost 14 (OPS_PER_CELL in pairhmm_batch.py): the match cost 5 (two
// compares, two selects, a VIMNMX3 with capN), M 2, I 2 (an add and
// VIADDMNMX), the deletion 3 (a min, VIADDMNMX on the running minimum, the
// + pre). So its function's least time at the bench shape is the 12-op
// bound, above the seven raw tracks' bytes.
//
// The Hopper designs read only the seven raw tracks (tgt, qual (R, B); win,
// opn, ext, mask, prior (W, B)), as #1 does, and derive the eight values a
// cell reads (win, mask, prior, capN, opn + nuc, ext + nuc, ompre, pre) in
// the kernel, once a window position, as the position enters the band:
// pre is a running sum carried in a register from position 0 on. One
// thread a pair, one warp a block.
// - `regs_p16`: csrc/exp_rows.cuh's RegWindows (csrc/exp_v11.cu's
//   register window) with the eight derived values of each of the 16 band
//   positions in registers (128 words, M, I and D 48 more). Row y's
//   diagonal 0 frees the slot of position y-1, which takes position y+15,
//   derived from its five raw values; the raw rows come by 16-byte
//   cp.async into NewRows' rings (448 bytes a pair). The row loop is
//   unrolled over 16 rows, so every slot index is a constant and the slide
//   a renaming. A row loads 7 words.
// - `rings`: the derived values in a shared-memory ring of 16 positions a
//   track (512 bytes a pair), each thread writing and reading only its own
//   pair's column, so no barrier guards it; the raw rows land in NewRows'
//   rings of two chunks of 4 rows (224 bytes). 736 bytes a pair, under the
//   768 of dual_chain's rings; a cell loads its 8 values (32 bytes).
//
// The first port stays as `tracks10` (K = 1, 2, 4, 8 pairs a thread):
// the prologue in torch writes the five derived tracks to device memory and
// the kernel reads ten, (2R + 8W) * 4 bytes a pair against the raw tracks'
// (2R + 5W) * 4, staged in csrc/exp_rows.cuh's rings of 8 tracks (1,152
// bytes a pair: one warp an SM at K = 4).
//
// Exactness: the sums of the function are int32 as in v10 and v9: opn and
// ext below 2^22 and R below 2^20 keep the band's sums below 2^31, and pre
// = cumsum(ext) stays below 2^31 while W * max(ext) < 2^31 (at ext near
// 2^22, W < 512). Beyond that pre wraps, in the kernel (unsigned sums) as in
// torch's and XLA's int32 cumsum, and v10's scores may leave v9's; the
// checks stay inside the range. The INF-valued cells (the
// last diagonal's insertion) are INF exactly, as v10's shift_up fills them,
// and never reach a score.

#include "exp_rows.cuh"

using namespace exp_rows;

namespace {

// --------------------------------------------------------------------------
// The first port: the prologue's ten tracks
// --------------------------------------------------------------------------

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
cudaError_t launch_tracks10(const int* const* t, int* out, int B, int R,
                            int W, cudaStream_t stream) {
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

template <int K, int L>
cudaError_t occupancy_tracks10(int* out) {
  constexpr size_t smem = V10Pairs<K, L>::Rings::BYTES;
  static SmemOptIn opt_in;
  cudaError_t err = opt_in(v10_kernel<K, L>, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0],
                                                        v10_kernel<K, L>, L,
                                                        smem);
  out[1] = L;
  out[2] = (int)smem;
  out[3] = K * L;
  return err;
}

// --------------------------------------------------------------------------
// The Hopper designs: v10's values derived in the kernel
// --------------------------------------------------------------------------

// v10's values of one window position, derived from its raw ones; acc
// carries pre = cumsum(ext) through the position before (unsigned, so that
// it wraps as the int32 cumsum of torch and XLA does, with no signed
// overflow)
struct Position {
  int w, m, p, cn, on, en, om, pe;
};

__device__ __forceinline__ Position derive(int w, int m, int p, int o, int e,
                                           int nuc_prior, unsigned& acc) {
  acc += (unsigned)e;
  return {w,
          m,
          p,
          w == N_CODE ? N_SCORE : INF,
          (int)((unsigned)o + (unsigned)nuc_prior),
          (int)((unsigned)e + (unsigned)nuc_prior),
          (int)((unsigned)o - acc),
          (int)acc};
}

// v10's step on one cell: read base t and quality q, the values v of the
// cell's position, m_up and i_up the M and I of the diagonal above (LAST:
// none, I = INF); M, I and Dl the cell's, updated in place; mi_prev and run
// carry the primed deletion chain down the row's diagonals. 12 int32
// instructions. The match cost, v10's min(t == w ? 0 : (m == t ? min(q, p)
// : q), capN), in 5: capN is N_SCORE or INF, never below 0, so a matching
// base costs 0 whatever the cap, and the rest is one VIMNMX3.
template <bool LAST>
__device__ __forceinline__ void v10_cell(int t, int q, const Position& v,
                                         int m_up, int i_up, int& M, int& I,
                                         int& Dl, int& mi_prev, int& run) {
  const int cm = (t == v.w) ? 0 : min3(q, (v.m == t) ? v.p : q, v.cn);
  const int in = LAST ? INF : addmin(i_up, v.en, m_up + v.on);
  const int mn = cm + min3(M, I, Dl);
  run = addmin(mi_prev, v.om, run);
  Dl = run + v.pe;
  M = mn;
  I = in;
  mi_prev = min(mn, in);
}

// row 0: M = 0, I = INF; D0 = min_scan(bv0) + pre0 with bv0 =
// shift_down(M0_gap, INF) + shift_down(ompre, 0), pre0 = shift_down(pre,
// 0); om(d), pe(d) the values of window position d
template <class Om, class Pe>
__device__ __forceinline__ void v10_row0(int (&M)[D], int (&I)[D],
                                         int (&Dl)[D], Om om, Pe pe) {
  int run = INF;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int m_gap_prev = (d == 0) ? INF : (((d - 1) & 1) ? 0 : INF);
    const int o = (d == 0) ? 0 : om(d > 0 ? d - 1 : 0);
    const int p = (d == 0) ? 0 : pe(d > 0 ? d - 1 : 0);
    run = min(run, m_gap_prev + o);
    Dl[d] = run + p;
    M[d] = 0;
    I[d] = INF;
  }
}

__device__ __forceinline__ int band_min(const int (&M)[D], const int (&I)[D],
                                        const int (&Dl)[D]) {
  int out = INF;
#pragma unroll
  for (int k = 0; k < D; ++k) out = min(out, min3(M[k], I[k], Dl[k]));
  return out;
}

// `regs`: a slot of the register window (exp_rows.cuh's RegWindows) holds
// v10's eight values of a position (Position's order), derived as the
// position enters; the carry is pre's running sum.
struct V10Slots {
  static constexpr int NV = 8;
  using Carry = unsigned;

  __device__ __forceinline__ static void enter(int w, int m, int p, int o,
                                               int e, int nuc_prior,
                                               unsigned& acc, int (&x)[NV]) {
    const Position v = derive(w, m, p, o, e, nuc_prior, acc);
    x[0] = v.w;
    x[1] = v.m;
    x[2] = v.p;
    x[3] = v.cn;
    x[4] = v.on;
    x[5] = v.en;
    x[6] = v.om;
    x[7] = v.pe;
  }

  __device__ __forceinline__ static void row0(const int (&v)[NV][D],
                                              int (&M)[D], int (&I)[D],
                                              int (&Dl)[D]) {
    v10_row0(M, I, Dl, [&](int j) { return v[6][j]; },
             [&](int j) { return v[7][j]; });
  }

  template <bool LAST>
  __device__ __forceinline__ static void cell(int t, int q,
                                              const int (&v)[NV][D], int sl,
                                              int m_up, int i_up, int,
                                              int& M, int& I, int& Dl,
                                              int& mi_prev, int& run) {
    v10_cell<LAST>(t, q,
                   {v[0][sl], v[1][sl], v[2][sl], v[3][sl], v[4][sl],
                    v[5][sl], v[6][sl], v[7][sl]},
                   m_up, i_up, M, I, Dl, mi_prev, run);
  }
};

template <int L, int P>
__global__ void __launch_bounds__(L)
v10_regs_kernel(const int* __restrict__ tgt, const int* __restrict__ qual,
                const int* __restrict__ win, const int* __restrict__ opn,
                const int* __restrict__ ext, const int* __restrict__ mask,
                const int* __restrict__ prior, int* __restrict__ out, int B,
                int R, int W, int nuc_prior) {
  extern __shared__ __align__(16) int smem[];
  const int first = blockIdx.x * L;
  const Tracks g{tgt, qual, {win, mask, prior, opn, ext}, B, R, W,
                 first + (int)threadIdx.x, nuc_prior};
  regs_pairs<L, P, V10Slots>(g, smem, first, out);
}

// `rings`: the derived values of the band's 16 positions in a shared-memory
// ring a track, this thread's column only; raw rows in NewRows<L, C>.
template <int L, int C>
struct V10Ring {
  using Rows = NewRows<L, C>;
  enum { DW = 0, DM, DP, DCN, DON, DEN, DOM, DPE, N_DERIVED };
  static constexpr int DER = Rows::WORDS;  // first word of the derived ring
  static constexpr size_t BYTES =
      (size_t)(DER + N_DERIVED * D * L) * sizeof(int);
  int M[D], I[D], Dl[D];
  unsigned acc;

  // word of derived track `k`, window position `pos`, this thread's column
  __device__ __forceinline__ static int word(int k, int pos) {
    return DER + (k * D + (pos & (D - 1))) * L + (int)threadIdx.x;
  }

  __device__ __forceinline__ static Position at(const int* s, int pos) {
    return {s[word(DW, pos)],  s[word(DM, pos)],  s[word(DP, pos)],
            s[word(DCN, pos)], s[word(DON, pos)], s[word(DEN, pos)],
            s[word(DOM, pos)], s[word(DPE, pos)]};
  }

  __device__ __forceinline__ static void put(int* s, int pos,
                                             const Position& v) {
    s[word(DW, pos)] = v.w;
    s[word(DM, pos)] = v.m;
    s[word(DP, pos)] = v.p;
    s[word(DCN, pos)] = v.cn;
    s[word(DON, pos)] = v.on;
    s[word(DEN, pos)] = v.en;
    s[word(DOM, pos)] = v.om;
    s[word(DPE, pos)] = v.pe;
  }

  // positions 0..15 into the ring, then row 0
  __device__ __forceinline__ void init(const Tracks& g, int* s) {
    acc = 0;
#pragma unroll
    for (int j = 0; j < D; ++j)
      put(s, j, derive(g.at(g.win[WIN], j), g.at(g.win[MASK], j),
                       g.at(g.win[PRIOR], j), g.at(g.win[OPN], j),
                       g.at(g.win[EXT], j), g.nuc_prior, acc));
    v10_row0(M, I, Dl, [&](int j) { return s[word(DOM, j)]; },
             [&](int j) { return s[word(DPE, j)]; });
  }

  template <bool ROW1>
  __device__ __forceinline__ void row(int* s, int y, int nuc_prior) {
    const int lane = threadIdx.x;
    const int t = s[Rows::at(Rows::TGT, y - 1, lane)];
    const int q = s[Rows::at(Rows::QUAL, y - 1, lane)];
    int mi_prev = INF, run = INF;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const Position v = at(s, y - 1 + k);
      if (k + 1 < D) {
        const int m_up = ROW1 ? (((k + 1) & 1) ? 0 : INF) : M[up1(k)];
        v10_cell<false>(t, q, v, m_up, I[up1(k)], M[k], I[k], Dl[k], mi_prev,
                        run);
      } else {
        v10_cell<true>(t, q, v, INF, INF, M[k], I[k], Dl[k], mi_prev, run);
      }
      if (k == 0) {
        // position y-1 is done: position y+15 into its ring row
        const int r = y + D - 1;
        put(s, r,
            derive(s[Rows::at(WIN, r, lane)], s[Rows::at(MASK, r, lane)],
                   s[Rows::at(PRIOR, r, lane)], s[Rows::at(OPN, r, lane)],
                   s[Rows::at(EXT, r, lane)], nuc_prior, acc));
      }
    }
  }
};

template <int L, int C>
__global__ void __launch_bounds__(L)
v10_rings_kernel(const int* __restrict__ tgt, const int* __restrict__ qual,
                 const int* __restrict__ win, const int* __restrict__ opn,
                 const int* __restrict__ ext, const int* __restrict__ mask,
                 const int* __restrict__ prior, int* __restrict__ out, int B,
                 int R, int W, int nuc_prior) {
  using Ring = V10Ring<L, C>;
  extern __shared__ __align__(16) int smem[];
  const int first = blockIdx.x * L;
  const Tracks g{tgt, qual, {win, mask, prior, opn, ext}, B, R, W,
                 first + (int)threadIdx.x, nuc_prior};
  Ring::Rows::stage(smem, 0, g.win, tgt, qual, R, W, B, first);
  Ring st;
  st.init(g, smem);
  const int nchunks = (R + C - 1) / C;
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // every lane is done with chunk c-1: c+1 takes its rows
    Ring::Rows::stage(smem, c + 1, g.win, tgt, qual, R, W, B, first);
    cp_async_wait<1>();
    __syncthreads();  // every lane's copies of chunk c have landed
    const int y_end = min((c + 1) * C, R);
    int y = c * C + 1;
    if (c == 0) st.template row<true>(smem, y++, nuc_prior);
#pragma unroll 2
    for (; y <= y_end; ++y) st.template row<false>(smem, y, nuc_prior);
  }
  cp_async_wait<0>();
  out[g.b] = band_min(st.M, st.I, st.Dl);
}

constexpr int L_BLOCK = 32;  // the Hopper designs: one warp a block
constexpr int RING_C = 4;    // rows a chunk of `rings`

template <int P>
cudaError_t launch_regs(const int* const* t, int* out, int B, int R, int W,
                        int nuc_prior, cudaStream_t stream) {
  constexpr size_t smem = NewRows<L_BLOCK>::BYTES;
  static_assert(smem <= 48 * 1024, "no opt-in");
  if (B % L_BLOCK) return cudaErrorInvalidValue;
  v10_regs_kernel<L_BLOCK, P><<<B / L_BLOCK, L_BLOCK, smem, stream>>>(
      t[0], t[1], t[2], t[3], t[4], t[5], t[6], out, B, R, W, nuc_prior);
  return cudaGetLastError();
}

cudaError_t launch_rings(const int* const* t, int* out, int B, int R, int W,
                         int nuc_prior, cudaStream_t stream) {
  constexpr size_t smem = V10Ring<L_BLOCK, RING_C>::BYTES;
  static_assert(smem <= 48 * 1024, "no opt-in");
  if (B % L_BLOCK) return cudaErrorInvalidValue;
  v10_rings_kernel<L_BLOCK, RING_C><<<B / L_BLOCK, L_BLOCK, smem, stream>>>(
      t[0], t[1], t[2], t[3], t[4], t[5], t[6], out, B, R, W, nuc_prior);
  return cudaGetLastError();
}

// out = {blocks an SM, threads a block, shared memory a block, pairs a
// block} of a one-warp kernel with `smem` bytes of shared memory
template <class Kernel>
cudaError_t occupancy_warp(Kernel kernel, size_t smem, int* out) {
  out[1] = L_BLOCK;
  out[2] = (int)smem;
  out[3] = L_BLOCK;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                       L_BLOCK, smem);
}

// variant argument of the entry points
enum Variant { REGS_P16 = 0, RINGS = 1, TRACKS10_K1 = 2, TRACKS10_K2 = 3,
               TRACKS10_K4 = 4, TRACKS10_K8 = 5 };

}  // namespace

// Plain C entry point for ctypes: ten kernel-layout int32 device pointers,
// whose meaning the variant (enum Variant) sets:
// - REGS_P16, RINGS (the Hopper designs): the
//   seven raw tracks tgt, qual (R, B), win, opn, ext, mask, prior (W, B),
//   then three null pointers; B % 32 == 0;
// - TRACKS10_K1/K2/K4/K8 (the first port): the prologue's ten tracks tgt,
//   qual (R, B), win, mask, prior, capN, opn_nuc_dn, ext_nuc_dn, ompre, pre
//   (W, B), nuc_prior folded into them (the argument unused); B % (32 K)
//   == 0.
// W = R + 15; pad 8 (the wrapper asks for B % 128, or 128 K). Returns the
// cudaError_t of the launch.
extern "C" int exp_v10_launch(const int* t0, const int* t1, const int* t2,
                              const int* t3, const int* t4, const int* t5,
                              const int* t6, const int* t7, const int* t8,
                              const int* t9, int* out, int B, int R, int W,
                              int pad, int nuc_prior, int variant,
                              void* stream) {
  if (!shape_ok(B, R, W, pad)) return (int)cudaErrorInvalidValue;
  const int* t[10] = {t0, t1, t2, t3, t4, t5, t6, t7, t8, t9};
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case REGS_P16:
      return (int)launch_regs<16>(t, out, B, R, W, nuc_prior, s);
    case RINGS:
      return (int)launch_rings(t, out, B, R, W, nuc_prior, s);
    case TRACKS10_K1:
      return (int)launch_tracks10<1, 32>(t, out, B, R, W, s);
    case TRACKS10_K2:
      return (int)launch_tracks10<2, 32>(t, out, B, R, W, s);
    case TRACKS10_K4:
      return (int)launch_tracks10<4, 32>(t, out, B, R, W, s);
    case TRACKS10_K8:
      return (int)launch_tracks10<8, 16>(t, out, B, R, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out = {blocks an SM, threads a block, shared memory a block, pairs a
// block} of exp_v10_launch's kernel for `variant`.
extern "C" int exp_v10_occupancy(int variant, int* out) {
  switch (variant) {
    case REGS_P16:
      return (int)occupancy_warp(v10_regs_kernel<L_BLOCK, 16>,
                                 NewRows<L_BLOCK>::BYTES, out);
    case RINGS:
      return (int)occupancy_warp(v10_rings_kernel<L_BLOCK, RING_C>,
                                 V10Ring<L_BLOCK, RING_C>::BYTES, out);
    case TRACKS10_K1:
      return (int)occupancy_tracks10<1, 32>(out);
    case TRACKS10_K2:
      return (int)occupancy_tracks10<2, 32>(out);
    case TRACKS10_K4:
      return (int)occupancy_tracks10<4, 32>(out);
    case TRACKS10_K8:
      return (int)occupancy_tracks10<8, 16>(out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
