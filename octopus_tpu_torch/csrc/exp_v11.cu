// Experiment v11_kernel on Hopper, sm_90a: window tracks held in
// registers, one window row loaded a row.
//
// Replaces experiments/v11_kernel.py's TPU kernel (`scores_v11`,
// `_kernel_v11`, pl.pallas_call at :112), which keeps the six window
// tracks (win, mask, prior, opn, ext, pre = cumsum(ext)) in carried
// registers and slides them a row at a time, one (1, B) row load a track a
// row instead of a (D, B) window, to cut the kernel's load traffic ~16x.
// Its plain version is pairhmm_batch.pairhmm_scores_plain on the
// transposed tracks (kernel_experiments/v11_kernel.py).
//
// The Hopper design (`regs`): one thread a pair, as csrc/exp_rows.cuh's
// dual_chain K1, with the 16 window values of each of the five window
// tracks in the thread's own registers. Row y's diagonal k reads window
// row y-1+k, and once its diagonal 0 is done, window row y+15 (the last
// one row y+1 reads) is loaded into the register that row y-1 left. The
// row loop is unrolled over P rows, so every register index is a constant:
// at P = 16 the slide is a pure renaming (no move, no shuffle); at P = 4
// the 80 registers rotate by 4 after each unrolled body (80 moves a body),
// which trades moves for code size (P = 16 is ~7,000 SASS instructions).
// A row loads 7 values (its read base and quality, one window row of five
// tracks) against 82 for dual or #1. The sequential deletion chain needs
// no pre = cumsum(ext): that prologue leaves this path. The new rows are
// staged by 16-byte cp.async into rings of 16 rows a track (two chunks of
// 8 rows in flight, 448 bytes a pair; the chunk turn, barriers and
// copies, is one out-of-line call, so an unrolled body holds no copy of
// it). Registers: 80 window values and 48 for M, I and D a thread, 160-210
// in all, no spill (chip_smoke.py prints ptxas's report, the SASS size and
// the timings; PERF.md keeps them, also those of the designs measured and
// dropped: new rows straight from device memory, P = 8 and P = 1).
//
// The first port stays as the `shfl` variants (blk 1, 2): lane d of a
// 16-lane group holds diagonal d of one pair (two pairs a warp), its M, I,
// D and the six window values at j = y-1+d in registers. Each row every
// window value moves one lane down (__shfl_down_sync) and only the group's
// edge lane loads the new row's value, once a track, from device memory
// through L1 (prefetched a row ahead). v9's arithmetic runs lane-parallel:
// the insertion's diagonal above and the deletion open's diagonal below
// are shuffles, and the deletion chain is min_scan(bv - pre) + pre with a
// 4-step shuffle scan, as the TPU's _min_scan; the wrapper makes pre with
// torch's cumsum, as XLA made it outside the Pallas kernel. A cell costs
// 13 shuffles (6 slides, 2 + 1 neighbours, 4 scan steps) and the scan's
// selects.
//
// What bounds it: #1's function, int32 operations (OPS_PER_CELL in
// pairhmm_batch.py).
//
// Exactness: the same integers as pairhmm_batch.pairhmm_scores_plain
// (INF = 1<<29; `regs` runs csrc/pairhmm.cu's T = 1 chain; in `shfl` bv -
// pre and the scan stay in int32 and _min_scan's INF fill is kept, so a
// lane below the step takes min(u, INF) as on the TPU).

#include <utility>

#include "exp_rows.cuh"

using namespace pairhmm;

namespace {

constexpr int D = 16;  // band of pad 8: two pairs a warp in `shfl`

__device__ __forceinline__ int from_below(int x, int d, int fill) {
  const int v = __shfl_up_sync(FULL, x, 1, D);
  return d == 0 ? fill : v;
}

__device__ __forceinline__ int from_above(int x, int d, int fill) {
  const int v = __shfl_down_sync(FULL, x, 1, D);
  return d == D - 1 ? fill : v;
}

// _min_scan: inclusive running minimum over the group's lanes, INF shifted
// in below each step
__device__ __forceinline__ int min_scan(int u, int d) {
#pragma unroll
  for (int s = 1; s < D; s <<= 1) {
    const int v = __shfl_up_sync(FULL, u, s, D);
    u = min(u, d < s ? INF : v);
  }
  return u;
}

// The tracks' values at this lane's diagonal of the current row.
struct Window {
  int w, m, p, o, e, pre;
};

template <int BLK>
__global__ void __launch_bounds__(128 * BLK)
v11_kernel(const int* __restrict__ tgt, const int* __restrict__ qual,
           const int* __restrict__ win, const int* __restrict__ opn,
           const int* __restrict__ ext, const int* __restrict__ mask,
           const int* __restrict__ prior, const int* __restrict__ pre,
           int* __restrict__ out, int B, int R, int nuc_prior) {
  const int d = threadIdx.x & (D - 1);
  const int b = blockIdx.x * (128 * BLK / D) + threadIdx.x / D;
  const bool edge = (d == D - 1);
  const int* const tracks[6] = {win, mask, prior, opn, ext, pre};
  auto at = [&](const int* t, int row) { return __ldg(t + (size_t)row * B + b); };

  // the windows of row 1: lane d holds row d of each track
  Window v{at(win, d), at(mask, d), at(prior, d), at(opn, d), at(ext, d),
           at(pre, d)};
  // row 0: deletions from the parity-masked M0, opn and pre shifted down
  const int m0_gap = (d & 1) ? 0 : INF;
  const int opn0 = from_below(v.o, d, INF);
  const int pre0 = from_below(v.pre, d, 0);
  const int bv0 = from_below(m0_gap, d, INF) + opn0;
  int Dd = min_scan(bv0 - pre0, d) + pre0;
  int M = 0, I = INF;

  int t = at(tgt, 0), q = at(qual, 0);
  // the next row's edge values and read base, loaded a row ahead
  int nxt[6] = {0, 0, 0, 0, 0, 0};
  int t_next = 0, q_next = 0;
  for (int y = 1; y <= R; ++y) {
    if (y < R) {
      if (edge) {
#pragma unroll
        for (int k = 0; k < 6; ++k) nxt[k] = at(tracks[k], y + D - 1);
      }
      t_next = at(tgt, y);
      q_next = at(qual, y);
    }
    // row y: v9's step on this lane's diagonal
    const int mg = (y == 1) ? m0_gap : M;
    int capped = (v.m == t) ? min(q, v.p) : q;
    int cm = (t == v.w) ? 0 : capped;
    cm = (v.w == N_CODE) ? min(cm, N_SCORE) : cm;
    const int mn = cm + min3(M, I, Dd);
    const int in = nuc_prior + addmin(from_above(I, d, INF), v.e,
                                      from_above(mg, d, INF) + v.o);
    const int bv = from_below(min(mn, in), d, INF) + v.o;
    Dd = min_scan(bv - v.pre, d) + v.pre;
    M = mn;
    I = in;
    // slide every window one diagonal toward row y+1's view
    if (y < R) {
      v.w = from_above(v.w, d, nxt[0]);
      v.m = from_above(v.m, d, nxt[1]);
      v.p = from_above(v.p, d, nxt[2]);
      v.o = from_above(v.o, d, nxt[3]);
      v.e = from_above(v.e, d, nxt[4]);
      v.pre = from_above(v.pre, d, nxt[5]);
      t = t_next;
      q = q_next;
    }
  }
  int best = min3(M, I, Dd);
#pragma unroll
  for (int s = D / 2; s > 0; s >>= 1)
    best = min(best, __shfl_xor_sync(FULL, best, s, D));
  if (d == 0) out[b] = best;
}

template <int BLK>
cudaError_t launch_shfl(const int* const* t, int* out, int B, int R,
                        int nuc_prior, cudaStream_t stream) {
  constexpr int pairs = 128 * BLK / D;
  if (B % pairs) return cudaErrorInvalidValue;
  v11_kernel<BLK><<<B / pairs, 128 * BLK, 0, stream>>>(
      t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], out, B, R, nuc_prior);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// The Hopper design: window tracks in one thread's registers
// --------------------------------------------------------------------------

// The new rows of a block of L pairs, staged by 16-byte cp.async into rings
// of RN rows a track (two chunks of C rows): chunk c brings read rows
// [cC, cC+C) of tgt and qual and window rows [cC+D, cC+C+D) of the five
// window tracks, what rows cC+1 .. cC+C read beyond the first 16 window
// rows. A ring row holds the block's L pairs side by side.
template <int L>
struct NewRows {
  static constexpr int C = 8;
  static constexpr int RN = 2 * C;
  static constexpr int TGT = N_WINDOW, QUAL = N_WINDOW + 1;
  static constexpr size_t BYTES = (size_t)(N_WINDOW + 2) * RN * L * sizeof(int);
  static_assert(L % 4 == 0, "16-byte copies");

  // word of track `track`, ring row `row`, column `col`
  __device__ __forceinline__ static int at(int track, int row, int col) {
    return (track * RN + (row & (RN - 1))) * L + col;
  }

  // rows [r0, min(r0 + C, len)) of one (len, B) track, the block's columns
  __device__ __forceinline__ static void copy(int* s, int track,
                                              const int* __restrict__ g,
                                              int len, int B, int r0,
                                              int first) {
    constexpr int V = L / 4;
    const int n = (min(r0 + C, len) - r0) * V;
    for (int i = threadIdx.x; i < n; i += L) {
      const int r = r0 + i / V;
      const int v = 4 * (i % V);
      exp_rows::cp_async16(s + at(track, r, v), g + (size_t)r * B + first + v);
    }
  }

  // start chunk c's copies (none past the last row), one commit group
  __device__ __forceinline__ static void stage(int* s, int c,
                                               const int* const* win_g,
                                               const int* tgt,
                                               const int* qual, int R, int W,
                                               int B, int first) {
    if (c * C < R) {
#pragma unroll
      for (int k = 0; k < N_WINDOW; ++k)
        copy(s, k, win_g[k], W, B, c * C + D, first);
      copy(s, TGT, tgt, R, B, c * C, first);
      copy(s, QUAL, qual, R, B, c * C, first);
    }
    cp_async_commit();
  }
};

// Kernel-layout tracks of one launch and this thread's pair.
struct Tracks {
  const int* __restrict__ tgt;
  const int* __restrict__ qual;
  const int* win[N_WINDOW];  // WIN, MASK, PRIOR, OPN, EXT
  int B, R, W, b, nuc_prior;

  __device__ __forceinline__ int at(const int* t, int row) const {
    return __ldg(t + (size_t)row * B + b);
  }
};

// The chunk turn before row y = cC + 1: every lane is done with chunk
// c-1, whose ring rows take chunk c+1; chunk c has landed. Out of line, so
// that an unrolled body holds one call, not one copy, for each row that
// may start a chunk.
template <int L>
__device__ __noinline__ void turn_chunk(int c, int* s, const int* tgt,
                                        const int* qual, const int* win,
                                        const int* mask, const int* prior,
                                        const int* opn, const int* ext, int R,
                                        int W, int B, int first) {
  const int* win_g[N_WINDOW] = {win, mask, prior, opn, ext};
  __syncthreads();
  NewRows<L>::stage(s, c + 1, win_g, tgt, qual, R, W, B, first);
  cp_async_wait<1>();
  __syncthreads();
}

template <int L>
__device__ __forceinline__ void turn(int c, const Tracks& g, int* s,
                                     int first) {
  turn_chunk<L>(c, s, g.tgt, g.qual, g.win[WIN], g.win[MASK], g.win[PRIOR],
                g.win[OPN], g.win[EXT], g.R, g.W, g.B, first);
}

// One pair's state: the window slots and M, I and D of its 16 diagonals.
// The row loop is unrolled over P rows (P divides 16); at the start of
// each unrolled body slot k holds window row y0-1+k for the body's first
// row y0, so row y0+i's diagonal k reads slot (i+k) % 16, all constants.
// At P = 16 a body ends where the next begins; below 16 the slots rotate
// by P after each body (80 register moves), which trades moves for code
// size.
template <int L, int P>
struct RegWindows {
  static_assert(D % P == 0, "bodies of a divisor of the band");
  using Rows = NewRows<L>;
  int w[D], m[D], p[D], o[D], e[D];
  int M[D], I[D], Dl[D];

  // window rows 0..15 into slots 0..15; row 0 (M = 0, I = INF, deletions
  // from the parity-masked M0 with opn and ext shifted down one diagonal)
  __device__ __forceinline__ void init(const Tracks& g) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      w[j] = g.at(g.win[WIN], j);
      m[j] = g.at(g.win[MASK], j);
      p[j] = g.at(g.win[PRIOR], j);
      o[j] = g.at(g.win[OPN], j);
      e[j] = g.at(g.win[EXT], j);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int m_gap_prev = (d == 0) ? INF : (((d - 1) & 1) ? 0 : INF);
      const int bv = m_gap_prev + ((d == 0) ? INF : o[d > 0 ? d - 1 : 0]);
      const int ed = (d == 0) ? 0 : e[d > 0 ? d - 1 : 0];
      Dl[d] = addmin(d == 0 ? INF : Dl[d > 0 ? d - 1 : 0], ed, bv);
      M[d] = 0;
      I[d] = INF;
    }
  }

  // slot k takes slot (k + S) % 16's value
  template <int S>
  __device__ __forceinline__ static void rotate(int (&a)[D]) {
    int old[D];
#pragma unroll
    for (int k = 0; k < D; ++k) old[k] = a[k];
#pragma unroll
    for (int k = 0; k < D; ++k) a[k] = old[(k + S) & (D - 1)];
  }

  template <int S>
  __device__ __forceinline__ void rotate() {
    if constexpr (S % D != 0) {
      rotate<S>(w);
      rotate<S>(m);
      rotate<S>(p);
      rotate<S>(o);
      rotate<S>(e);
    }
  }

  // row y, whose diagonal 0 reads slot U
  template <int U, bool ROW1>
  __device__ __forceinline__ void row(int y, const Tracks& g, const int* s) {
    const int lane = threadIdx.x;
    const int t = s[Rows::at(Rows::TGT, y - 1, lane)];
    const int q = s[Rows::at(Rows::QUAL, y - 1, lane)];
    int mi_prev = INF, d_prev = INF;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int sl = (U + k) & (D - 1);
      int m_up = INF, i_up = INF;
      if (k + 1 < D) {
        m_up = ROW1 ? (((k + 1) & 1) ? 0 : INF) : M[exp_rows::up1(k)];
        i_up = I[exp_rows::up1(k)];
      }
      exp_rows::v9_cell(t, q, w[sl], m[sl], p[sl], o[sl], e[sl], m_up,
                        i_up, g.nuc_prior, M[k], I[k], Dl[k], mi_prev,
                        d_prev);
      if (k == 0) {
        // slot U is done: window row y+15 into it, read by row y+1 last;
        // past the last window row the ring holds a value no row reads
        const int r = y + D - 1;
        w[U] = s[Rows::at(WIN, r, lane)];
        m[U] = s[Rows::at(MASK, r, lane)];
        p[U] = s[Rows::at(PRIOR, r, lane)];
        o[U] = s[Rows::at(OPN, r, lane)];
        e[U] = s[Rows::at(EXT, r, lane)];
      }
    }
  }

  // row y, step U of its body; false past R
  template <int U>
  __device__ __forceinline__ bool step(int y, const Tracks& g, int* s,
                                       int first) {
    if (y > g.R) return false;
    if ((y - 1) % Rows::C == 0) turn<L>((y - 1) / Rows::C, g, s, first);
    this->template row<U, false>(y, g, s);
    return true;
  }

  // rows y0 .. y0+P-1, up to R, then the slots for row y0+P
  template <int... Is>
  __device__ __forceinline__ void body(std::integer_sequence<int, Is...>,
                                       int y0, const Tracks& g, int* s,
                                       int first) {
    if ((... && this->template step<Is>(y0 + Is, g, s, first)))
      this->template rotate<P>();
  }

  __device__ __forceinline__ int best() const {
    int out = INF;
#pragma unroll
    for (int k = 0; k < D; ++k) out = min(out, min3(M[k], I[k], Dl[k]));
    return out;
  }
};

template <int L, int P>
__global__ void __launch_bounds__(L)
regs_kernel(const int* __restrict__ tgt, const int* __restrict__ qual,
            const int* __restrict__ win, const int* __restrict__ opn,
            const int* __restrict__ ext, const int* __restrict__ mask,
            const int* __restrict__ prior, int* __restrict__ out, int B,
            int R, int W, int nuc_prior) {
  extern __shared__ __align__(16) int smem[];
  const int first = blockIdx.x * L;
  const Tracks g{tgt, qual, {win, mask, prior, opn, ext}, B, R, W,
                 first + (int)threadIdx.x, nuc_prior};
  NewRows<L>::stage(smem, 0, g.win, tgt, qual, R, W, B, first);
  RegWindows<L, P> st;
  st.init(g);
  turn<L>(0, g, smem, first);
  st.template row<0, true>(1, g, smem);
  st.template rotate<1>();  // slot k: window row 1+k, for row 2
#pragma unroll 1
  for (int y0 = 2; y0 <= R; y0 += P)
    st.body(std::make_integer_sequence<int, P>{}, y0, g, smem, first);
  cp_async_wait<0>();
  out[g.b] = st.best();
}

template <int L, int P>
cudaError_t launch_regs(const int* const* t, int* out, int B, int R, int W,
                        int nuc_prior, cudaStream_t stream) {
  constexpr size_t smem = NewRows<L>::BYTES;
  static_assert(smem <= 48 * 1024, "no opt-in");
  if (B % L) return cudaErrorInvalidValue;
  regs_kernel<L, P><<<B / L, L, smem, stream>>>(
      t[0], t[1], t[2], t[3], t[4], t[5], t[6], out, B, R, W, nuc_prior);
  return cudaGetLastError();
}

template <int L, int P>
cudaError_t occupancy_regs(int* out) {
  constexpr size_t smem = NewRows<L>::BYTES;
  out[1] = L;
  out[2] = (int)smem;
  out[3] = L;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], regs_kernel<L, P>, L, smem);
}

template <int BLK>
cudaError_t occupancy_shfl(int* out) {
  out[1] = 128 * BLK;
  out[2] = 0;
  out[3] = 128 * BLK / D;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0],
                                                       v11_kernel<BLK>,
                                                       128 * BLK, 0);
}

// variant argument of the entry points: the register design with its row
// loop unrolled over 4 or 16 rows, and the first port's design
enum Variant { REGS_RING_P4 = 0, REGS_RING_P16 = 1, SHFL_BLK1 = 2,
               SHFL_BLK2 = 3 };
constexpr int REGS_L = 32;  // one warp a block

}  // namespace

// Plain C entry point for ctypes: kernel-layout int32 device pointers tgt,
// qual (R, B), win, opn, ext, mask, prior (W, B), W = R + 15, and pre (W,
// B; read by the shfl variants only, may be null for the others); pad 8;
// variant (enum Variant) 0, 1: P = 4, 16 (B % 32 == 0); 2 shfl blk 1, 3
// shfl blk 2 (B % (8 blk) == 0); the wrapper asks for B % 128. Returns the
// cudaError_t.
extern "C" int exp_v11_launch(const int* tgt, const int* qual, const int* win,
                              const int* opn, const int* ext, const int* mask,
                              const int* prior, const int* pre, int* out,
                              int B, int R, int W, int pad, int nuc_prior,
                              int variant, void* stream) {
  if (B <= 0 || R <= 0 || pad != 8 || W != R + D - 1)
    return (int)cudaErrorInvalidValue;
  const int* t[8] = {tgt, qual, win, opn, ext, mask, prior, pre};
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case REGS_RING_P4:
      return (int)launch_regs<REGS_L, 4>(t, out, B, R, W, nuc_prior, s);
    case REGS_RING_P16:
      return (int)launch_regs<REGS_L, 16>(t, out, B, R, W, nuc_prior, s);
    case SHFL_BLK1:
      return pre ? (int)launch_shfl<1>(t, out, B, R, nuc_prior, s)
                 : (int)cudaErrorInvalidValue;
    case SHFL_BLK2:
      return pre ? (int)launch_shfl<2>(t, out, B, R, nuc_prior, s)
                 : (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out = {blocks an SM, threads a block, shared memory a block, pairs a
// block} of exp_v11_launch's kernel for `variant`.
extern "C" int exp_v11_occupancy(int variant, int* out) {
  switch (variant) {
    case REGS_RING_P4:
      return (int)occupancy_regs<REGS_L, 4>(out);
    case REGS_RING_P16:
      return (int)occupancy_regs<REGS_L, 16>(out);
    case SHFL_BLK1:
      return (int)occupancy_shfl<1>(out);
    case SHFL_BLK2:
      return (int)occupancy_shfl<2>(out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
