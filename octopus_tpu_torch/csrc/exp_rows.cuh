// Shared pieces of the kernel experiments' CUDA ports (Hopper, sm_90a):
// csrc/exp_dual_chain.cu, exp_v13.cu, exp_v10.cu and exp_v11.cu.
//
// The experiments in experiments/*.py take kernel-layout tracks: tgt and
// qual (R, B), the window tracks (W, B), W = R + D - 1, int32, B the fast
// axis. A block of P consecutive pairs reads one row of one track as P
// contiguous words, so a row comes in 16-byte cp.async copies (B % 128 == 0
// and P % 4 == 0 keep every copy aligned). Rows are staged into rings in
// shared memory chunk by chunk, two chunks in flight, as
// csrc/pairhmm_stage.cuh does for batch-major tracks: chunk c brings read
// rows [cC, cC+C) and window rows [cC+D-1, cC+C+D-1) (chunk 0 also rows
// [0, D-1)). A ring row holds the block's P pairs side by side, so thread
// lane reads word [row][g*L + lane]: the lanes of a warp read 32 distinct
// banks.
//
// The experiments run at PAD = 8 only, so these kernels are built for a
// band of D = 16 diagonals and nothing else.

#pragma once

#include <utility>

#include "pairhmm_stage.cuh"

namespace exp_rows {

using namespace pairhmm;

constexpr int D = 16;  // band of pad 8

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// a neighbouring slot of an unrolled loop, clamped so that a branch that
// never runs indexes inside the array
__host__ __device__ constexpr int up1(int k) { return k + 1 < D ? k + 1 : k; }

// v9's step on one cell of one thread's pair: read base ty and quality q,
// window values w, mk, pr, o, e at the cell's position, m_up and i_up the
// M and I of the diagonal above (INF past the band, row 0's parity mask on
// row 1); M, I and Dl are the cell's, updated in place; mi_prev and d_prev
// carry the deletion chain down the row's diagonals.
__device__ __forceinline__ void v9_cell(int ty, int q, int w, int mk, int pr,
                                        int o, int e, int m_up, int i_up,
                                        int nuc_prior, int& M, int& I,
                                        int& Dl, int& mi_prev, int& d_prev) {
  int cost = (mk == ty) ? min(q, pr) : q;
  cost = (ty == w) ? 0 : cost;
  cost = (w == N_CODE) ? min(cost, N_SCORE) : cost;
  const int mn = cost + min3(M, I, Dl);
  const int in = nuc_prior + addmin(i_up, e, m_up + o);
  M = mn;
  I = in;
  d_prev = addmin(d_prev, e, mi_prev + o);
  Dl = d_prev;
  mi_prev = min(mn, in);
}

// Rings of NW window tracks and the two read tracks for a block of P pairs,
// chunks of C rows; RW window rows and RT read rows a ring (powers of two).
template <int NW, int P, int C_ = 8, int RW_ = 32, int RT_ = 16>
struct RowRings {
  static constexpr int C = C_;
  static constexpr int RW = RW_;
  static constexpr int RT = RT_;
  static_assert((RW & (RW - 1)) == 0 && (RT & (RT - 1)) == 0,
                "rings of a power of two rows");
  static_assert(RW >= 2 * C + D - 1, "window ring below two chunks and a band");
  static_assert(RT >= 2 * C, "read ring below two chunks");
  static_assert(P % 4 == 0, "16-byte copies");
  static constexpr int TGT = NW * RW * P;
  static constexpr int QUAL = TGT + RT * P;
  static constexpr int WORDS = QUAL + RT * P;
  static constexpr size_t BYTES = WORDS * sizeof(int);

  template <class T>
  __device__ __forceinline__ static T* window(T* s, int k) {
    return s + k * RW * P;
  }

  // rows [r0, min(r1, len)) of one (len, B) track, the block's P columns
  // from `first` on, into a ring of `rows` rows
  __device__ __forceinline__ static void copy(int* ring, int rows,
                                              const int* __restrict__ g,
                                              int len, int B, int r0, int r1,
                                              int first) {
    constexpr int V = P / 4;  // 16-byte pieces a row
    const int n = (min(r1, len) - r0) * V;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = r0 + i / V;
      const int v = 4 * (i % V);
      cp_async16(ring + (r & (rows - 1)) * P + v,
                 g + (size_t)r * B + first + v);
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
      for (int k = 0; k < NW; ++k) {
        if (c == 0) copy(window(s, k), RW, win_g[k], W, B, 0, D - 1, first);
        copy(window(s, k), RW, win_g[k], W, B, c * C + D - 1,
             c * C + C + D - 1, first);
      }
      copy(s + TGT, RT, tgt, R, B, c * C, c * C + C, first);
      copy(s + QUAL, RT, qual, R, B, c * C, c * C + C, first);
    }
    cp_async_commit();
  }
};

// v9's arithmetic for K pairs of one thread, as csrc/pairhmm.cu's one
// thread a pair (T = 1): M, I and D of every diagonal in registers, the
// deletion chain run in the same pass. The diagonal loop is outside the
// pair loop, so a cell's ring address serves the K pairs and their K
// independent chains interleave.
template <int K, int P, int L>
struct V9Pairs {
  using Rings = RowRings<N_WINDOW, P>;
  int M[K][D], I[K][D], Dl[K][D];

  // row 0: M = 0, I = INF; deletions from the parity-masked M0 with opn and
  // ext shifted down one diagonal (fills INF and 0)
  __device__ __forceinline__ void row0(const int* s, int lane) {
    const int* so = Rings::window(s, OPN);
    const int* se = Rings::window(s, EXT);
#pragma unroll
    for (int g = 0; g < K; ++g) {
      const int col = g * L + lane;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int m_gap_prev = (d == 0) ? INF : (((d - 1) & 1) ? 0 : INF);
        const int bv = m_gap_prev + ((d == 0) ? INF : so[(d - 1) * P + col]);
        const int e = (d == 0) ? 0 : se[(d - 1) * P + col];
        Dl[g][d] = addmin(d == 0 ? INF : Dl[g][d > 0 ? d - 1 : 0], e, bv);
        M[g][d] = 0;
        I[g][d] = INF;
      }
    }
  }

  // one cell of pair g: diagonal k of a row with read base ty and quality
  // q, window values w, mk, pr, o, e at its position; mi_prev and d_prev
  // carry the deletion chain down the row's diagonals
  __device__ __forceinline__ void cell(int g, int k, int ty, int q, int w,
                                       int mk, int pr, int o, int e,
                                       bool row1, int& mi_prev, int& d_prev,
                                       int nuc_prior) {
    int m_up = INF, i_up = INF;
    if (k + 1 < D) {
      m_up = row1 ? (((k + 1) & 1) ? 0 : INF) : M[g][up1(k)];
      i_up = I[g][up1(k)];
    }
    v9_cell(ty, q, w, mk, pr, o, e, m_up, i_up, nuc_prior, M[g][k], I[g][k],
            Dl[g][k], mi_prev, d_prev);
  }

  // One row. Its body is the yardstick kernels' (exp_dual_chain.cu) and
  // keeps its own copy of v9_cell's arithmetic, so that their code stays
  // as it was measured.
  __device__ __forceinline__ void row(const int* s, int lane, int y,
                                      int nuc_prior) {
    const int* sw = Rings::window(s, WIN) + lane;
    const int* sk = Rings::window(s, MASK) + lane;
    const int* sp = Rings::window(s, PRIOR) + lane;
    const int* so = Rings::window(s, OPN) + lane;
    const int* se = Rings::window(s, EXT) + lane;
    const int rt = ((y - 1) & (Rings::RT - 1)) * P + lane;
    const bool row1 = (y == 1);
    int ty[K], q[K], mi_prev[K], d_prev[K];
#pragma unroll
    for (int g = 0; g < K; ++g) {
      ty[g] = s[Rings::TGT + rt + g * L];
      q[g] = s[Rings::QUAL + rt + g * L];
      mi_prev[g] = INF;
      d_prev[g] = INF;
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int j = ((y - 1 + k) & (Rings::RW - 1)) * P;
#pragma unroll
      for (int g = 0; g < K; ++g) {
        const int jg = j + g * L;
        const int w = sw[jg];
        int cost = (sk[jg] == ty[g]) ? min(q[g], sp[jg]) : q[g];
        cost = (ty[g] == w) ? 0 : cost;
        cost = (w == N_CODE) ? min(cost, N_SCORE) : cost;
        const int o = so[jg];
        const int e = se[jg];
        int m_up = INF, i_up = INF;
        if (k + 1 < D) {
          m_up = row1 ? (((k + 1) & 1) ? 0 : INF) : M[g][up1(k)];
          i_up = I[g][up1(k)];
        }
        const int mn = cost + min3(M[g][k], I[g][k], Dl[g][k]);
        const int in = nuc_prior + addmin(i_up, e, m_up + o);
        M[g][k] = mn;
        I[g][k] = in;
        d_prev[g] = addmin(d_prev[g], e, mi_prev[g] + o);
        Dl[g][k] = d_prev[g];
        mi_prev[g] = min(mn, in);
      }
    }
  }

  // rows y and y+1 in one pass over window positions y-1 .. y+D-1: the
  // value at position y-1+k is row y's diagonal k and row y+1's diagonal
  // k-1, so each is read from shared memory once for two cells. Row y+1's
  // cell k-1 runs right after row y's cell k, the last of row y that it
  // reads (its M and I above, k; its M, I and D, k-1), so both rows update
  // M, I and D in place.
  __device__ __forceinline__ void rows2(const int* s, int lane, int y,
                                        int nuc_prior) {
    const int* sw = Rings::window(s, WIN) + lane;
    const int* sk = Rings::window(s, MASK) + lane;
    const int* sp = Rings::window(s, PRIOR) + lane;
    const int* so = Rings::window(s, OPN) + lane;
    const int* se = Rings::window(s, EXT) + lane;
    const int rt0 = ((y - 1) & (Rings::RT - 1)) * P + lane;
    const int rt1 = (y & (Rings::RT - 1)) * P + lane;
    const bool row1 = (y == 1);
    int ty0[K], q0[K], ty1[K], q1[K], mi0[K], d0[K], mi1[K], d1[K];
#pragma unroll
    for (int g = 0; g < K; ++g) {
      ty0[g] = s[Rings::TGT + rt0 + g * L];
      q0[g] = s[Rings::QUAL + rt0 + g * L];
      ty1[g] = s[Rings::TGT + rt1 + g * L];
      q1[g] = s[Rings::QUAL + rt1 + g * L];
      mi0[g] = d0[g] = mi1[g] = d1[g] = INF;
    }
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      const int j = ((y - 1 + k) & (Rings::RW - 1)) * P;
#pragma unroll
      for (int g = 0; g < K; ++g) {
        const int jg = j + g * L;
        const int w = sw[jg], mk = sk[jg], pr = sp[jg], o = so[jg],
                  e = se[jg];
        if (k < D)
          cell(g, k < D ? k : 0, ty0[g], q0[g], w, mk, pr, o, e, row1, mi0[g],
               d0[g], nuc_prior);
        if (k > 0)
          cell(g, k > 0 ? k - 1 : 0, ty1[g], q1[g], w, mk, pr, o, e, false,
               mi1[g], d1[g], nuc_prior);
      }
    }
  }

  __device__ __forceinline__ void store(int* out, int first, int lane) const {
#pragma unroll
    for (int g = 0; g < K; ++g) {
      int best = INF;
#pragma unroll
      for (int k = 0; k < D; ++k) best = min(best, min3(M[g][k], I[g][k], Dl[g][k]));
      out[first + g * L + lane] = best;
    }
  }
};

// How the row loop of a chunk runs: #pragma unroll 2 (csrc/pairhmm.cu's
// own), two rows an iteration with an odd last row peeled (v13), one row an
// iteration under #pragma unroll 1 (v13's comparison), or two rows an
// iteration in one pass that shares their window loads (`rows2`), an odd
// last row peeled (v13's Hopper design).
enum Schedule { UNROLL2 = 0, TWO_ROWS = 1, ONE_ROW = 2, SHARED2 = 3 };

// The v9-arithmetic kernel of exp_dual_chain.cu and exp_v13.cu: a block of
// L lanes, K pairs a lane (pairs first + g*L + lane), P = K*L pairs a block.
template <int K, int L, int SCHED>
__global__ void __launch_bounds__(L)
v9_rows_kernel(const int* __restrict__ tgt, const int* __restrict__ qual,
               const int* __restrict__ win, const int* __restrict__ opn,
               const int* __restrict__ ext, const int* __restrict__ mask,
               const int* __restrict__ prior, int* __restrict__ out, int B,
               int R, int W, int nuc_prior) {
  constexpr int P = K * L;
  using Pairs = V9Pairs<K, P, L>;
  using Rings = typename Pairs::Rings;
  constexpr int C = Rings::C;
  extern __shared__ __align__(16) int smem[];
  const int first = blockIdx.x * P;
  const int lane = threadIdx.x;
  const int* win_g[N_WINDOW] = {win, mask, prior, opn, ext};
  Rings::stage(smem, 0, win_g, tgt, qual, R, W, B, first);
  Rings::stage(smem, 1, win_g, tgt, qual, R, W, B, first);

  Pairs st;
  const int nchunks = (R + C - 1) / C;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<1>();
    __syncthreads();  // every lane's copies of chunk c have landed
    if (c == 0) st.row0(smem, lane);
    const int y_end = min((c + 1) * C, R);
    if constexpr (SCHED == UNROLL2) {
#pragma unroll 2
      for (int y = c * C + 1; y <= y_end; ++y) st.row(smem, lane, y, nuc_prior);
    } else if constexpr (SCHED == TWO_ROWS) {
      int y = c * C + 1;
#pragma unroll 1
      for (; y < y_end; y += 2) {
        st.row(smem, lane, y, nuc_prior);
        st.row(smem, lane, y + 1, nuc_prior);
      }
      if (y == y_end) st.row(smem, lane, y, nuc_prior);  // odd last row
    } else if constexpr (SCHED == SHARED2) {
      int y = c * C + 1;
#pragma unroll 1
      for (; y < y_end; y += 2) st.rows2(smem, lane, y, nuc_prior);
      if (y == y_end) st.row(smem, lane, y, nuc_prior);  // odd last row
    } else {
#pragma unroll 1
      for (int y = c * C + 1; y <= y_end; ++y) st.row(smem, lane, y, nuc_prior);
    }
    __syncthreads();  // every lane is done with chunk c before c+2 lands
    Rings::stage(smem, c + 2, win_g, tgt, qual, R, W, B, first);
  }
  cp_async_wait<0>();
  st.store(out, first, lane);
}

// One launch of v9_rows_kernel<K, L, SCHED> on B pairs (B % (K*L) == 0).
template <int K, int L, int SCHED>
cudaError_t launch_v9_rows(const int* tgt, const int* qual, const int* win,
                           const int* opn, const int* ext, const int* mask,
                           const int* prior, int* out, int B, int R, int W,
                           int nuc_prior, cudaStream_t stream) {
  constexpr int P = K * L;
  constexpr size_t smem = V9Pairs<K, P, L>::Rings::BYTES;
  if (B % P) return cudaErrorInvalidValue;
  static SmemOptIn opt_in;
  const cudaError_t opted = opt_in(v9_rows_kernel<K, L, SCHED>, smem);
  if (opted != cudaSuccess) return opted;
  v9_rows_kernel<K, L, SCHED><<<B / P, L, smem, stream>>>(
      tgt, qual, win, opn, ext, mask, prior, out, B, R, W, nuc_prior);
  return cudaGetLastError();
}

// What one block of v9_rows_kernel<K, L, SCHED> holds on this device:
// out = {blocks an SM, threads a block, dynamic shared memory a block
// (bytes), pairs a block}; returns the cudaError_t.
template <int K, int L, int SCHED>
cudaError_t occupancy_v9_rows(int* out) {
  constexpr int P = K * L;
  constexpr size_t smem = V9Pairs<K, P, L>::Rings::BYTES;
  static SmemOptIn opt_in;
  cudaError_t err = opt_in(v9_rows_kernel<K, L, SCHED>, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], v9_rows_kernel<K, L, SCHED>, L, smem);
  out[1] = L;
  out[2] = (int)smem;
  out[3] = P;
  return err;
}

// The new rows of a block of L pairs (csrc/exp_v11.cu's and exp_v10.cu's
// register designs, which hold the first 16 window rows themselves),
// staged by 16-byte cp.async into rings of RN rows a track (two chunks of C
// rows): chunk c brings read rows [cC, cC+C) of tgt and qual and window
// rows [cC+D, cC+C+D) of the five window tracks, what rows cC+1 .. cC+C
// read beyond the first 16 window rows. A ring row holds the block's L
// pairs side by side.
template <int L, int C_ = 8>
struct NewRows {
  static constexpr int C = C_;
  static constexpr int RN = 2 * C;
  static constexpr int TGT = N_WINDOW, QUAL = N_WINDOW + 1;
  static constexpr int WORDS = (N_WINDOW + 2) * RN * L;
  static constexpr size_t BYTES = (size_t)WORDS * sizeof(int);
  static_assert(L % 4 == 0, "16-byte copies");
  static_assert((RN & (RN - 1)) == 0, "rings of a power of two rows");

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
      cp_async16(s + at(track, r, v), g + (size_t)r * B + first + v);
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

// The chunk turn before row y = cC + 1 (chunks of NewRows<L>): every lane
// is done with chunk c-1, whose ring rows take chunk c+1; chunk c has
// landed. Out of line, so that an unrolled body holds one call, not one
// copy, for each row that may start a chunk.
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

// A pair's register window, the Hopper designs of csrc/exp_v11.cu (#7)
// and exp_v10.cu (#6): one thread a pair, NV values of each of the band's
// 16 window positions in the thread's registers (value i of slot k in
// v[i][k]) and M, I and D of its 16 diagonals. The row loop is unrolled
// over P rows (P divides 16); at the start of each unrolled body slot k
// holds position y0-1+k for the body's first row y0, so row y0+i's
// diagonal k reads slot (i+k) % 16, all constants. At P = 16 a body ends
// where the next begins; below 16 the slots rotate by P after each body,
// which trades moves for code size. Row y's diagonal 0 frees the slot of
// position y-1, which takes position y+15 from NewRows' rings. Cell says
// what a slot holds and how a cell reads it:
//   NV, Carry: values a slot; what entering a position carries to the
//     next (entered in order, from position 0);
//   enter(w, m, p, o, e, nuc_prior, carry, x): the slot values x of a
//     position from its five raw window values;
//   row0(v, M, I, Dl): row 0 from the first 16 positions' slots;
//   cell<LAST>(t, q, v, sl, m_up, i_up, nuc_prior, M, I, Dl, mi_prev,
//     chain): one cell reading slot sl; m_up and i_up the M and I of the
//     diagonal above (LAST: the band's last diagonal, none above, INF);
//     mi_prev and chain carry the deletion chain down the row's diagonals.
template <int L, int P, class Cell>
struct RegWindows {
  static_assert(D % P == 0, "bodies of a divisor of the band");
  using Rows = NewRows<L>;
  static constexpr int NV = Cell::NV;
  int v[NV][D];
  int M[D], I[D], Dl[D];
  typename Cell::Carry carry;

  // a position's raw values into slot j
  __device__ __forceinline__ void put(int j, int w, int m, int p, int o,
                                      int e, int nuc_prior) {
    int x[NV];
    Cell::enter(w, m, p, o, e, nuc_prior, carry, x);
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i][j] = x[i];
  }

  // positions 0..15 into slots 0..15, then row 0
  __device__ __forceinline__ void init(const Tracks& g) {
    carry = {};
#pragma unroll
    for (int j = 0; j < D; ++j)
      put(j, g.at(g.win[WIN], j), g.at(g.win[MASK], j), g.at(g.win[PRIOR], j),
          g.at(g.win[OPN], j), g.at(g.win[EXT], j), g.nuc_prior);
    Cell::row0(v, M, I, Dl);
  }

  // slot k takes slot (k + S) % 16's values
  template <int S>
  __device__ __forceinline__ void rotate() {
    if constexpr (S % D != 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        int old[D];
#pragma unroll
        for (int k = 0; k < D; ++k) old[k] = v[i][k];
#pragma unroll
        for (int k = 0; k < D; ++k) v[i][k] = old[(k + S) & (D - 1)];
      }
    }
  }

  // row y, whose diagonal 0 reads slot U
  template <int U, bool ROW1>
  __device__ __forceinline__ void row(int y, const Tracks& g, const int* s) {
    const int lane = threadIdx.x;
    const int t = s[Rows::at(Rows::TGT, y - 1, lane)];
    const int q = s[Rows::at(Rows::QUAL, y - 1, lane)];
    int mi_prev = INF, chain = INF;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int sl = (U + k) & (D - 1);
      if (k + 1 < D) {
        const int m_up = ROW1 ? (((k + 1) & 1) ? 0 : INF) : M[up1(k)];
        Cell::template cell<false>(t, q, v, sl, m_up, I[up1(k)],
                                   g.nuc_prior, M[k], I[k], Dl[k], mi_prev,
                                   chain);
      } else {
        Cell::template cell<true>(t, q, v, sl, INF, INF, g.nuc_prior, M[k],
                                  I[k], Dl[k], mi_prev, chain);
      }
      if (k == 0) {
        // slot U is done: position y+15 into it, read by row y+1 last;
        // past the last window row the ring holds a value no row reads
        const int r = y + D - 1;
        put(U, s[Rows::at(WIN, r, lane)], s[Rows::at(MASK, r, lane)],
            s[Rows::at(PRIOR, r, lane)], s[Rows::at(OPN, r, lane)],
            s[Rows::at(EXT, r, lane)], g.nuc_prior);
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

// A register design's kernel body: this thread's pair of the block's L
// (first the block's first), its score into out.
template <int L, int P, class Cell>
__device__ __forceinline__ void regs_pairs(const Tracks& g, int* smem,
                                           int first, int* out) {
  NewRows<L>::stage(smem, 0, g.win, g.tgt, g.qual, g.R, g.W, g.B, first);
  RegWindows<L, P, Cell> st;
  st.init(g);
  turn<L>(0, g, smem, first);
  st.template row<0, true>(1, g, smem);
  st.template rotate<1>();  // slot k: position 1+k, for row 2
#pragma unroll 1
  for (int y0 = 2; y0 <= g.R; y0 += P)
    st.body(std::make_integer_sequence<int, P>{}, y0, g, smem, first);
  cp_async_wait<0>();
  out[g.b] = st.best();
}

// shape checks shared by the entry points: pad 8, W = R + 15, B > 0
inline bool shape_ok(int B, int R, int W, int pad) {
  return B > 0 && R > 0 && pad == 8 && W == R + D - 1;
}

}  // namespace exp_rows
