// Shared pieces of the kernel experiments' CUDA ports (Hopper, sm_90a):
// csrc/exp_dual_chain.cu, exp_v13.cu and exp_v10.cu.
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

// shape checks shared by the entry points: pad 8, W = R + 15, B > 0
inline bool shape_ok(int B, int R, int W, int pad) {
  return B > 0 && R > 0 && pad == 8 && W == R + D - 1;
}

}  // namespace exp_rows
