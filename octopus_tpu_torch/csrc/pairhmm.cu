// Banded pair-HMM (integer-phred Viterbi) for Hopper, sm_90a.
//
// Replaces the reference package's two production TPU kernels,
// octopus_tpu/core/likelihood/pairhmm_batch.py:
//   #1 pairhmm_scores_pallas_v12 / _kernel_v12 (4 interleaved 128-lane chains)
//   #2 pairhmm_scores_pallas_v9  / _pallas_kernel_v9 (one chain, fori_loop)
// Both compute the same score and differ only in TPU scheduling, so one
// kernel ports both. Its plain twin is pairhmm_scores_plain in
// octopus_tpu_torch/core/likelihood/pairhmm_batch.py (with threads=T it
// follows this kernel's split of the deletion chain); they agree bit for bit.
//
// Semantics (pair b, band of D = 2*pad diagonals, rows y = 1..R, diagonal d
// of row y pairs read base y-1 with window base j = y-1+d):
//   cm   = match cost: 0 on a base match, else qual, capped by the SNV prior
//          where mask == read base, and capped at N_SCORE on a window N
//   M'd  = cm + min(Md, Id, Dd)
//   I'd  = nuc_prior + min(Mg[d+1] + opn[j], I[d+1] + ext[j])  (d = D-1: INF)
//   bv_d = min(M'[d-1], I'[d-1]) + opn[j]                       (d = 0: INF)
//   D'd  = min(bv_d, D'[d-1] + ext[j])                          (D'[-1] = INF)
// with Mg = M except on row 1, where gaps out of row 0 may start only at
// odd offsets (Mg = 0 at odd d, INF at even d). Row 0 deletions come from
// opn/ext shifted down one diagonal. The score is min over d of min(M, I, D)
// after row R.
//
// What bounds it on the H100. At the bench shape (65,536 pairs, R = 150,
// D = 16) the function needs at least 14 int32 instructions a cell in the
// fused form (OPS_PER_CELL in pairhmm_batch.py) against (2R + 5W)*4 bytes a
// pair read once: operations bind, and the kernel must keep the INT32 pipes
// fed. At the main path's shapes (1-519 pairs, R = 160) the work is
// thousands of times below the card's rate: a launch is latency, the chain
// of 160 dependent rows a pair runs through, plus the host's cost of the
// launch. A kernel of one thread a pair loses on both: each row waits on
// a load from device memory, one thread walks 160 rows of ~19*D dependent
// instructions, and five D-wide register windows that slide every row cost
// 5 moves a cell, 255 registers and spills at D >= 32.
//
// Design.
// - Tracks are batch-major, (B, R) and (B, W): the wrapper transposes
//   nothing. A block is one warp and scores P = 32/T pairs; it stages their
//   rows into shared-memory rings by cp.async, two chunks in flight ahead of
//   the row loop (csrc/pairhmm_stage.cuh), so a row reads only shared memory
//   and registers, and the window values at j = y-1+d are read from the
//   staged rows. A thread keeps only M, I and D (and a segment's ext sums)
//   for its diagonals in registers, so no band spills.
// - T threads a pair, each owning K = D/T consecutive diagonals d = t*K ..
//   t*K+K-1 (template), in one of two schedules; the wrapper picks the
//   schedule and T from B and D (pairhmm_threads and pairhmm_wave in
//   pairhmm_batch.py, a rule read off chip_smoke.py's timing of every
//   variant):
//   * the split chain, for batches that fill the card: every thread runs the
//     same row. The deletion chain runs sequentially inside a thread from
//     its segment's start, giving for diagonal k the segment's value without
//     input, lb_k, and its ext sum, le_k. Each segment is the min-plus map
//     x -> min(B, x + E); a log2(T)-step shuffle scan composes them ((B1,E1)
//     then (B2,E2) = (min(B2, B1 + E2), E1 + E2)), thread t-1's inclusive map
//     applied to the chain's INF input gives thread t's input X, and
//     D'_d = min(lb_k, X + le_k). That is the sequential chain's minimum
//     over the same integer sums (min over k' <= d of bv_k' plus the ext
//     between, and INF plus all ext), taken in another order, so the
//     integers are the same. T = 1 runs the sequential chain as it stands.
//     Chunks of D/2 rows keep a pair's rings small, so many pairs fit on an
//     SM; the window rings have an odd pitch (2D+1 words), so the 32 pairs
//     of a one-thread-per-pair warp read 32 distinct banks.
//   * the wavefront, for launches of a few hundred pairs (K >= 2): thread t
//     runs row s - t + 1 at step s, so a cell's inputs from the diagonal
//     below were made by thread t-1 one step earlier and those from the
//     diagonal above by thread t+1's first diagonal in the same step. A step
//     costs one shuffle each way and K chain steps, with no scan on the
//     row's critical path, and every cell is computed by the sequential
//     chain's own operations. Chunks of 32 rows, since each chunk turn (a
//     wait, a warp sync, the next copies) sits on that chain.
// - DPX: min(a + b, c) and min(a, b, c) as __viaddmin_s32 and __vimin3_s32
//   for M's minimum of three, I's minimum of two sums and the chain step.
//   Timed against the plain int32 form, the two tied (ptxas fuses the plain
//   form the same way; PERF.md), so only the DPX form is built.
//
// Exactness and overflow. INF = 1<<29. Every intermediate is a bv (at most
// 2*INF + opn, on row 0 at d = 0) or INF, plus a sum of at most D ext values;
// with opn and ext below 2^22 each such sum stays below 2^31, so no int32
// sum wraps and no minimum saturates. The DPX forms are plain int32
// arithmetic (no _relu or saturating variant).

#include <type_traits>

#include "pairhmm_stage.cuh"

namespace {

using namespace pairhmm;

template <int D, int T>
struct Geometry {
  static constexpr int K = D / T;   // diagonals a thread
  static constexpr int P = 32 / T;  // pairs a block (one warp)
  // small chunks: the split serves batches that fill the card
  using Rings = Ring<D, P, D / 2, 2 * D, D, 2 * D + 1, D + 1>;
};

// The wavefront's rings: 32-row chunks (it serves launches of a few hundred
// pairs, where chunk turns sit on the chain of rows); its threads lag up to
// T - 1 <= D/2 rows behind the chunk staged for step s, so the tgt/qual
// ring holds 128 words too. At step s thread t of pair p reads window word
// s + t(K-1) + k and tgt word s - t; a pitch of 128 + T words puts the
// warp's pairs T banks apart, so no two threads of a warp read one bank.
template <int D, int T>
using WaveRings = Ring<D, 32 / T, 32, 128, 128, 128 + T, 128 + T>;

// neighbouring slots of an unrolled loop, clamped so that a branch that
// never runs indexes inside the array
__host__ __device__ constexpr int prev(int k) { return k > 0 ? k - 1 : 0; }
template <int K>
__host__ __device__ constexpr int next(int k) { return k + 1 < K ? k + 1 : k; }

// T > 1: lb[k] holds the deletion chain of this thread's segment from its
// first diagonal on without input, le[k] the segment's ext sum up to k.
// Composes the segments' min-plus maps across the T threads and leaves in
// lb[k] the band's chain value, fed INF before diagonal 0.
template <int K, int T>
__device__ __forceinline__ void carry_segments(int (&lb)[K],
                                               const int (&le)[K], int t) {
  int b = lb[K - 1], s = le[K - 1];
#pragma unroll
  for (int step = 1; step < T; step <<= 1) {
    const int bp = __shfl_up_sync(FULL, b, step, T);
    const int sp = __shfl_up_sync(FULL, s, step, T);
    if (t >= step) {
      b = addmin(bp, s, b);  // (bp, sp) then (b, s)
      s += sp;
    }
  }
  // the chain after this thread's segment, fed INF: the next thread's input
  const int end = addmin(INF, s, b);
  int x = __shfl_up_sync(FULL, end, 1, T);
  if (t == 0) x = INF;
#pragma unroll
  for (int k = 0; k < K; ++k) lb[k] = addmin(x, le[k], lb[k]);
}

template <int D, int T>
__global__ void __launch_bounds__(32)
pairhmm_kernel(const int* __restrict__ tgt, const int* __restrict__ qual,
               const int* __restrict__ win, const int* __restrict__ opn,
               const int* __restrict__ ext, const int* __restrict__ mask,
               const int* __restrict__ prior, int* __restrict__ out,
               int B, int R, int W, int nuc_prior) {
  using G = Geometry<D, T>;
  using Rings = typename G::Rings;
  constexpr int K = G::K;
  constexpr int P = G::P;
  constexpr int C = Rings::C;
  extern __shared__ int smem[];

  const int first = blockIdx.x * P;
  const int nvalid = min(P, B - first);
  const int p_own = threadIdx.x / T;
  const int t = threadIdx.x % T;
  // a thread past the batch edge repeats the block's last pair (it must take
  // part in the shuffles) and stores nothing
  const int p = min(p_own, nvalid - 1);
  const int d0 = t * K;

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

  int M[K], I[K], Dl[K];
  const int nchunks = (R + C - 1) / C;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<1>();
    __syncwarp();
    if (c == 0) {
      // row 0: M = 0, I = INF; deletions from the parity-masked M0 with opn
      // and ext shifted down one diagonal (fills INF and 0)
      int le[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = d0 + k;
        const int m_gap_prev = (d == 0) ? INF : (((d - 1) & 1) ? 0 : INF);
        const int jd = (d - 1) & (Rings::RW - 1);  // read at d >= 1
        const int bv = m_gap_prev + ((d == 0) ? INF : so[jd]);
        const int e = (d == 0) ? 0 : se[jd];
        if constexpr (T == 1) {
          Dl[k] = addmin(k == 0 ? INF : Dl[prev(k)], e, bv);
        } else {
          Dl[k] = (k == 0) ? bv : addmin(Dl[prev(k)], e, bv);
          le[k] = (k == 0) ? e : le[prev(k)] + e;
        }
        M[k] = 0;
        I[k] = INF;
      }
      if constexpr (T > 1) carry_segments<K, T>(Dl, le, t);
    }
    const int y_end = min((c + 1) * C, R);
#pragma unroll 2
    for (int y = c * C + 1; y <= y_end; ++y) {
      const int ty = st[(y - 1) & (Rings::RT - 1)];
      const int q = sq[(y - 1) & (Rings::RT - 1)];
      const bool row1 = (y == 1);
      // Mg and I at diagonal d0 + K, the next thread's first (INF past D)
      int m_next = INF, i_next = INF;
      if constexpr (T > 1) {
        const int mg_first = row1 ? ((d0 & 1) ? 0 : INF) : M[0];
        m_next = __shfl_down_sync(FULL, mg_first, 1, T);
        i_next = __shfl_down_sync(FULL, I[0], 1, T);
        if (t == T - 1) {
          m_next = INF;
          i_next = INF;
        }
      }
      // pass 1: M' and I' (diagonal k reads the old M, I at k+1, so k rises);
      // T = 1 runs the deletion chain in the same pass
      int mi_prev = INF, d_prev = INF;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = (y - 1 + d0 + k) & (Rings::RW - 1);
        const int w = sw[j];
        int cost = (sm[j] == ty) ? min(q, sp[j]) : q;
        cost = (ty == w) ? 0 : cost;
        cost = (w == N_CODE) ? min(cost, N_SCORE) : cost;
        const int o = so[j];
        const int e = se[j];
        int m_up, i_up;
        if (k + 1 < K) {
          m_up = row1 ? (((d0 + k + 1) & 1) ? 0 : INF) : M[next<K>(k)];
          i_up = I[next<K>(k)];
        } else {
          m_up = m_next;
          i_up = i_next;
        }
        const int mn = cost + min3(M[k], I[k], Dl[k]);
        const int in = nuc_prior + addmin(i_up, e, m_up + o);
        M[k] = mn;
        I[k] = in;
        if constexpr (T == 1) {
          d_prev = addmin(d_prev, e, mi_prev + o);
          Dl[k] = d_prev;
          mi_prev = min(mn, in);
        }
      }
      if constexpr (T > 1) {
        // pass 2: the deletion open from min(M', I') one diagonal down (the
        // previous thread's last at k = 0), each segment's chain, the carry
        mi_prev = __shfl_up_sync(FULL, min(M[K - 1], I[K - 1]), 1, T);
        if (t == 0) mi_prev = INF;
        int le[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = (y - 1 + d0 + k) & (Rings::RW - 1);
          const int e = se[j];
          const int bv =
              ((k == 0) ? mi_prev : min(M[prev(k)], I[prev(k)])) + so[j];
          Dl[k] = (k == 0) ? bv : addmin(Dl[prev(k)], e, bv);
          le[k] = (k == 0) ? e : le[prev(k)] + e;
        }
        carry_segments<K, T>(Dl, le, t);
      }
    }
    __syncwarp();  // every lane is done with chunk c before c+2 lands on it
    Rings::stage(smem, c + 2, tgt, qual, win_g, R, W, first, nvalid);
  }
  cp_async_wait<0>();

  int best = INF;
#pragma unroll
  for (int k = 0; k < K; ++k) best = min(best, min3(M[k], I[k], Dl[k]));
#pragma unroll
  for (int s = T / 2; s > 0; s >>= 1)
    best = min(best, __shfl_xor_sync(FULL, best, s, T));
  if (p_own < nvalid && t == 0) out[first + p_own] = best;
}

// The wavefront schedule: thread t of a pair (K = D/T >= 2 diagonals) runs
// row y = s - t + 1 at step s, s = 0 .. R+T-2, after row 0, which all
// threads compute at once with the split chain's carry. So the threads of
// a pair stand on an anti-diagonal of (row, thread). A cell's deletion input, M', I' and D'
// one diagonal down on its own row, was made by thread t-1 one step
// earlier; its insertion input, M and I one diagonal up on the row above,
// is thread t+1's first diagonal made in the same step, which needs nothing
// from thread t+2 since K >= 2. So a step costs one shuffle each way and K
// sequential chain steps, with no scan, and every cell is computed by the
// same operations as the sequential chain: the integers are those of T = 1.
template <int D, int T>
__global__ void __launch_bounds__(32)
pairhmm_wave_kernel(const int* __restrict__ tgt, const int* __restrict__ qual,
                    const int* __restrict__ win, const int* __restrict__ opn,
                    const int* __restrict__ ext, const int* __restrict__ mask,
                    const int* __restrict__ prior, int* __restrict__ out,
                    int B, int R, int W, int nuc_prior) {
  constexpr int K = D / T;
  constexpr int P = 32 / T;
  static_assert(T >= 2 && K >= 2, "a wavefront needs K >= 2 diagonals a thread");
  using Rings = WaveRings<D, T>;
  static_assert(Rings::RT >= 2 * Rings::C + T - 1, "tgt/qual ring below lag");
  constexpr int C = Rings::C;
  extern __shared__ int smem[];

  const int first = blockIdx.x * P;
  const int nvalid = min(P, B - first);
  const int p_own = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const int p = min(p_own, nvalid - 1);
  const int d0 = t * K;

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

  int M[K], I[K], Dl[K];
  // min(M', I') and D' one diagonal below d0 on this thread's row, made by
  // thread t-1 in the previous step (INF below the band)
  int up_mi = INF, up_d = INF;
  const int steps = R + T - 1;  // thread t runs row y = s - t + 1 at step s
  const int nchunks = (steps + C - 1) / C;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<1>();
    __syncwarp();
    if (c == 0) {
      // row 0 for every thread at once: M = 0, I = INF; deletions from the
      // parity-masked M0 with opn and ext shifted down one diagonal (fills
      // INF and 0), the chain carried across the threads as in the split
      int le[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = d0 + k;
        const int m_gap_prev = (d == 0) ? INF : (((d - 1) & 1) ? 0 : INF);
        const int bv = m_gap_prev + ((d == 0) ? INF : so[d - 1]);
        const int e = (d == 0) ? 0 : se[d - 1];
        Dl[k] = (k == 0) ? bv : addmin(Dl[prev(k)], e, bv);
        le[k] = (k == 0) ? e : le[prev(k)] + e;
        M[k] = 0;
        I[k] = INF;
      }
      carry_segments<K, T>(Dl, le, t);
    }
    const int s_end = min((c + 1) * C, steps);
#pragma unroll 2
    for (int s = c * C; s < s_end; ++s) {
      const int y = s - t + 1;
      const bool active = (y >= 1) && (y <= R);
      const bool row1 = (y == 1);
      const int ty = st[(y - 1) & (Rings::RT - 1)];
      const int q = sq[(y - 1) & (Rings::RT - 1)];
      int mn[K], in[K], o[K], e[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = (y - 1 + d0 + k) & (Rings::RW - 1);
        const int w = sw[j];
        int cost = (sm[j] == ty) ? min(q, sp[j]) : q;
        cost = (ty == w) ? 0 : cost;
        cost = (w == N_CODE) ? min(cost, N_SCORE) : cost;
        o[k] = so[j];
        e[k] = se[j];
        mn[k] = cost + min3(M[k], I[k], Dl[k]);
        if (k + 1 < K) {
          const int m_up = row1 ? (((d0 + k + 1) & 1) ? 0 : INF) : M[next<K>(k)];
          in[k] = nuc_prior + addmin(I[next<K>(k)], e[k], m_up + o[k]);
        }
      }
      // this thread's first diagonal on row y goes to thread t-1 (row y+1
      // there); a thread still on row 0 sends the parity-masked M0 and INF
      const bool row0 = (y == 0);
      int m_next = __shfl_down_sync(FULL, row0 ? ((d0 & 1) ? 0 : INF) : mn[0],
                                    1, T);
      int i_next = __shfl_down_sync(FULL, row0 ? INF : in[0], 1, T);
      if (t == T - 1) {
        m_next = INF;
        i_next = INF;
      }
      in[K - 1] = nuc_prior + addmin(i_next, e[K - 1], m_next + o[K - 1]);
      int chain = up_d;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int mi = (k == 0) ? up_mi : min(mn[prev(k)], in[prev(k)]);
        chain = addmin(chain, e[k], mi + o[k]);
        if (active) {
          M[k] = mn[k];
          I[k] = in[k];
          Dl[k] = chain;
        }
      }
      up_mi = __shfl_up_sync(FULL, min(M[K - 1], I[K - 1]), 1, T);
      up_d = __shfl_up_sync(FULL, Dl[K - 1], 1, T);
      if (t == 0) {
        up_mi = INF;
        up_d = INF;
      }
    }
    __syncwarp();  // every lane is done with chunk c before c+2 lands on it
    Rings::stage(smem, c + 2, tgt, qual, win_g, R, W, first, nvalid);
  }
  cp_async_wait<0>();

  int best = INF;
#pragma unroll
  for (int k = 0; k < K; ++k) best = min(best, min3(M[k], I[k], Dl[k]));
#pragma unroll
  for (int s = T / 2; s > 0; s >>= 1)
    best = min(best, __shfl_xor_sync(FULL, best, s, T));
  if (p_own < nvalid && t == 0) out[first + p_own] = best;
}

using KernelFn = void (*)(const int*, const int*, const int*, const int*,
                         const int*, const int*, const int*, int*, int, int,
                         int, int);

template <int D, int T, bool WAVE>
struct Variant {
  static constexpr bool valid = !WAVE || (T >= 2 && D / T >= 2);
  using Rings = std::conditional_t<WAVE, WaveRings<D, T>,
                                   typename Geometry<D, T>::Rings>;
};

template <int D, int T, bool WAVE>
cudaError_t launch(const int* tgt, const int* qual, const int* win,
                   const int* opn, const int* ext, const int* mask,
                   const int* prior, int* out, int B, int R, int W,
                   int nuc_prior, cudaStream_t stream) {
  if constexpr (!Variant<D, T, WAVE>::valid) {
    return cudaErrorInvalidValue;
  } else {
    constexpr size_t smem = Variant<D, T, WAVE>::Rings::BYTES;
    KernelFn kernel;
    if constexpr (WAVE) kernel = pairhmm_wave_kernel<D, T>;
    else kernel = pairhmm_kernel<D, T>;
    static SmemOptIn opt_in;
    const cudaError_t opted = opt_in(kernel, smem);
    if (opted != cudaSuccess) return opted;
    const int grid = (B + 32 / T - 1) / (32 / T);
    kernel<<<grid, 32, smem, stream>>>(tgt, qual, win, opn, ext, mask, prior,
                                       out, B, R, W, nuc_prior);
    return cudaGetLastError();
  }
}

template <int D, bool WAVE>
cudaError_t launch_t(int threads, const int* tgt, const int* qual,
                     const int* win, const int* opn, const int* ext,
                     const int* mask, const int* prior, int* out, int B, int R,
                     int W, int nuc_prior, cudaStream_t s) {
#define PAIRHMM_T(T_)                                                   \
  case T_:                                                              \
    return launch<D, T_, WAVE>(tgt, qual, win, opn, ext, mask, prior,  \
                               out, B, R, W, nuc_prior, s);
  switch (threads) {
    PAIRHMM_T(1)
    PAIRHMM_T(2)
    PAIRHMM_T(4)
    PAIRHMM_T(8)
    PAIRHMM_T(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAIRHMM_T
}

template <int D>
cudaError_t launch_d(int threads, int wave, const int* tgt, const int* qual,
                     const int* win, const int* opn, const int* ext,
                     const int* mask, const int* prior, int* out, int B, int R,
                     int W, int nuc_prior, cudaStream_t s) {
#define PAIRHMM_ARGS \
  threads, tgt, qual, win, opn, ext, mask, prior, out, B, R, W, nuc_prior, s
  return wave ? launch_t<D, true>(PAIRHMM_ARGS)
              : launch_t<D, false>(PAIRHMM_ARGS);
#undef PAIRHMM_ARGS
}

template <int D>
int smem_d(int threads, int wave) {
#define PAIRHMM_S(T_)                                                     \
  case T_:                                                                \
    if (wave) {                                                           \
      if constexpr (Variant<D, T_, true>::valid)                          \
        return (int)Variant<D, T_, true>::Rings::BYTES;                   \
      return -1;                                                          \
    }                                                                     \
    return (int)Variant<D, T_, false>::Rings::BYTES;
  switch (threads) {
    PAIRHMM_S(1)
    PAIRHMM_S(2)
    PAIRHMM_S(4)
    PAIRHMM_S(8)
    PAIRHMM_S(16)
    default:
      return -1;
  }
#undef PAIRHMM_S
}

}  // namespace

// Plain C entry point for ctypes. Tracks are int32 device pointers in
// batch-major layout: tgt/qual (B, R), the window tracks (B, W) with
// W = R + 2*pad - 1, each row contiguous (any alignment). `threads` is T,
// threads a pair (1, 2, 4, 8 or 16, at most D); `wave` picks the wavefront
// schedule (T >= 2 and D/T >= 2) over the split chain. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int pairhmm_launch(const int* tgt, const int* qual, const int* win,
                              const int* opn, const int* ext, const int* mask,
                              const int* prior, int* out, int B, int R, int W,
                              int pad, int nuc_prior, int threads, int wave,
                              void* stream) {
  if (B <= 0 || R <= 0 || W != R + 2 * pad - 1 || threads > 2 * pad)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PAIRHMM_ARGS                                                  \
  threads, wave, tgt, qual, win, opn, ext, mask, prior, out, B, R, W, \
      nuc_prior, s
  switch (pad) {
    case 8:
      return (int)launch_d<16>(PAIRHMM_ARGS);
    case 16:
      return (int)launch_d<32>(PAIRHMM_ARGS);
    case 32:
      return (int)launch_d<64>(PAIRHMM_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PAIRHMM_ARGS
}

// Dynamic shared memory of one block (bytes) at this pad, T and schedule, or
// -1 where there is no such variant.
extern "C" int pairhmm_smem_bytes(int pad, int threads, int wave) {
  if (threads > 2 * pad) return -1;
  switch (pad) {
    case 8:
      return smem_d<16>(threads, wave);
    case 16:
      return smem_d<32>(threads, wave);
    case 32:
      return smem_d<64>(threads, wave);
    default:
      return -1;
  }
}
