// Banded pair-HMM (integer-phred Viterbi) over a precomputed match-cost
// tensor, for Hopper, sm_90a.
//
// Replaces the reference package's TPU kernel #4,
// octopus_tpu/core/likelihood/pairhmm_batch.py:
//   pairhmm_scores_pallas_v2 / _pallas_kernel_v2
// which runs the row wavefront over an (R*D, B) match-cost tensor that XLA
// builds outside the kernel (_match_cost_tensor). Here the port's torch
// match_cost_tensor builds it outside the kernel in the same way, and the
// kernel reads it with the opn and ext tracks. Its plain twin is
// pairhmm_scores_cost_plain in octopus_tpu_torch/core/likelihood/
// pairhmm_batch.py (with threads=T it follows this kernel's split of the
// deletion chain); the two agree bit for bit.
//
// Semantics (pair b, D = 2*pad diagonals, rows y = 1..R, lane d of row y
// pairs read base y-1 with window base j = y-1+d):
//   M'd  = cm[(y-1)*D + d] + min(Md, Id, Dd)
//   I'd  = nuc_prior + min(Mg[d+1] + opn[j], I[d+1] + ext[j])  (lane D: INF)
//   bv_d = min(M'[d-1], I'[d-1]) + opn[j]                       (lane -1: INF)
//   D'd  = min(bv_d, D'[d-1] + ext[j])                          (D'[-1] = INF)
// Mg is the parity-masked M0 on row 1 (0 at odd d, INF at even d) and M
// afterwards; row 0's deletions come from opn/ext shifted down one lane.
//
// What bounds it: bytes. cm is R*D int32 a pair, 98% of what the kernel
// reads (opn/ext are 2W words a pair), against 8 int32 ops a cell (the match
// cost ran when cm was built): device memory at 3.35 TB/s is the limit, and
// the kernel must keep enough of cm in flight to reach it, on a card of 132
// SMs whether the launch is 4,096 pairs of 2,000 rows or a few hundred of
// 160.
//
// Design.
// - T threads a pair (T = 1 .. 16, K = D/T <= 16 diagonals a thread), the
//   split chain of csrc/pairhmm.cu: each thread runs the deletion chain over
//   its K diagonals, a log2(T)-step min-plus carry by warp shuffles composes
//   the segments (carry_segments), and the up-neighbour's M and I come from
//   one shuffle. So a launch of few pairs still fills the card, and a
//   thread keeps 3K + K ints of state: no band spills.
// - A warp scores P = 32/T adjacent pairs and stages their tracks itself
//   (no block barrier; a block is four independent warps). cm goes into a
//   ring of S = 4 chunks of C = 16/K rows by cp.async, three chunks in
//   flight while one is read, 16-byte copies where the rows allow it (B a
//   multiple of 4 and cm 16-byte aligned; 8-byte at P = 2), 4-byte
//   otherwise. A chunk row d of a pair lands at [k][t][pair] (d = t*K + k),
//   so the 32 lanes of a warp read 32 banks. opn/ext land in rings of RW
//   window words at [word][pair], each word loaded once, at a pitch chosen
//   so that the warp's reads meet as few banks twice as the band allows.
// - DPX: min(a + b, c) and min(a, b, c) as __viaddmin_s32 / __vimin3_s32.
//
// Exactness: INF = 1<<29; every intermediate is a bv (at most 2*INF + opn)
// or INF plus a sum of at most D ext values, below 2^31 for opn and ext
// below 2^22, so no int32 sum wraps (csrc/pairhmm.cu's argument).

#include <stdint.h>

#include "pairhmm_stage.cuh"

namespace {

using namespace pairhmm;

constexpr int WARPS = 4;   // warps a block, each on its own pairs
constexpr int STAGES = 4;  // chunks of cm in the ring

__host__ __device__ constexpr int prev(int k) { return k > 0 ? k - 1 : 0; }
template <int K>
__host__ __device__ constexpr int next(int k) { return k + 1 < K ? k + 1 : k; }

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// The most lanes of a warp that read one bank at once when thread t of
// pair p reads window word j0 + t*K (the same k) at [word][pair], pitch PO.
template <int T, int K, int P>
__host__ __device__ constexpr int window_conflicts(int pitch) {
  int worst = 0;
  for (int bank = 0; bank < 32; ++bank) {
    int n = 0;
    for (int t = 0; t < T; ++t)
      for (int p = 0; p < P; ++p)
        if ((t * K * pitch + p) % 32 == bank) ++n;
    worst = n > worst ? n : worst;
  }
  return worst;
}

template <int T, int K, int P>
__host__ __device__ constexpr int window_pitch() {
  int best = P, best_n = window_conflicts<T, K, P>(P);
  for (int pitch = P + 1; pitch < P + 64; ++pitch) {
    const int n = window_conflicts<T, K, P>(pitch);
    if (n < best_n) {
      best = pitch;
      best_n = n;
    }
  }
  return best;
}

template <int D, int T>
struct Geometry {
  static constexpr bool valid = T <= D && D / T <= 16;
  static constexpr int K = D / T;                 // diagonals a thread
  static constexpr int P = 32 / T;                // pairs a warp
  static constexpr int C = K >= 16 ? 1 : 16 / K;  // rows a chunk
  static constexpr int CM_WORDS = C * D * P;      // one chunk of cm, 2 KB
  // live window words: the chunk being read and the S-1 ahead of it
  static constexpr int RW = pow2_at_least(STAGES * C + D - 1);
  static constexpr int PO = window_pitch<T, K, P>();
  static constexpr int WIN_WORDS = RW * PO;
  static constexpr int WARP_WORDS =
      (STAGES * CM_WORDS + 2 * WIN_WORDS + 3) / 4 * 4;  // 16-byte multiple
  static constexpr size_t BYTES = (size_t)WARPS * WARP_WORDS * sizeof(int);
  static constexpr int V = P < 4 ? P : 4;  // words a vector copy
};

template <int BYTES>
__device__ __forceinline__ void cp_async_vec(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else if constexpr (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    cp_async4(dst, src);
  }
}

// Chunk c's copies (rows c*C+1 .. c*C+C) for the warp's nvalid pairs from
// `first` on, as one commit group (empty past the last row): its cm rows
// into ring slot c % STAGES, its window words [cC+D-1, cC+C+D-1) (chunk 0
// also [0, D-1)) into the opn/ext rings.
template <int D, int T>
__device__ __forceinline__ void stage(int* ring, int* so, int* se, int c,
                                      const int* __restrict__ cm,
                                      const int* __restrict__ opn,
                                      const int* __restrict__ ext, int B,
                                      int R, int W, int first, int nvalid,
                                      bool vec, int lane) {
  using G = Geometry<D, T>;
  constexpr int K = G::K, P = G::P, C = G::C;
  if (c * C < R) {
    int* dst = ring + (c % STAGES) * G::CM_WORDS;
    const int rows = (min((c + 1) * C, R) - c * C) * D;
    const size_t row0 = (size_t)c * C * D;
    if (vec) {
      constexpr int V = G::V, NV = P / V;
      for (int i = lane; i < rows * NV; i += 32) {
        const int rr = i / NV, v = i % NV;
        const int r = rr / D, d = rr % D;
        const int srow = r * D + (d % K) * T + d / K;
        cp_async_vec<V * 4>(dst + srow * P + v * V,
                            cm + (row0 + rr) * B + first + v * V);
      }
    } else {
      for (int i = lane; i < rows * nvalid; i += 32) {
        const int rr = i / nvalid, pp = i % nvalid;
        const int r = rr / D, d = rr % D;
        const int srow = r * D + (d % K) * T + d / K;
        cp_async4(dst + srow * P + pp, cm + (row0 + rr) * B + first + pp);
      }
    }
    const int j_lo = (c == 0) ? 0 : c * C + D - 1;
    const int j_hi = min((c + 1) * C + D - 1, W);
    for (int i = lane; i < (j_hi - j_lo) * nvalid; i += 32) {
      const int j = j_lo + i / nvalid, pp = i % nvalid;
      const int at = (j & (G::RW - 1)) * G::PO + pp;
      const size_t from = (size_t)j * B + first + pp;
      cp_async4(so + at, opn + from);
      cp_async4(se + at, ext + from);
    }
  }
  cp_async_commit();
}

// T > 1: lb[k] holds the deletion chain of this thread's segment from its
// first diagonal on without input, le[k] the segment's ext sum up to k.
// Composes the segments' min-plus maps across the T threads and leaves in
// lb[k] the band's chain value, fed INF before diagonal 0 (csrc/pairhmm.cu).
template <int K, int T>
__device__ __forceinline__ void carry_segments(int (&lb)[K],
                                               const int (&le)[K], int t) {
  int b = lb[K - 1], s = le[K - 1];
#pragma unroll
  for (int step = 1; step < T; step <<= 1) {
    const int bp = __shfl_up_sync(FULL, b, step, T);
    const int sp = __shfl_up_sync(FULL, s, step, T);
    if (t >= step) {
      b = addmin(bp, s, b);
      s += sp;
    }
  }
  const int end = addmin(INF, s, b);
  int x = __shfl_up_sync(FULL, end, 1, T);
  if (t == 0) x = INF;
#pragma unroll
  for (int k = 0; k < K; ++k) lb[k] = addmin(x, le[k], lb[k]);
}

template <int D, int T>
__global__ void __launch_bounds__(32 * WARPS)
pairhmm_cost_kernel(const int* __restrict__ cm, const int* __restrict__ opn,
                    const int* __restrict__ ext, int* __restrict__ out, int B,
                    int R, int W, int nuc_prior, int vec_ok) {
  using G = Geometry<D, T>;
  constexpr int K = G::K, P = G::P, C = G::C, RW = G::RW, PO = G::PO;
  extern __shared__ __align__(16) int smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = (blockIdx.x * WARPS + warp) * P;
  if (first >= B) return;  // a whole warp past the batch edge
  const int nvalid = min(P, B - first);
  const int p_own = lane / T;
  const int t = lane % T;
  // a thread past the batch edge repeats the warp's last pair (it must take
  // part in the shuffles) and stores nothing
  const int p = min(p_own, nvalid - 1);
  const int d0 = t * K;
  int* ring = smem + warp * G::WARP_WORDS;
  int* so = ring + STAGES * G::CM_WORDS;
  int* se = so + G::WIN_WORDS;
  const bool vec = vec_ok && nvalid == P;
  const int* so_p = so + p;
  const int* se_p = se + p;

  for (int c = 0; c < STAGES - 1; ++c)
    stage<D, T>(ring, so, se, c, cm, opn, ext, B, R, W, first, nvalid, vec,
                lane);

  int M[K], I[K], Dl[K];
  const int nchunks = (R + C - 1) / C;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed
    __syncwarp();                 // and every lane is done with chunk c-1
    stage<D, T>(ring, so, se, c + STAGES - 1, cm, opn, ext, B, R, W, first,
                nvalid, vec, lane);
    if (c == 0) {
      // row 0: M = 0, I = INF; deletions from the parity-masked M0 with opn
      // and ext shifted down one diagonal (fills INF and 0)
      int le[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = d0 + k;
        const int m_gap_prev = (d == 0) ? INF : (((d - 1) & 1) ? 0 : INF);
        const int jd = ((d - 1) & (RW - 1)) * PO;  // read at d >= 1
        const int bv = m_gap_prev + ((d == 0) ? INF : so_p[jd]);
        const int e = (d == 0) ? 0 : se_p[jd];
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
    const int* cmc = ring + (c % STAGES) * G::CM_WORDS + t * P + p;
    const int y_end = min((c + 1) * C, R);
    for (int y = c * C + 1; y <= y_end; ++y) {
      const int* cm_row = cmc + (y - 1 - c * C) * K * 32;
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
      int o[K], e[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = ((y - 1 + d0 + k) & (RW - 1)) * PO;
        o[k] = so_p[j];
        e[k] = se_p[j];
      }
      // pass 1: M' and I' (diagonal k reads the old M, I at k+1, so k
      // rises); T = 1 runs the deletion chain in the same pass
      int mi_prev = INF, d_prev = INF;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int cost = cm_row[k * 32];
        int m_up, i_up;
        if (k + 1 < K) {
          m_up = row1 ? (((d0 + k + 1) & 1) ? 0 : INF) : M[next<K>(k)];
          i_up = I[next<K>(k)];
        } else {
          m_up = m_next;
          i_up = i_next;
        }
        const int mn = cost + min3(M[k], I[k], Dl[k]);
        const int in = nuc_prior + addmin(i_up, e[k], m_up + o[k]);
        M[k] = mn;
        I[k] = in;
        if constexpr (T == 1) {
          d_prev = addmin(d_prev, e[k], mi_prev + o[k]);
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
          const int bv =
              ((k == 0) ? mi_prev : min(M[prev(k)], I[prev(k)])) + o[k];
          Dl[k] = (k == 0) ? bv : addmin(Dl[prev(k)], e[k], bv);
          le[k] = (k == 0) ? e[k] : le[prev(k)] + e[k];
        }
        carry_segments<K, T>(Dl, le, t);
      }
    }
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

template <int D, int T>
cudaError_t launch(const int* cm, const int* opn, const int* ext, int* out,
                   int B, int R, int W, int nuc_prior, cudaStream_t stream) {
  if constexpr (!Geometry<D, T>::valid) {
    return cudaErrorInvalidValue;
  } else {
    using G = Geometry<D, T>;
    static SmemOptIn opt_in;
    const cudaError_t opted = opt_in(pairhmm_cost_kernel<D, T>, G::BYTES);
    if (opted != cudaSuccess) return opted;
    const int vec_ok = (reinterpret_cast<uintptr_t>(cm) % 16 == 0) && (B % 4 == 0);
    const int warps = (B + G::P - 1) / G::P;
    const int grid = (warps + WARPS - 1) / WARPS;
    pairhmm_cost_kernel<D, T><<<grid, 32 * WARPS, G::BYTES, stream>>>(
        cm, opn, ext, out, B, R, W, nuc_prior, vec_ok);
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t launch_t(int threads, const int* cm, const int* opn,
                     const int* ext, int* out, int B, int R, int W,
                     int nuc_prior, cudaStream_t s) {
#define PAIRHMM_COST_T(T_) \
  case T_:                 \
    return launch<D, T_>(cm, opn, ext, out, B, R, W, nuc_prior, s);
  switch (threads) {
    PAIRHMM_COST_T(1)
    PAIRHMM_COST_T(2)
    PAIRHMM_COST_T(4)
    PAIRHMM_COST_T(8)
    PAIRHMM_COST_T(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAIRHMM_COST_T
}

template <int D>
int smem_t(int threads) {
#define PAIRHMM_COST_S(T_)                                      \
  case T_:                                                      \
    return Geometry<D, T_>::valid ? (int)Geometry<D, T_>::BYTES \
                                  : -1;
  switch (threads) {
    PAIRHMM_COST_S(1)
    PAIRHMM_COST_S(2)
    PAIRHMM_COST_S(4)
    PAIRHMM_COST_S(8)
    PAIRHMM_COST_S(16)
    default:
      return -1;
  }
#undef PAIRHMM_COST_S
}

}  // namespace

// Plain C entry point for ctypes. cm is an int32 device pointer in (R*D, B)
// layout (row (y-1)*D + d pairs read base y-1 with window base y-1+d),
// opn/ext (W, B) with W = R + 2*pad - 1. `threads` is T, threads a pair
// (1, 2, 4, 8 or 16, with D/T <= 16). Returns the cudaError_t of the launch
// (0 = success).
extern "C" int pairhmm_cost_launch(const int* cm, const int* opn,
                                   const int* ext, int* out, int B, int R,
                                   int W, int pad, int nuc_prior, int threads,
                                   void* stream) {
  if (B <= 0 || R <= 0 || W != R + 2 * pad - 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pad) {
    case 8:
      return (int)launch_t<16>(threads, cm, opn, ext, out, B, R, W, nuc_prior, s);
    case 16:
      return (int)launch_t<32>(threads, cm, opn, ext, out, B, R, W, nuc_prior, s);
    case 32:
      return (int)launch_t<64>(threads, cm, opn, ext, out, B, R, W, nuc_prior, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block (bytes) at this pad and T, or -1 where
// there is no such variant.
extern "C" int pairhmm_cost_smem_bytes(int pad, int threads) {
  switch (pad) {
    case 8:
      return smem_t<16>(threads);
    case 16:
      return smem_t<32>(threads);
    case 32:
      return smem_t<64>(threads);
    default:
      return -1;
  }
}
