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
// The Hopper design (`regs`, csrc/exp_rows.cuh's RegWindows with the raw
// values in its slots): one thread a pair, as dual_chain K1, with the 16
// window values of each of the five window tracks in the thread's own
// registers. Row y's diagonal k reads window
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

#include "exp_rows.cuh"

using namespace pairhmm;

namespace {

constexpr int D = 16;  // band of pad 8: two pairs a warp in `shfl`

using exp_rows::NewRows;
using exp_rows::Tracks;

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

// A slot of the register window (exp_rows.cuh's RegWindows): the five
// raw window values of a position (win, mask, prior, opn, ext), v9's cell.
struct V9Slots {
  static constexpr int NV = 5;
  struct Carry {};

  __device__ __forceinline__ static void enter(int w, int m, int p, int o,
                                               int e, int, Carry&,
                                               int (&x)[NV]) {
    x[0] = w;
    x[1] = m;
    x[2] = p;
    x[3] = o;
    x[4] = e;
  }

  // row 0: M = 0, I = INF, deletions from the parity-masked M0 with opn
  // and ext shifted down one diagonal
  __device__ __forceinline__ static void row0(const int (&v)[NV][D],
                                              int (&M)[D], int (&I)[D],
                                              int (&Dl)[D]) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int m_gap_prev = (d == 0) ? INF : (((d - 1) & 1) ? 0 : INF);
      const int bv = m_gap_prev + ((d == 0) ? INF : v[3][d > 0 ? d - 1 : 0]);
      const int ed = (d == 0) ? 0 : v[4][d > 0 ? d - 1 : 0];
      Dl[d] = addmin(d == 0 ? INF : Dl[d > 0 ? d - 1 : 0], ed, bv);
      M[d] = 0;
      I[d] = INF;
    }
  }

  template <bool LAST>
  __device__ __forceinline__ static void cell(int t, int q,
                                              const int (&v)[NV][D], int sl,
                                              int m_up, int i_up,
                                              int nuc_prior, int& M, int& I,
                                              int& Dl, int& mi_prev,
                                              int& d_prev) {
    exp_rows::v9_cell(t, q, v[0][sl], v[1][sl], v[2][sl], v[3][sl],
                      v[4][sl], m_up, i_up, nuc_prior, M, I, Dl, mi_prev,
                      d_prev);
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
  exp_rows::regs_pairs<L, P, V9Slots>(g, smem, first, out);
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
