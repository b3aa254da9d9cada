// Experiment v11_kernel on Hopper, sm_90a: the band across a warp's lanes,
// window tracks slid by shuffles.
//
// Replaces experiments/v11_kernel.py's TPU kernel (`scores_v11`,
// `_kernel_v11`, pl.pallas_call at :112), which keeps the six window
// tracks (win, mask, prior, opn, ext, pre = cumsum(ext)) in carried
// registers and slides them a row at a time, one (1, B) row load a track a
// row instead of a (D, B) window, to cut the kernel's load traffic ~16x.
// Its plain version is pairhmm_batch.pairhmm_scores_plain on the
// transposed tracks (kernel_experiments/v11_kernel.py); the wrapper makes
// pre with torch's cumsum, as XLA made it outside the Pallas kernel.
//
// The same lever on this card: lane d of a 16-lane group holds diagonal d
// of one pair (two pairs a warp), its M, I, D and the six window values at
// j = y-1+d in registers. Each row every window value moves one lane down
// (__shfl_down_sync) and only the group's edge lane loads the new row's
// value, once a track, from device memory through L1 (prefetched a row
// ahead). v9's arithmetic runs lane-parallel: the insertion's diagonal
// above and the deletion open's diagonal below are shuffles, and the
// deletion chain is min_scan(bv - pre) + pre with a 4-step shuffle scan, as
// the TPU's _min_scan. No shared memory.
//
// What bounds it: #1's function, int32 operations; but a cell here also
// costs 13 shuffles (6 slides, 2 + 1 neighbours, 4 scan steps) and the
// scan's selects, against #1's 5 shared-memory loads a cell, so the
// shuffle pipe, not the INT32 lanes, is expected to bind.
//
// Exactness: the same integers as pairhmm_batch.pairhmm_scores_plain
// (INF = 1<<29; bv - pre and the scan stay in int32; _min_scan's INF fill
// kept, so a lane below the step takes min(u, INF) as on the TPU).

#include "pairhmm_stage.cuh"

using namespace pairhmm;

namespace {

constexpr int D = 16;  // band of pad 8: two pairs a warp

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
cudaError_t launch(const int* const* t, int* out, int B, int R, int nuc_prior,
                   cudaStream_t stream) {
  constexpr int pairs = 128 * BLK / D;
  if (B % pairs) return cudaErrorInvalidValue;
  v11_kernel<BLK><<<B / pairs, 128 * BLK, 0, stream>>>(
      t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], out, B, R, nuc_prior);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes: kernel-layout int32 device pointers tgt,
// qual (R, B), win, opn, ext, mask, prior, pre (W, B), W = R + 15; pad 8;
// blk in 1, 2 (blocks of 128 * blk threads, 8 * blk pairs); B % (8 blk)
// == 0 (the wrapper asks for B % (128 blk)). Returns the cudaError_t.
extern "C" int exp_v11_launch(const int* tgt, const int* qual, const int* win,
                              const int* opn, const int* ext, const int* mask,
                              const int* prior, const int* pre, int* out,
                              int B, int R, int W, int pad, int nuc_prior,
                              int blk, void* stream) {
  if (B <= 0 || R <= 0 || pad != 8 || W != R + D - 1)
    return (int)cudaErrorInvalidValue;
  const int* t[8] = {tgt, qual, win, opn, ext, mask, prior, pre};
  cudaStream_t s = (cudaStream_t)stream;
  switch (blk) {
    case 1:
      return (int)launch<1>(t, out, B, R, nuc_prior, s);
    case 2:
      return (int)launch<2>(t, out, B, R, nuc_prior, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
