// Experiment v13_unroll2 on Hopper, sm_90a: two rows a loop iteration.
//
// Replaces experiments/v13_unroll2.py's TPU kernel (`scores_v13`,
// `_kernel_v13`, pl.pallas_call at :123): v12's K = 4 (or 6) interleaved
// chains with two rows a fori_loop iteration and an odd last row peeled,
// to halve the loop's scalar bookkeeping. Its plain version is
// pairhmm_batch.pairhmm_scores_plain on the transposed tracks
// (kernel_experiments/v13_unroll2.py).
//
// The Hopper design (SHARED2 in csrc/exp_rows.cuh, the default): what two
// rows an iteration can save on this card is loads, not bookkeeping. Row
// y+1's diagonal k reads window position y+k, which is row y's diagonal
// k+1, so one pass over the 17 positions y-1 .. y+15 scores both rows:
// five shared-memory loads a position serve two cells, 85 a row pair for
// 32 cells against 160 (and the loop's counter and branch once a pair),
// where ptxas keeps the values in registers (chip_smoke.py counts the
// row loop's LDS in the SASS).
// One or two pairs a thread (K = 1, 2) over csrc/exp_rows.cuh's rings, as
// dual_chain K1/K2, so an SM holds 9 or 4-5 warps. The odd last row of a
// read runs alone. The experiment's K keeps only its batch rule (B a
// multiple of 128 K): it no longer sets pairs a thread.
//
// The first port stays as named variants: the K-pairs-a-thread kernel of
// dual_chain with the row loop written two rows an iteration (TWO_ROWS,
// "K4x2", "K6x2") or one row under #pragma unroll 1 (ONE_ROW, "K4x1",
// "K6x1"); K = 4 and 6 take 96 and 144 KB of shared memory a block of 32
// lanes, one or two warps an SM.
//
// What bounds it: #1's function, int32 operations (OPS_PER_CELL in
// pairhmm_batch.py); the loads a cell are what the design removes.
//
// Exactness: the same integers as csrc/pairhmm.cu at T = 1 (INF = 1<<29,
// opn and ext below 2^22, no sum wraps).

#include "exp_rows.cuh"

using namespace exp_rows;

// Plain C entry point for ctypes: as exp_dual_launch, with `schedule` a
// Schedule of csrc/exp_rows.cuh: SHARED2 (K in 1, 2), TWO_ROWS or ONE_ROW
// (K in 4, 6). B % (32 K) == 0.
extern "C" int exp_v13_launch(const int* tgt, const int* qual, const int* win,
                              const int* opn, const int* ext, const int* mask,
                              const int* prior, int* out, int B, int R, int W,
                              int pad, int nuc_prior, int K, int schedule,
                              void* stream) {
  if (!shape_ok(B, R, W, pad)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define EXP_ARGS tgt, qual, win, opn, ext, mask, prior, out, B, R, W, nuc_prior, s
  if (schedule == SHARED2) {
    if (K == 1) return (int)launch_v9_rows<1, 32, SHARED2>(EXP_ARGS);
    if (K == 2) return (int)launch_v9_rows<2, 32, SHARED2>(EXP_ARGS);
  } else if (schedule == TWO_ROWS) {
    if (K == 4) return (int)launch_v9_rows<4, 32, TWO_ROWS>(EXP_ARGS);
    if (K == 6) return (int)launch_v9_rows<6, 32, TWO_ROWS>(EXP_ARGS);
  } else if (schedule == ONE_ROW) {
    if (K == 4) return (int)launch_v9_rows<4, 32, ONE_ROW>(EXP_ARGS);
    if (K == 6) return (int)launch_v9_rows<6, 32, ONE_ROW>(EXP_ARGS);
  }
  return (int)cudaErrorInvalidValue;
#undef EXP_ARGS
}

// out = {blocks an SM, threads a block, shared memory a block, pairs a
// block} of the variant exp_v13_launch runs for (K, schedule).
extern "C" int exp_v13_occupancy(int K, int schedule, int* out) {
  if (schedule == SHARED2) {
    if (K == 1) return (int)occupancy_v9_rows<1, 32, SHARED2>(out);
    if (K == 2) return (int)occupancy_v9_rows<2, 32, SHARED2>(out);
  } else if (schedule == TWO_ROWS) {
    if (K == 4) return (int)occupancy_v9_rows<4, 32, TWO_ROWS>(out);
    if (K == 6) return (int)occupancy_v9_rows<6, 32, TWO_ROWS>(out);
  } else if (schedule == ONE_ROW) {
    if (K == 4) return (int)occupancy_v9_rows<4, 32, ONE_ROW>(out);
    if (K == 6) return (int)occupancy_v9_rows<6, 32, ONE_ROW>(out);
  }
  return (int)cudaErrorInvalidValue;
}
