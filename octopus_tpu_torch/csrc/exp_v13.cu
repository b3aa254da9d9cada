// Experiment v13_unroll2 on Hopper, sm_90a: two rows a loop iteration.
//
// Replaces experiments/v13_unroll2.py's TPU kernel (`scores_v13`,
// `_kernel_v13`, pl.pallas_call at :123): v12's K = 4 (or 6) interleaved
// chains with two rows a fori_loop iteration and an odd last row peeled,
// to halve the loop's scalar bookkeeping. Its plain version is
// pairhmm_batch.pairhmm_scores_plain on the transposed tracks
// (kernel_experiments/v13_unroll2.py).
//
// The same question on this card: csrc/exp_rows.cuh's K-pairs-a-thread
// kernel (as csrc/exp_dual_chain.cu) with the row loop written two rows an
// iteration (TWO_ROWS), against the same kernel under #pragma unroll 1
// (ONE_ROW). A row of 16 diagonals is ~250 instructions a pair and the
// loop's own are a counter, a compare and a branch, while two rows an
// iteration double the loop body's code (at K = 4, ~5,500 SASS
// instructions against ~2,900): what the lever trades is code size
// against bookkeeping. The chunk turn (a cp.async wait, a block barrier,
// the next chunk's copies) every 8 rows is outside both.
//
// What bounds it: #1's function, int32 operations. At K = 6 a block of 192
// pairs takes 144 KB of shared memory (one warp an SM) and the pairs'
// M, I and D take 288 registers: ptxas's spill report says what that
// costs.
//
// Exactness: the same integers as csrc/pairhmm.cu at T = 1.

#include "exp_rows.cuh"

using namespace exp_rows;

// Plain C entry point for ctypes: as exp_dual_launch, K in 4, 6;
// two_rows = 1 for two rows an iteration, 0 for one row under
// #pragma unroll 1.
extern "C" int exp_v13_launch(const int* tgt, const int* qual, const int* win,
                              const int* opn, const int* ext, const int* mask,
                              const int* prior, int* out, int B, int R, int W,
                              int pad, int nuc_prior, int K, int two_rows,
                              void* stream) {
  if (!shape_ok(B, R, W, pad)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define EXP_ARGS tgt, qual, win, opn, ext, mask, prior, out, B, R, W, nuc_prior, s
  if (K == 4)
    return two_rows ? (int)launch_v9_rows<4, 32, TWO_ROWS>(EXP_ARGS)
                    : (int)launch_v9_rows<4, 32, ONE_ROW>(EXP_ARGS);
  if (K == 6)
    return two_rows ? (int)launch_v9_rows<6, 32, TWO_ROWS>(EXP_ARGS)
                    : (int)launch_v9_rows<6, 32, ONE_ROW>(EXP_ARGS);
  return (int)cudaErrorInvalidValue;
#undef EXP_ARGS
}
