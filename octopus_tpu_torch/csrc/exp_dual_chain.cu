// Experiment dual_chain on Hopper, sm_90a: K independent pairs a thread.
//
// Replaces experiments/dual_chain.py's TPU kernel (`scores_dual`,
// `_kernel_dual`, pl.pallas_call at :115), which runs K = 2 or 4 chains of
// v9's banded Viterbi row recurrence over separate 128-lane pair groups in
// one grid step, to ask whether the TPU co-issues the ops of independent
// chains. Its plain version is pairhmm_batch.pairhmm_scores_plain on the
// transposed tracks (kernel_experiments/dual_chain.py).
//
// The same question on this card: one thread carries K pairs and
// interleaves their chains (instruction-level parallelism), everything else
// as csrc/pairhmm.cu's one thread a pair (T = 1): the block's rows staged
// in shared-memory rings by cp.async, M, I and D in registers, the deletion
// chain in the same pass, DPX min-plus forms, #pragma unroll 2 on the rows
// (csrc/exp_rows.cuh). K = 1 is the same code's one-pair baseline.
//
// What bounds it: the function is #1's, int32 operations (OPS_PER_CELL in
// pairhmm_batch.py). A ring row costs 768 bytes of shared memory a pair, so
// an SM holds ~295 pairs whatever K is: K trades warps (latency hiding across
// warps, the four schedulers of an SM) for independent chains in one
// thread, and K = 4 leaves two warps an SM. Registers: 48 a pair for
// M, I, D.
//
// Exactness: the same integers as csrc/pairhmm.cu at T = 1 (INF = 1<<29,
// no sum wraps, no saturating form).

#include "exp_rows.cuh"

using namespace exp_rows;

// Plain C entry point for ctypes: kernel-layout int32 device pointers, tgt
// and qual (R, B), the window tracks (W, B), W = R + 15; B % (32 K) == 0
// (the wrapper asks for B % (128 K), the experiment's own rule); pad 8; K
// in 1, 2, 4. Returns the cudaError_t of the launch (0 = success).
extern "C" int exp_dual_launch(const int* tgt, const int* qual, const int* win,
                               const int* opn, const int* ext, const int* mask,
                               const int* prior, int* out, int B, int R, int W,
                               int pad, int nuc_prior, int K, void* stream) {
  if (!shape_ok(B, R, W, pad)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define EXP_ARGS tgt, qual, win, opn, ext, mask, prior, out, B, R, W, nuc_prior, s
  switch (K) {
    case 1:
      return (int)launch_v9_rows<1, 32, UNROLL2>(EXP_ARGS);
    case 2:
      return (int)launch_v9_rows<2, 32, UNROLL2>(EXP_ARGS);
    case 4:
      return (int)launch_v9_rows<4, 32, UNROLL2>(EXP_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef EXP_ARGS
}

// out = {blocks an SM, threads a block, shared memory a block, pairs a
// block} of exp_dual_launch's kernel for K.
extern "C" int exp_dual_occupancy(int K, int* out) {
  switch (K) {
    case 1:
      return (int)occupancy_v9_rows<1, 32, UNROLL2>(out);
    case 2:
      return (int)occupancy_v9_rows<2, 32, UNROLL2>(out);
    case 4:
      return (int)occupancy_v9_rows<4, 32, UNROLL2>(out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
