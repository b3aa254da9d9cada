// Shared-memory staging of pair-HMM tracks for csrc/pairhmm.cu and
// csrc/pairhmm_lanes.cu (Hopper, sm_90a).
//
// A block scores P pairs. Their tracks arrive in batch-major layout, tgt and
// qual (B, R) and the five window tracks (B, W), W = R + D - 1, and are
// copied into rings in dynamic shared memory by 4-byte cp.async, so any row
// length and any base offset is taken as it is (no pitch rule on the
// caller's tracks; 16-byte copies and TMA would need 16-byte aligned rows).
//
// Rows are staged in chunks of C rows. Chunk c brings tgt/qual words
// [cC, cC+C) and window words [cC+D-1, cC+C+D-1); chunk 0 also brings
// window words [0, D-1). Row y (1-based) reads tgt/qual word y-1 and window
// words y-1 .. y+D-2, so chunk c holds everything rows cC+1 .. cC+C need.
// Each chunk is one cp.async group, and two are in flight: the row loop
// waits for chunk c while chunk c+1 is still arriving, and stages chunk c+2
// once every thread has finished chunk c. So no row waits on device memory
// except the first chunk's.
//
// Ring sizes (powers of two, template parameters): a window ring holds
// RW >= 2C + D - 1 words. While chunk c is read, the live window words are
// [cC, cC+2C+D-1), so chunk c+2 lands on words below cC+C that no later row
// reads. tgt/qual rings hold RT >= 2C words, more where a reader lags rows
// behind the chunk it waits for (csrc/pairhmm.cu's wavefront). Small chunks
// (C = D/2, RW = 2D) keep a pair's rings small, so that many pairs fit on
// an SM when the batch fills the card; large chunks (C = 32, RW = 128) cost
// fewer chunk turns (a wait, a warp sync and the next chunk's copies) on a
// pair's chain of rows when one launch is a few hundred pairs. Pair p of
// track k starts at word (k*P + p) * pitch; the pitches are
// the kernels' choice (an odd pitch spreads P one-thread-per-pair readers
// over distinct banks).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace pairhmm {

constexpr int INF = 1 << 29;
constexpr int N_CODE = 4;
constexpr int N_SCORE = 2;
constexpr unsigned FULL = 0xffffffffu;

// window tracks in ring order; tgt and qual follow them
enum Track { WIN = 0, MASK = 1, PRIOR = 2, OPN = 3, EXT = 4, N_WINDOW = 5 };

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// min(a + b, c) and min(a, b, c): one DPX instruction each on sm_90
// (VIADDMNMX, VIMNMX3), plain int32 arithmetic. Never the _relu forms.
__device__ __forceinline__ int addmin(int a, int b, int c) {
  return __viaddmin_s32(a, b, c);
}

__device__ __forceinline__ int min3(int a, int b, int c) {
  return __vimin3_s32(a, b, c);
}

template <int D, int P, int C_, int RW_, int RT_, int WP, int TP>
struct Ring {
  static constexpr int C = C_;        // rows a chunk
  static constexpr int RW = RW_;      // window ring words
  static constexpr int RT = RT_;      // tgt/qual ring words
  static_assert((RW & (RW - 1)) == 0 && (RT & (RT - 1)) == 0,
                "rings of a power of two words");
  static_assert(RW >= 2 * C + D - 1, "window ring below two chunks and a band");
  static_assert(RT >= 2 * C, "tgt/qual ring below two chunks");
  static_assert(WP >= RW && TP >= RT, "pitch below ring size");
  static constexpr int TGT = N_WINDOW * P * WP;  // first tgt word
  static constexpr int QUAL = TGT + P * TP;      // first qual word
  static constexpr int WORDS = QUAL + P * TP;
  static constexpr size_t BYTES = WORDS * sizeof(int);

  __device__ __forceinline__ static int* window(int* s, int track, int p) {
    return s + (track * P + p) * WP;
  }
  __device__ __forceinline__ static int* tgt(int* s, int p) { return s + TGT + p * TP; }
  __device__ __forceinline__ static int* qual(int* s, int p) { return s + QUAL + p * TP; }

  // n words [j0, j0+n) of one (B, len) track for the block's nvalid pairs
  // from `first` on, into rings of `words` words at pitch `pitch`; words at
  // or past len are skipped
  template <int N>
  __device__ __forceinline__ static void copy(int* ring, int pitch, int words,
                              const int* __restrict__ g, int len, int j0,
                              int first, int nvalid) {
    for (int i = threadIdx.x; i < nvalid * N; i += blockDim.x) {
      const int p = i / N;
      const int j = j0 + i % N;
      if (j < len)
        cp_async4(ring + p * pitch + (j & (words - 1)),
                  g + (size_t)(first + p) * len + j);
    }
  }

  // start chunk c's copies (none past the last row), one commit group
  __device__ __forceinline__ static void stage(int* s, int c, const int* tgt_g,
                               const int* qual_g, const int* const* win_g,
                               int R, int W, int first, int nvalid) {
    if (c * C < R) {
#pragma unroll
      for (int k = 0; k < N_WINDOW; ++k) {
        if (c == 0)
          copy<D - 1>(window(s, k, 0), WP, RW, win_g[k], W, 0, first, nvalid);
        copy<C>(window(s, k, 0), WP, RW, win_g[k], W, c * C + D - 1, first,
                nvalid);
      }
      copy<C>(tgt(s, 0), TP, RT, tgt_g, R, c * C, first, nvalid);
      copy<C>(qual(s, 0), TP, RT, qual_g, R, c * C, first, nvalid);
    }
    cp_async_commit();
  }
};

// Opts one kernel into more than 48 KB of dynamic shared memory. The
// attribute holds for the current device only, so each device is opted in
// on the kernel's first launch there. One static SmemOptIn a kernel.
struct SmemOptIn {
  static constexpr int MAX_DEVICES = 64;
  std::atomic<bool> done[MAX_DEVICES] = {};

  template <typename Kernel>
  cudaError_t operator()(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const bool cached = dev >= 0 && dev < MAX_DEVICES;
    if (cached && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess && cached)
      done[dev].store(true, std::memory_order_release);
    return err;
  }
};

}  // namespace pairhmm
