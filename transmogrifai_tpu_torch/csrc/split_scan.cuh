// split_scan.cuh — the bin prefix and first-max of the variance split
// kernel (tree_split_variance.cu; the gini split moved to split_level.cuh's
// layout) for up to 128 bins: a warp holds one feature's bins, lane l the Q consecutive bins
// l*Q .. l*Q+Q-1 (Q = 1 for NB <= 32, 2 for <= 64, 4 for <= 128).
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#define SPLIT_FULL 0xffffffffu

// The inclusive prefix over bins of M running sums, in place: v[q][m] holds
// bin lane*Q+q's value on entry and the sum over bins 0 .. lane*Q+q on exit.
// Q = 1 is the warp's shuffle scan alone; past 32 bins each lane first sums
// its own bins, then adds the scan of the lanes before it.
template <int Q, int M>
__device__ __forceinline__ void bin_prefix(float (&v)[Q][M], int lane) {
#pragma unroll
  for (int q = 1; q < Q; ++q)
#pragma unroll
    for (int m = 0; m < M; ++m) v[q][m] = __fadd_rn(v[q - 1][m], v[q][m]);
  float run[M];
#pragma unroll
  for (int m = 0; m < M; ++m) run[m] = v[Q - 1][m];
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float t = __shfl_up_sync(SPLIT_FULL, run[m], off);
      if (lane >= off) run[m] = __fadd_rn(run[m], t);
    }
  }
  if constexpr (Q == 1) {
#pragma unroll
    for (int m = 0; m < M; ++m) v[0][m] = run[m];
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float before = __shfl_up_sync(SPLIT_FULL, run[m], 1);
      if (lane > 0)
#pragma unroll
        for (int q = 0; q < Q; ++q) v[q][m] = __fadd_rn(before, v[q][m]);
    }
  }
}

// The first max over the warp's bins of gain[q] (bin lane*Q+q): the best
// gain and, on equal gains, the LOWEST bin, in lane 0.  All -inf: bin 0, as
// jnp.argmax returns.
template <int Q>
__device__ __forceinline__ void bin_argmax(const float (&gain)[Q], int lane,
                                           float& best, int& best_bin) {
  float g = gain[0];
  int b = lane * Q;
#pragma unroll
  for (int q = 1; q < Q; ++q)
    if (gain[q] > g) { g = gain[q]; b = lane * Q + q; }
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_down_sync(SPLIT_FULL, g, off);
    const int ob = __shfl_down_sync(SPLIT_FULL, b, off);
    if (og > g || (og == g && ob < b)) { g = og; b = ob; }
  }
  best = g;
  best_bin = g == -INFINITY ? 0 : b;
}

// Q for NB bins; 0 past 128
static inline int split_q(int NB) {
  return NB <= 32 ? 1 : NB <= 64 ? 2 : NB <= 128 ? 4 : 0;
}
