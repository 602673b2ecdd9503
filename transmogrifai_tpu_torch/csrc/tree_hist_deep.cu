// tree_hist_deep — the histograms of one deep tree level in one pass over
// each lane's rows, added straight into the [K, P, D, NB, S] histogram in
// device memory, plus the per-node totals.
//
// Replaces (JAX): transmogrifai_tpu/models/trees.py:_fit_tree_unrolled's
// segment-sum branch (:520-531, one segment_sum per statistic over
// node*NB + bin ids) and its node_stats segment_sum (:463-466), which the
// unrolled fit takes once a level has more than 128 nodes.  tree_hist.cu
// keeps a level's histogram in shared memory, which holds ~130 nodes at
// S = 3; a deeper level (2048 nodes at depth 12: 22 MB a lane) would need
// 16 passes over the rows there, so this kernel passes once and adds into
// device memory.
//
// Design: a warp takes 32 consecutive rows of one lane (grid y); each of
// its threads loads one row's node id and statistics (coalesced).  Rows
// outside the level or with all-zero statistics (out-of-bag, held out) are
// dropped there by a ballot, so they cost one load and no atomics: adding
// zero changes no sum, so this is exact.  The warp then walks its live rows
// one by one, shuffling each row's node and statistics to every thread:
// thread d adds the row's S statistics into the cell of feature d
// (d = lane, lane + 32, ...) with f32 atomics into device memory, so one
// warp instruction touches up to 32 distinct cells.  With a node mask
// ([K, P, D] bytes, each node's drawn feature subset) features outside a
// node's subset are skipped and their cells stay zero (the split search
// never reads them); thread 0 adds the row into its node's totals whatever
// the mask.  Atomics make the f32 sums order-dependent run to run.  All
// index arithmetic is 64-bit: at 600 lanes x 2048 nodes the histogram has
// 3.3e9 cells.
//
// Bound: device-memory bytes.  Per lane and level it must read each row's
// node id and statistics (4N + 4SN), the bin bytes of the live rows' kept
// features, and write the histogram (4*P*D*NB*S: 22 MB a lane at P = 2048,
// D = 28, NB = 32, S = 3).
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_S 5

__global__ void tree_hist_deep_kernel(const int8_t* __restrict__ B,
                                      const int32_t* __restrict__ row_node,
                                      const float* __restrict__ stats,
                                      const uint8_t* __restrict__ node_mask,
                                      float* __restrict__ hist,
                                      float* __restrict__ totals,
                                      long long N, int D, int NB, int S,
                                      int offset, int P, int with_hist) {
  const long long k = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int32_t* rn = row_node + k * N;
  const float* sk = stats + k * N * S;
  const uint8_t* nm = node_mask ? node_mask + k * P * D : nullptr;
  float* hk = hist + k * P * D * NB * S;
  float* tk = totals + k * P * S;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long base = warp * 32; base < N; base += n_warps * 32) {
    const long long n = base + lane;
    int p = -1;
    float s[MAX_S];
    bool live = false;
#pragma unroll
    for (int j = 0; j < MAX_S; ++j) s[j] = 0.f;
    if (n < N) {
      p = rn[n] - offset;
      if (p >= 0 && p < P) {
#pragma unroll
        for (int j = 0; j < MAX_S; ++j)
          if (j < S) {
            s[j] = sk[n * S + j];
            live |= s[j] != 0.f;
          }
      }
    }
    unsigned todo = __ballot_sync(0xffffffffu, live);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const long long pr = __shfl_sync(0xffffffffu, p, src);
      float sr[MAX_S];
#pragma unroll
      for (int j = 0; j < MAX_S; ++j) sr[j] = __shfl_sync(0xffffffffu, s[j], src);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < MAX_S; ++j)
          if (j < S) atomicAdd(tk + pr * S + j, sr[j]);
      }
      if (!with_hist) continue;
      const long long nr = base + src;
      const uint8_t* m = nm ? nm + pr * D : nullptr;
      for (int d = lane; d < D; d += 32) {
        if (m && !m[d]) continue;
        const long long b = B[nr * D + d];
        float* h = hk + ((pr * D + d) * NB + b) * S;
#pragma unroll
        for (int j = 0; j < MAX_S; ++j)
          if (j < S) atomicAdd(h + j, sr[j]);
      }
    }
  }
}

extern "C" int tree_hist_deep_launch(const void* B, const void* row_node,
                                     const void* stats, const void* node_mask,
                                     void* hist, void* totals, long long N,
                                     int D, int NB, int S, int K, int offset,
                                     int P, int with_hist, int grid_x,
                                     void* stream) {
  if (S < 1 || S > MAX_S || K > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(grid_x, K);
  tree_hist_deep_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)B, (const int32_t*)row_node, (const float*)stats,
      (const uint8_t*)node_mask, (float*)hist, (float*)totals, N, D, NB, S,
      offset, P, with_hist);
  return (int)cudaGetLastError();
}
