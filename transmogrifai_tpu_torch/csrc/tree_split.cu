// tree_split — best split per (lane, node) from a level's histograms.
//
// Replaces (JAX): the rest of transmogrifai_tpu/models/trees.py:
// _fit_tree_compact's scan_chunk body (:339-356) — cumsum over bins,
// _gain_xgb (:202-209), the `ok` mask, max/argmax over bins and then over
// feature chunks with strict `>` — and the leaf flag, threshold and
// _leaf_xgb leaf value that follow it (:358-364, :220-221).
//
// Design: one block per (node, lane); warp w takes features w, w+nwarps, ...
// and lane l holds bins l*Q .. l*Q+Q-1 (Q = ceil(NB/32), NB <= 127 as
// bin_data allows; split_scan.cuh), so the prefix over bins is each lane's
// running sum plus a warp shuffle scan of the lanes' totals, and the argmax
// over bins a walk of the lane's bins and a warp reduction that keeps the
// LOWEST bin on equal gain.  The features pass in chunks of `dc` (sized by
// the wrapper's split_plan, held in dynamic shared memory): after each chunk
// thread 0 walks the chunk's per-feature winners in feature order with a
// strict `>` against the running best, so equal gains resolve to the lowest
// feature and an earlier chunk wins a tie with a later one — the first-max
// rule of the JAX argmax over feature chunks (trees.py:352).  Any D runs.
//
// Bound: device-memory bytes — one read of the [K, P, D, NB, S] histogram
// (43 KB per lane at depth-3 levels) and a few bytes per node out; the
// launch itself dominates at these sizes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_scan.cuh"

template <int Q>
__global__ void tree_split_kernel(const float* __restrict__ hist,
                                  const float* __restrict__ totals,
                                  const uint8_t* __restrict__ fmask,
                                  const float* __restrict__ splits,
                                  const float* __restrict__ min_inst,
                                  const float* __restrict__ min_gain,
                                  const float* __restrict__ lam_k,
                                  float* __restrict__ out_gain,
                                  int32_t* __restrict__ out_feat,
                                  int32_t* __restrict__ out_bin,
                                  uint8_t* __restrict__ out_leaf,
                                  float* __restrict__ out_thr,
                                  float* __restrict__ out_value,
                                  int P, int D, int NB, int dc) {
  extern __shared__ float fg[];          // [dc] gains, then [dc] bins
  int* fb = (int*)(fg + dc);
  const int p = blockIdx.x, k = blockIdx.y;
  const int node = k * P + p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float lam = lam_k[k], mi = min_inst[k];
  const float pc = totals[node * 3 + 0];
  const float pg = totals[node * 3 + 1];
  const float ph = totals[node * 3 + 2];
  const float parent_score = pg * pg / (ph + lam);

  float best = -INFINITY;
  int bf = 0, bb = 0;
  for (int d0 = 0; d0 < D; d0 += dc) {
    const int dn = min(dc, D - d0);
    for (int dl = warp; dl < dn; dl += nwarps) {
      const int d = d0 + dl;
      const float* h = hist + ((long long)node * D + d) * NB * 3;
      float v[Q][3];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int b = lane * Q + q;
#pragma unroll
        for (int m = 0; m < 3; ++m) v[q][m] = b < NB ? h[b * 3 + m] : 0.f;
      }
      bin_prefix<Q, 3>(v, lane);               // inclusive, over bins
      float gq[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float c = v[q][0], g = v[q][1], hh = v[q][2];
        const float rc = pc - c, rg = pg - g, rh = ph - hh;
        const float gain = 0.5f * ((g * g / (hh + lam) + rg * rg / (rh + lam))
                                   - parent_score);
        const bool ok = lane * Q + q < NB - 1 && c >= mi && rc >= mi &&
                        fmask[d];
        gq[q] = ok ? gain : -INFINITY;
      }
      float gain;
      int bin;
      bin_argmax<Q>(gq, lane, gain, bin);
      if (lane == 0) {
        fg[dl] = gain;
        fb[dl] = bin;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int dl = 0; dl < dn; ++dl)
        if (fg[dl] > best) { best = fg[dl]; bf = d0 + dl; bb = fb[dl]; }
    // the next chunk reuses fg / fb; after the last, the other warps exit
    // without waiting for thread 0's walk
    if (d0 + dc < D) __syncthreads();
  }
  if (threadIdx.x == 0) {
    const bool leaf = !(isfinite(best) && best > min_gain[k]);
    const int cb = min(max(bb, 0), NB - 2);
    out_gain[node] = best;
    out_feat[node] = bf;
    out_bin[node] = bb;
    out_leaf[node] = leaf ? 1 : 0;
    out_thr[node] = splits[bf * (NB - 1) + cb];
    out_value[node] = -(pg / (ph + lam));
    (void)pc;
  }
}

extern "C" int tree_split_launch(const void* hist, const void* totals,
                                 const void* fmask, const void* splits,
                                 const void* min_inst, const void* min_gain,
                                 const void* lam, void* out_gain,
                                 void* out_feat, void* out_bin,
                                 void* out_leaf, void* out_thr,
                                 void* out_value, int K, int P, int D, int NB,
                                 int dc, int threads, void* stream) {
  if (NB > 127 || NB < 2 || dc < 1 || P > 65535 || K > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(P, K);
  const size_t smem = 2 * dc * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
#define SPLIT_ARGS                                                          \
  (const float*)hist, (const float*)totals, (const uint8_t*)fmask,          \
      (const float*)splits, (const float*)min_inst, (const float*)min_gain, \
      (const float*)lam, (float*)out_gain, (int32_t*)out_feat,              \
      (int32_t*)out_bin, (uint8_t*)out_leaf, (float*)out_thr,               \
      (float*)out_value, P, D, NB, dc
  switch (split_q(NB)) {
    case 1: tree_split_kernel<1><<<grid, threads, smem, s>>>(SPLIT_ARGS); break;
    case 2: tree_split_kernel<2><<<grid, threads, smem, s>>>(SPLIT_ARGS); break;
    default: tree_split_kernel<4><<<grid, threads, smem, s>>>(SPLIT_ARGS);
  }
#undef SPLIT_ARGS
  return (int)cudaGetLastError();
}
