// tree_split_variance — best variance (regression) split per (lane, node)
// from a level's histograms, over each node's own feature subset.
//
// Replaces (JAX): the variance case of transmogrifai_tpu/models/trees.py:
// _fit_tree_compact's scan_chunk body (:331-357) — cumsum over bins,
// _gain_variance (:186-191), the `ok` mask with the tree-level feature mask
// and the per-node subset drawn at :320-326, max/argmax over bins and then
// over feature chunks with strict `>` — and the leaf flag and threshold that
// follow it (:364-366); likewise the unrolled form's level body.  The
// node's leaf value (_leaf_variance, :212-213) is not computed here: the
// caller divides the node totals in torch.
//
// Statistics are S = 3 per row: (w, w*y, w*y^2).  Gain, in the f32 order of
// _gain_variance:
//   sse(s) = s_2 - s_1^2 / cnt,   cnt = max(s_0, 1e-12)
//   gain   = sse(parent) - sse(left) - sse(right),  right = parent - left
// written with __f*_rn intrinsics so that nvcc contracts nothing into an
// FMA and the kernel rounds as the plain PyTorch twin does.
//
// Design: as tree_split_gini.cu — one block per (node, lane); warp w takes
// features w, w+nwarps, ...; lane l holds bins l*Q .. l*Q+Q-1 (Q =
// ceil(NB/32), NB <= 127; split_scan.cuh), so the prefix over bins is each
// lane's running sum plus a warp shuffle scan of the three sums, and the
// argmax over bins a reduction that keeps the LOWEST bin on equal gain.  A feature
// outside the tree mask or the node's subset skips its histogram read
// (warp-uniform branch).  The features pass in chunks of `dc` (dynamic
// shared memory); after each chunk thread 0 walks its per-feature winners in
// feature order with a strict `>` against the running best, so equal gains
// resolve to the lowest feature and an earlier chunk wins ties — the
// first-max rule of the JAX argmax over feature chunks.  Any D runs.
//
// Bound: device-memory bytes — one read of the kept features' [NB, 3]
// histograms (at the RF regressor's level 11 of the default grid, ~300
// lanes x 2048 nodes x 5 of 16 features x 32 bins x 3 stats: ~1.2 GB) plus
// the node masks and a few bytes per node out.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_scan.cuh"

// sse of (count, sum, sum of squares) in _gain_variance's f32 order
__device__ __forceinline__ float sse(float c, float s1, float s2) {
  return __fsub_rn(s2, __fdiv_rn(__fmul_rn(s1, s1), fmaxf(c, 1e-12f)));
}

template <int Q>
__global__ void tree_split_variance_kernel(
    const float* __restrict__ hist, const float* __restrict__ totals,
    const uint8_t* __restrict__ fmask, const uint8_t* __restrict__ node_mask,
    const float* __restrict__ splits, const float* __restrict__ min_inst,
    const float* __restrict__ min_gain, float* __restrict__ out_gain,
    int32_t* __restrict__ out_feat, int32_t* __restrict__ out_bin,
    uint8_t* __restrict__ out_leaf, float* __restrict__ out_thr, int P, int D,
    int NB, int dc) {
  extern __shared__ float fg[];          // [dc] gains, then [dc] bins
  int* fb = (int*)(fg + dc);
  const int p = blockIdx.x, k = blockIdx.y;
  const long long node = (long long)k * P + p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float mi = min_inst[k];
  const float p0 = totals[node * 3], p1 = totals[node * 3 + 1],
              p2 = totals[node * 3 + 2];
  const float spar = sse(p0, p1, p2);
  const uint8_t* nm = node_mask ? node_mask + node * D : nullptr;

  float best = -INFINITY;
  int bf = 0, bb = 0;
  for (int d0 = 0; d0 < D; d0 += dc) {
    const int dn = min(dc, D - d0);
    for (int dl = warp; dl < dn; dl += nwarps) {
      const int d = d0 + dl;
      if (!fmask[d] || (nm != nullptr && !nm[d])) {
        if (lane == 0) { fg[dl] = -INFINITY; fb[dl] = 0; }
        continue;
      }
      const float* h = hist + (node * D + d) * NB * 3;
      float v[Q][3];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int b = lane * Q + q;
#pragma unroll
        for (int m = 0; m < 3; ++m) v[q][m] = b < NB ? h[b * 3 + m] : 0.f;
      }
      bin_prefix<Q, 3>(v, lane);               // the three running sums
      float gq[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float l0 = v[q][0], l1 = v[q][1], l2 = v[q][2];
        const float r0 = __fsub_rn(p0, l0), r1 = __fsub_rn(p1, l1),
                    r2 = __fsub_rn(p2, l2);
        const float gain = __fsub_rn(__fsub_rn(spar, sse(l0, l1, l2)),
                                     sse(r0, r1, r2));
        const bool ok = lane * Q + q < NB - 1 && l0 >= mi && r0 >= mi;
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
  }
}

extern "C" int tree_split_variance_launch(
    const void* hist, const void* totals, const void* fmask,
    const void* node_mask, const void* splits, const void* min_inst,
    const void* min_gain, void* out_gain, void* out_feat, void* out_bin,
    void* out_leaf, void* out_thr, int K, int P, int D, int NB, int dc,
    int threads, void* stream) {
  if (NB > 127 || NB < 2 || dc < 1 || P > 65535 || K > 65535 || P < 1 ||
      K < 1 || threads % 32 || threads < 32)
    return (int)cudaErrorInvalidValue;
  dim3 grid(P, K);
  const size_t smem = 2 * dc * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
#define SPLIT_ARGS                                                          \
  (const float*)hist, (const float*)totals, (const uint8_t*)fmask,          \
      (const uint8_t*)node_mask, (const float*)splits,                      \
      (const float*)min_inst, (const float*)min_gain, (float*)out_gain,     \
      (int32_t*)out_feat, (int32_t*)out_bin, (uint8_t*)out_leaf,            \
      (float*)out_thr, P, D, NB, dc
  switch (split_q(NB)) {
    case 1:
      tree_split_variance_kernel<1><<<grid, threads, smem, s>>>(SPLIT_ARGS);
      break;
    case 2:
      tree_split_variance_kernel<2><<<grid, threads, smem, s>>>(SPLIT_ARGS);
      break;
    default:
      tree_split_variance_kernel<4><<<grid, threads, smem, s>>>(SPLIT_ARGS);
  }
#undef SPLIT_ARGS
  return (int)cudaGetLastError();
}
