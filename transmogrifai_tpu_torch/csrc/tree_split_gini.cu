// tree_split_gini — best gini split per (lane, node) from a level's
// histograms, over each node's own feature subset.
//
// Replaces (JAX): the gini case of transmogrifai_tpu/models/trees.py:
// _fit_tree_compact's scan_chunk body (:331-357) — cumsum over bins,
// _gain_gini (:194-199), the `ok` mask with the tree-level feature mask and
// the per-node subset drawn at :320-326, max/argmax over bins and then over
// feature chunks with strict `>` — and the leaf flag and threshold that
// follow it (:364-366).  The node's leaf values (_leaf_gini, :216-217) are
// not computed here: the caller divides the node totals in torch.
//
// Gain, in the f32 order of _gain_gini:
//   wgini(s) = cnt * (1 - sum_c (s_c / cnt)^2),  cnt = max(s_0, 1e-12)
//   gain     = wgini(parent) - wgini(left) - wgini(right),  right = parent - left
// written with __f*_rn intrinsics so that nvcc contracts nothing into an
// FMA and the kernel rounds exactly as the plain PyTorch twin does.
//
// Design: as tree_split.cu — one block per (node, lane); warp w takes
// features w, w+nwarps, ...; lane b holds bin b (NB <= 32), so the prefix
// over bins is a warp shuffle scan of the S = 1 + C running sums and the
// argmax over bins a warp reduction that keeps the LOWEST bin on equal gain.
// A feature outside the tree mask or the node's subset skips its histogram
// read (warp-uniform branch).  Thread 0 then walks the per-feature winners in
// feature order with a strict `>`, so equal gains resolve to the lowest
// feature — the first-max rule of the JAX argmax.  C (classes) is a template
// parameter, instantiated for C = 2, 3, 4.
//
// Bound: device-memory bytes — one read of the [K, P, D, NB, 1+C] histogram
// (at the forest's deepest level, 60 lanes x 32 nodes x 28 features x 32 bins
// x 3 stats: 20.6 MB) plus the node masks and a few bytes per node out.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_D 1024

template <int C>
__device__ __forceinline__ float wgini(const float* s) {
  const float cnt = fmaxf(s[0], 1e-12f);
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float q = __fdiv_rn(s[1 + c], cnt);
    sq = c == 0 ? __fmul_rn(q, q) : __fadd_rn(sq, __fmul_rn(q, q));
  }
  return __fmul_rn(cnt, __fsub_rn(1.f, sq));
}

template <int C>
__global__ void tree_split_gini_kernel(const float* __restrict__ hist,
                                       const float* __restrict__ totals,
                                       const uint8_t* __restrict__ fmask,
                                       const uint8_t* __restrict__ node_mask,
                                       const float* __restrict__ splits,
                                       const float* __restrict__ min_inst,
                                       const float* __restrict__ min_gain,
                                       float* __restrict__ out_gain,
                                       int32_t* __restrict__ out_feat,
                                       int32_t* __restrict__ out_bin,
                                       uint8_t* __restrict__ out_leaf,
                                       float* __restrict__ out_thr,
                                       int P, int D, int NB) {
  constexpr int S = C + 1;
  __shared__ float fg[MAX_D];
  __shared__ int fb[MAX_D];
  const int p = blockIdx.x, k = blockIdx.y;
  const long long node = (long long)k * P + p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float mi = min_inst[k];
  float par[S];
#pragma unroll
  for (int j = 0; j < S; ++j) par[j] = totals[node * S + j];
  const float wpar = wgini<C>(par);
  const uint8_t* nm = node_mask ? node_mask + node * D : nullptr;

  for (int d = warp; d < D; d += nwarps) {
    if (!fmask[d] || (nm != nullptr && !nm[d])) {
      if (lane == 0) { fg[d] = -INFINITY; fb[d] = 0; }
      continue;
    }
    const float* h = hist + (node * D + d) * NB * S;
    float l[S], r[S];
#pragma unroll
    for (int j = 0; j < S; ++j) l[j] = lane < NB ? h[lane * S + j] : 0.f;
    // inclusive prefix over bins
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const float t = __shfl_up_sync(0xffffffffu, l[j], off);
        if (lane >= off) l[j] = __fadd_rn(l[j], t);
      }
    }
#pragma unroll
    for (int j = 0; j < S; ++j) r[j] = __fsub_rn(par[j], l[j]);
    float gain = __fsub_rn(__fsub_rn(wpar, wgini<C>(l)), wgini<C>(r));
    const bool ok = lane < NB - 1 && l[0] >= mi && r[0] >= mi;
    if (!ok) gain = -INFINITY;
    int bin = lane;
    // argmax over bins; equal gains keep the lower bin
    for (int off = 16; off > 0; off >>= 1) {
      const float og = __shfl_down_sync(0xffffffffu, gain, off);
      const int ob = __shfl_down_sync(0xffffffffu, bin, off);
      if (og > gain || (og == gain && ob < bin)) { gain = og; bin = ob; }
    }
    if (lane == 0) {
      // all -inf: bin 0, as jnp.argmax returns
      fg[d] = gain;
      fb[d] = gain == -INFINITY ? 0 : bin;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float best = -INFINITY;
    int bf = 0, bb = 0;
    for (int d = 0; d < D; ++d)
      if (fg[d] > best) { best = fg[d]; bf = d; bb = fb[d]; }
    const bool leaf = !(isfinite(best) && best > min_gain[k]);
    const int cb = min(max(bb, 0), NB - 2);
    out_gain[node] = best;
    out_feat[node] = bf;
    out_bin[node] = bb;
    out_leaf[node] = leaf ? 1 : 0;
    out_thr[node] = splits[bf * (NB - 1) + cb];
  }
}

template <int C>
static cudaError_t launch(const void* hist, const void* totals,
                          const void* fmask, const void* node_mask,
                          const void* splits, const void* min_inst,
                          const void* min_gain, void* out_gain,
                          void* out_feat, void* out_bin, void* out_leaf,
                          void* out_thr, int K, int P, int D, int NB,
                          cudaStream_t stream) {
  dim3 grid(P, K);
  tree_split_gini_kernel<C><<<grid, 256, 0, stream>>>(
      (const float*)hist, (const float*)totals, (const uint8_t*)fmask,
      (const uint8_t*)node_mask, (const float*)splits,
      (const float*)min_inst, (const float*)min_gain, (float*)out_gain,
      (int32_t*)out_feat, (int32_t*)out_bin, (uint8_t*)out_leaf,
      (float*)out_thr, P, D, NB);
  return cudaGetLastError();
}

extern "C" int tree_split_gini_launch(const void* hist, const void* totals,
                                      const void* fmask,
                                      const void* node_mask,
                                      const void* splits,
                                      const void* min_inst,
                                      const void* min_gain, void* out_gain,
                                      void* out_feat, void* out_bin,
                                      void* out_leaf, void* out_thr, int K,
                                      int P, int D, int NB, int C,
                                      void* stream) {
  if (NB > 32 || NB < 2 || D > MAX_D || P > 65535 || K > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 2: return (int)launch<2>(hist, totals, fmask, node_mask, splits,
                                  min_inst, min_gain, out_gain, out_feat,
                                  out_bin, out_leaf, out_thr, K, P, D, NB, s);
    case 3: return (int)launch<3>(hist, totals, fmask, node_mask, splits,
                                  min_inst, min_gain, out_gain, out_feat,
                                  out_bin, out_leaf, out_thr, K, P, D, NB, s);
    case 4: return (int)launch<4>(hist, totals, fmask, node_mask, splits,
                                  min_inst, min_gain, out_gain, out_feat,
                                  out_bin, out_leaf, out_thr, K, P, D, NB, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
