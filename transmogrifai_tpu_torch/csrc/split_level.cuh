// split_level.cuh — what the warp-per-node split kernels share
// (tree_split.cu: xgb; tree_split_gini.cu: gini): the cp.async staging of a
// warp's bins, the first max over (feature, bin) across a warp's lanes and
// across the W warps of one node, the level's writes into fit_trees' tree
// arrays, and the second kernel that adds the split nodes' gains into
// gain[k, feature] in node order.
//
// Replaces (JAX): transmogrifai_tpu/models/trees.py:_fit_tree_compact's
// argmax over bins and feature chunks (:347-356), the level's writes into the
// tree arrays (:358-366) and gain_acc's scatter-add (:381).
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#ifndef SPLIT_FULL
#define SPLIT_FULL 0xffffffffu
#endif
#define SPLIT_WIN 1024         // nodes a window of the gain walk stages
#define SPLIT_MAX_W 8          // warps a node at most (a block of 8 warps)

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {   // all but the last
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// (g, f, b) beats (bg, bf, bb): a higher gain, or an equal one at a lower
// feature, then a lower bin — the first max over (feature, bin)
__device__ __forceinline__ bool split_better(float g, int f, int b, float bg,
                                             int bf, int bb) {
  return g > bg || (g == bg && (f < bf || (f == bf && b < bb)));
}

// the warp's first max of its lanes' (best, bf, bb), in every lane
__device__ __forceinline__ void split_warp_best(float& best, int& bf,
                                                int& bb) {
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_xor_sync(SPLIT_FULL, best, off);
    const int of = __shfl_xor_sync(SPLIT_FULL, bf, off);
    const int ob = __shfl_xor_sync(SPLIT_FULL, bb, off);
    if (split_better(og, of, ob, best, bf, bb)) { best = og; bf = of; bb = ob; }
  }
}

// W > 1 warps a node (warp = slot * W + chunk c, chunks in feature order):
// their bests combined in the node's first warp (c == 0).  Every warp of the
// block calls it (a __syncthreads inside).
__device__ __forceinline__ void split_chunk_best(float& best, int& bf, int& bb,
                                                 int W, int warp, int slot,
                                                 int c, int lane) {
  __shared__ float s_g[SPLIT_MAX_W];
  __shared__ int s_f[SPLIT_MAX_W], s_b[SPLIT_MAX_W];
  if (lane == 0) { s_g[warp] = best; s_f[warp] = bf; s_b[warp] = bb; }
  __syncthreads();
  if (c == 0) {
    const int j = slot * W + lane;
    float g = lane < W ? s_g[j] : -INFINITY;
    int f = lane < W ? s_f[j] : INT_MAX, b = lane < W ? s_b[j] : 0;
    split_warp_best(g, f, b);
    best = g; bf = f; bb = b;
  }
}

// fit_trees' level arrays at node t = k*T + offset + p: feature (-1 on a
// leaf), threshold and is_leaf (one thread)
__device__ __forceinline__ void split_write_node(int32_t* t_feat, float* t_thr,
                                                 uint8_t* t_leaf, long long t,
                                                 bool leaf, int bf,
                                                 float thr) {
  t_feat[t] = leaf ? -1 : bf;
  t_thr[t] = thr;
  t_leaf[t] = leaf ? 1 : 0;
}

// The level's gain sums of lane blockIdx.x (256 threads): a window of
// 1,024 of the lane's nodes at a time, thread i reads nodes 4i .. 4i+3 and
// the split ones are gathered in node order into shared memory (a block
// scan of the counts); then thread t walks them in order and adds those of
// feature t (t + 256, ...), 4 at a time.
__global__ void __launch_bounds__(256) tree_split_gain_kernel(
    const float* __restrict__ out_gain, const int32_t* __restrict__ out_feat,
    const uint8_t* __restrict__ out_leaf, float* __restrict__ t_gain, int P,
    int D) {
  __shared__ int4 s_nf4[SPLIT_WIN / 4];   // split nodes' features
  __shared__ float4 s_ng4[SPLIT_WIN / 4]; // and gains, in node order
  __shared__ int s_warp[8];
  int* s_nf = (int*)s_nf4;
  float* s_ng = (float*)s_ng4;
  const int k = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t0 = 0; t0 < D; t0 += 256) {
    const int t = t0 + threadIdx.x;
    float a = t < D ? t_gain[(long long)k * D + t] : 0.f;
    for (int w0 = 0; w0 < P; w0 += SPLIT_WIN) {
      int fq[4], cnt = 0;
      float gq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = w0 + 4 * threadIdx.x + q;
        const long long j = (long long)k * P + min(i, P - 1);
        const int f = out_feat[j];
        const bool split = i < P && !out_leaf[j];
        fq[q] = split ? f : -1;
        gq[q] = out_gain[j];
        cnt += split;
      }
      int incl = cnt;                     // the block's exclusive scan
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(SPLIT_FULL, incl, off);
        if (lane >= off) incl += v;
      }
      __syncthreads();                    // the last window's walk is done
      if (lane == 31) s_warp[warp] = incl;
      __syncthreads();
      int pos = incl - cnt, n = 0;
      for (int w = 0; w < 8; ++w) {
        pos += w < warp ? s_warp[w] : 0;
        n += s_warp[w];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (fq[q] >= 0) { s_nf[pos] = fq[q]; s_ng[pos] = gq[q]; ++pos; }
      if (threadIdx.x < ((n + 3) & ~3) - n)
        s_nf[n + threadIdx.x] = -1;       // pad to a multiple of 4
      __syncthreads();
      if (t < D) {
#pragma unroll 8
        for (int i = 0; i < (n + 3) / 4; ++i) {
          const int4 f = s_nf4[i];
          const float4 g = s_ng4[i];
          if (f.x == t) a = __fadd_rn(a, g.x);
          if (f.y == t) a = __fadd_rn(a, g.y);
          if (f.z == t) a = __fadd_rn(a, g.z);
          if (f.w == t) a = __fadd_rn(a, g.w);
        }
      }
    }
    if (t < D) t_gain[(long long)k * D + t] = a;
  }
}
