// loco_tree — leave-one-covariate-out explanations of a tree ensemble (GBT,
// random forest, decision tree; binary classifier or regressor) with each
// row's top-K groups.
//
// Replaces (JAX): transmogrifai_tpu/record_insights.py:_device_topk's `loco`
// program (:140-160) on a tree model: the base forward, a lax.map of G
// masked forwards score(X * m_g) over the [G, D] group masks (each a full
// one-hot tree walk, trees.py:668-702), the [N, G] diffs and lax.top_k.
//
// Here each row is walked once for its base score and once per group with
// the group's features read as 0 — a node whose feature f has gid[f] == g
// compares 0 instead of x_f — so nothing the size of X * m_g is formed.  The
// walk keeps tree_walk.cu's rules: a leaf stops it, a child index >= T
// leaves the row at its node, the compare is x > threshold.  The score:
//   GBT classifier     sigmoid(base + eta * sum_t leaf_a)             (link 0)
//   forest classifier  (sum_t leaf_a / Tr) / max(sum_t leaf_b / Tr, 1e-12)
//                                                                    (link 1)
//   GBT regressor      base + eta * sum_t leaf_a                      (link 2)
//   forest regressor   sum_t leaf_a / Tr                              (link 3)
// where for a forest classifier leaf_a is a node's last class share (column
// 1 of a binary forest, the reference's probability[:, -1]) and leaf_b the
// sum of its class shares: the normalised mean of
// TreeEnsembleModel.device_scores.  A regressor's leaf_a is its one leaf
// value, and the score its prediction (no sigmoid, no second leaf value).
// The sums run over the trees in order, as the twin's walk sums them.
//
// Design: one warp per row (grid-stride over rows); lanes 0-30 walk groups
// 0-30 while lane 31 walks the unmasked base, then lane i group 31 + 32b + i
// of each further 32, four trees at a time with their steps interleaved (a
// walk is a chain of dependent reads; four chains keep four in flight).  The lanes
// of a warp walk the same row through the same trees and part only where a
// node's feature is the lane's group, so their node and X reads mostly
// coincide.  The trees and the column -> group map are staged in shared
// memory once per block when they fit (the default grid's depth-12 trees do
// not, and are read from device memory).  Each lane's diff goes to the
// warp's top-K (loco_topk.cuh).
//
// Bound: device-memory bytes — X read once (4 N D) and the [N, K] output
// written once (8 N K); the (G + 1) walks per row are the work above it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "loco_topk.cuh"

struct Trees {
  const int32_t* feat;
  const float* thr;
  const uint8_t* leaf;
  const float* a;
  const float* b;
  const int32_t* gid;
};

#define WALKS 4                  // trees a lane walks side by side

// the score of row x with group g's features read as 0 (g < 0: none).  The
// trees go WALKS at a time, their walks interleaved step by step so that
// their node and X reads are in flight together; the leaves add in tree
// order.
__device__ __forceinline__ float tree_score(const Trees& t, const float* x,
                                            int g, int Tr, int T, int steps,
                                            int link, float base0,
                                            float eta) {
  float sa = 0.f, sb = 0.f;
  for (int r0 = 0; r0 < Tr; r0 += WALKS) {
    int node[WALKS], o[WALKS];
    bool live[WALKS];
#pragma unroll
    for (int u = 0; u < WALKS; ++u) {
      node[u] = 0;
      o[u] = min(r0 + u, Tr - 1) * T;
      live[u] = r0 + u < Tr;
    }
    for (int s = 0; s < steps; ++s) {
      bool any = false;
#pragma unroll
      for (int u = 0; u < WALKS; ++u) {
        const int at = o[u] + node[u];
        live[u] = live[u] && !t.leaf[at];
        const int f = max(t.feat[at], 0);          // a leaf's is -1
        const float xv = t.gid[f] == g ? 0.f : x[f];
        const int nxt = 2 * node[u] + 1 + (xv > t.thr[at]);
        live[u] = live[u] && nxt < T;   // bottom level: the row stays put
        if (live[u]) node[u] = nxt;
        any = any || live[u];
      }
      if (!any) break;
    }
#pragma unroll
    for (int u = 0; u < WALKS; ++u) {
      if (r0 + u < Tr) {
        sa = __fadd_rn(sa, t.a[o[u] + node[u]]);
        if (link == 1) sb = __fadd_rn(sb, t.b[o[u] + node[u]]);
      }
    }
  }
  if (link == 0)
    return loco_sigmoid(__fadd_rn(base0, __fmul_rn(eta, sa)));
  if (link == 2) return __fadd_rn(base0, __fmul_rn(eta, sa));
  const float tr = (float)Tr;
  if (link == 3) return __fdiv_rn(sa, tr);
  return __fdiv_rn(__fdiv_rn(sa, tr), fmaxf(__fdiv_rn(sb, tr), 1e-12f));
}

__global__ void loco_tree_kernel(const float* __restrict__ X, Trees t,
                                 float* __restrict__ out_val,
                                 int32_t* __restrict__ out_idx, long long N,
                                 int D, int Tr, int T, int steps, int G,
                                 int K, int strategy, int link, float base0,
                                 float eta, int staged) {
  extern __shared__ unsigned char smem[];
  if (staged) {
    const int nodes = Tr * T;
    float* thr = (float*)smem;
    float* a = thr + nodes;
    float* b = a + nodes;
    int32_t* feat = (int32_t*)(b + (link == 1 ? nodes : 0));
    int32_t* gid = feat + nodes;
    uint8_t* leaf = (uint8_t*)(gid + D);
    for (int i = threadIdx.x; i < nodes; i += blockDim.x) {
      thr[i] = t.thr[i];
      a[i] = t.a[i];
      if (link == 1) b[i] = t.b[i];
      feat[i] = t.feat[i];
      leaf[i] = t.leaf[i];
    }
    for (int i = threadIdx.x; i < D; i += blockDim.x) gid[i] = t.gid[i];
    t.thr = thr;
    t.a = a;
    t.b = b;
    t.feat = feat;
    t.gid = gid;
    t.leaf = leaf;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * blockDim.x
                           + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long n = first; n < N; n += n_warps) {
    const float* x = X + n * D;
    WarpTopK top = loco_topk_init(K, strategy, out_val + n * K,
                                  out_idx + n * K);
    // lanes 0..30 walk groups 0..30 while lane 31 walks the base
    const float s0 = tree_score(t, x, lane < 31 ? lane : -1, Tr, T, steps,
                                link, base0, eta);
    const float base = __shfl_sync(LOCO_FULL, s0, 31);
    loco_topk_offer(top, lane < min(G, 31), lane, __fsub_rn(base, s0));
    for (int gb = 31; gb < G; gb += 32) {
      const int g = gb + lane;
      const bool valid = g < G;
      const float s = valid ? tree_score(t, x, g, Tr, T, steps, link, base0,
                                         eta) : base;
      loco_topk_offer(top, valid, g, __fsub_rn(base, s));
    }
    loco_topk_write(top);
  }
}

extern "C" int loco_tree_launch(const void* X, const void* feature,
                                const void* threshold, const void* is_leaf,
                                const void* leaf_a, const void* leaf_b,
                                const void* gid, void* out_val, void* out_idx,
                                long long N, int D, int Tr, int T, int steps,
                                int G, int K, int strategy, int link,
                                float base0, float eta, int blocks,
                                int threads, int smem, void* stream) {
  if (K < 1 || K > G || threads % 32 || strategy < 0 || strategy > 2 ||
      link < 0 || link > 3 || (link == 1 && leaf_b == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      loco_tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Trees t{(const int32_t*)feature, (const float*)threshold,
          (const uint8_t*)is_leaf, (const float*)leaf_a,
          (const float*)leaf_b, (const int32_t*)gid};
  loco_tree_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)X, t, (float*)out_val, (int32_t*)out_idx, N, D, Tr, T,
      steps, G, K, strategy, link, base0, eta, smem > 0);
  return (int)cudaGetLastError();
}
