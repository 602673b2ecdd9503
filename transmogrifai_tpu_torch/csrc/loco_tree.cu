// loco_tree — leave-one-covariate-out explanations of a tree ensemble (GBT,
// random forest, decision tree; binary classifier or regressor) with each
// row's top-K groups.
//
// Replaces (JAX): transmogrifai_tpu/record_insights.py:_device_topk's `loco`
// program (:140-160) on a tree model: the base forward, a lax.map of G
// masked forwards score(X * m_g) over the [G, D] group masks (each a full
// one-hot tree walk, trees.py:668-702), the [N, G] diffs and lax.top_k.
//
// Group g's score is the walk of the row with g's features read as 0 — a
// node whose feature f has gid[f] == g compares 0 instead of x_f — so
// nothing the size of X * m_g is formed.  The walk keeps tree_walk.cu's
// rules: a leaf stops it, a child index >= T leaves the row at its node, the
// compare is x > threshold.  The score:
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
// Each group's sums add its trees' leaves in tree order (__fadd_rn from 0),
// as the twin's walk sums them.
//
// Design (insights_kernels.loco_plan("tree", ...) sizes it):
// - rows across threads: a thread walks one row, a block TREE_ROWS rows, so
//   that many independent walks are in flight (the old design's warp a row
//   held 32x fewer);
// - one 16-byte node record a step, packed once per model by the wrapper:
//   {feature (-1 at a leaf), threshold bits, the feature's group (-1 at a
//   leaf), leaf_a bits};
// - walks only where they can change a score: the row's base path through
//   a tree is walked once, and a group walks again only from the first node
//   on that path that reads one of its features (with its features read as
//   0); every other group reaches the base leaf.  At most `steps` groups a
//   tree walk again, each only below where it meets the path.  (Keeping the
//   base path in shared memory, so that a group leaves it only where its
//   masked decision differs, and running those walks in lockstep across a
//   warp, measured slower on an H100: 6.4 -> 7.6 and 8.4 ms at the default
//   grid's GBT, scripts/loco_tree_time.py);
// - the per-group sums live in a shared-memory slab [GW][rows] (leaf_b's
//   beside them for a forest classifier), groups in windows of GW <= 64
//   when G is larger (each window walks the base paths again); each tree
//   adds a leaf to every group of the window: its own walk's, or the base
//   leaf (a bit mask of the window's groups met on the path);
// - where 4·D is small, the block's rows of X are staged once, coalesced,
//   into shared memory (odd row stride); wide X is read in place;
// - the epilogue: each thread turns its row's window of sums into diffs in
//   the slab, then the block's warps take its rows one a warp through
//   loco_topk.cuh (lane i: group g0 + i of each 32), the top-K list carried
//   across windows in the output.
//
// Bound: device-memory bytes — X read once (4 N D) and the [N, K] output
// written once (8 N K); the base walks and the groups' walks below where
// they meet the base path are the work above it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "loco_topk.cuh"

// the score of a row from its leaf sums (see the link table above)
__device__ __forceinline__ float loco_tree_link(float sa, float sb, int link,
                                                int Tr, float base0,
                                                float eta) {
  if (link == 0) return loco_sigmoid(__fadd_rn(base0, __fmul_rn(eta, sa)));
  if (link == 2) return __fadd_rn(base0, __fmul_rn(eta, sa));
  const float tr = (float)Tr;
  if (link == 3) return __fdiv_rn(sa, tr);
  return __fdiv_rn(__fdiv_rn(sa, tr), fmaxf(__fdiv_rn(sb, tr), 1e-12f));
}

// the walk of group g from `node` (record nd, step s of `steps`) with g's
// features read as 0; returns the reached node, its record in nd
template <bool XS>
__device__ __forceinline__ int loco_rewalk(const int4* __restrict__ tr,
                                           int node, int4& nd, int g, int s,
                                           int steps, const float* xr,
                                           int T) {
  for (; s < steps; ++s) {
    if (nd.x < 0) break;                            // a leaf
    const float x = nd.z == g ? 0.f : (XS ? xr[nd.x] : __ldg(xr + nd.x));
    const int nxt = 2 * node + 1 + (x > __int_as_float(nd.y));
    if (nxt >= T) break;                            // the row stays put
    node = nxt;
    nd = __ldg(tr + node);
  }
  return node;
}

template <bool XS>
__global__ void __launch_bounds__(256) loco_tree_kernel(
    const float* __restrict__ X, const int4* __restrict__ nodes,
    const float* __restrict__ leaf_b, float* __restrict__ out_val,
    int32_t* __restrict__ out_idx, long long N, int D, int Tr, int T,
    int steps, int G, int K, int strategy, int link, float base0, float eta,
    int GW, int Dp) {
  extern __shared__ float sm[];
  const int R = blockDim.x, RS = R + 1;          // the slab's row stride
  const bool two = leaf_b != nullptr;            // a forest classifier
  float* acc_a = sm;                             // [GW][RS]
  float* acc_b = acc_a + (two ? GW * RS : 0);    // [GW][RS] (two sums)
  float* xs = acc_b + GW * RS;                   // [R][Dp] the rows of X
  const long long n0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, N - n0);
  const int tid = threadIdx.x;
  if (XS) {
    const float* xb = X + n0 * D;
    for (int i = tid; i < rows * D; i += R) {
      const int r = i / D;
      xs[r * Dp + (i - r * D)] = __ldg(xb + i);
    }
  }
  // a thread past the last row walks that row again and offers nothing
  const int r = min(tid, rows - 1);
  const float* xr = XS ? xs + r * Dp : X + (n0 + r) * D;
  const int warp = tid >> 5, lane = tid & 31, n_warps = R >> 5;

  for (int g0 = 0; g0 < G; g0 += GW) {
    const int gn = min(GW, G - g0);
    for (int j = 0; j < gn; ++j) {
      acc_a[j * RS + tid] = 0.f;
      if (two) acc_b[j * RS + tid] = 0.f;
    }
    __syncthreads();                             // X staged; slab free
    float sa0 = 0.f, sb0 = 0.f;                  // the base sums
    for (int t = 0; t < Tr; ++t) {
      const int4* tr = nodes + (long long)t * T;
      int node = 0;
      int4 nd = __ldg(tr);
      unsigned long long met = 0ull;             // the window's groups met
      for (int s = 0; s < steps; ++s) {
        if (nd.x < 0) break;
        const int j = nd.z - g0;
        if (j >= 0 && j < gn && !((met >> j) & 1ull)) {
          // the first node of group g0 + j on the base path: it walks
          // again from here, and its sum takes the leaf it reaches
          met |= 1ull << j;
          int4 gd = nd;
          const int at = loco_rewalk<XS>(tr, node, gd, nd.z, s, steps, xr,
                                         T);
          acc_a[j * RS + tid] = __fadd_rn(acc_a[j * RS + tid],
                                          __int_as_float(gd.w));
          if (two)
            acc_b[j * RS + tid] = __fadd_rn(
                acc_b[j * RS + tid], __ldg(leaf_b + (long long)t * T + at));
        }
        const float x = XS ? xr[nd.x] : __ldg(xr + nd.x);
        const int nxt = 2 * node + 1 + (x > __int_as_float(nd.y));
        if (nxt >= T) break;
        node = nxt;
        nd = __ldg(tr + node);
      }
      const float la = __int_as_float(nd.w);
      const float lb = two ? __ldg(leaf_b + (long long)t * T + node) : 0.f;
      sa0 = __fadd_rn(sa0, la);
      if (two) sb0 = __fadd_rn(sb0, lb);
      for (int j = 0; j < gn; ++j) {             // the groups off the path
        if ((met >> j) & 1ull) continue;
        acc_a[j * RS + tid] = __fadd_rn(acc_a[j * RS + tid], la);
        if (two) acc_b[j * RS + tid] = __fadd_rn(acc_b[j * RS + tid], lb);
      }
    }
    // the window's diffs, in place of its sums
    const float base = loco_tree_link(sa0, sb0, link, Tr, base0, eta);
    for (int j = 0; j < gn; ++j)
      acc_a[j * RS + tid] = __fsub_rn(
          base, loco_tree_link(acc_a[j * RS + tid],
                               two ? acc_b[j * RS + tid] : 0.f, link, Tr,
                               base0, eta));
    __syncthreads();
    // each warp takes rows: the window's groups 32 at a time
    for (int rr = warp; rr < rows; rr += n_warps) {
      float* val = out_val + (n0 + rr) * K;
      int32_t* idx = out_idx + (n0 + rr) * K;
      WarpTopK top = g0 == 0 ? loco_topk_init(K, strategy, val, idx)
                             : loco_topk_resume(K, strategy, val, idx,
                                                min(K, g0));
      for (int jb = 0; jb < gn; jb += 32) {
        const int j = jb + lane;
        const bool valid = j < gn;
        loco_topk_offer(top, valid, g0 + j,
                        valid ? acc_a[j * RS + rr] : 0.f);
      }
      loco_topk_write(top);
    }
    __syncthreads();                             // the slab is read
  }
}

// nodes: the wrapper's int4 [Tr * T] records; leaf_b: f32 [Tr * T] (a
// forest classifier's class-share sums) or null; GW groups a window (<=
// 64); xs: the block's rows of X staged at row stride Dp (odd, >= D);
// threads 128 or 256; smem: 4 * ((leaf_b ? 2 : 1) * GW * (threads + 1) +
// (xs ? threads * Dp : 0))
extern "C" int loco_tree_launch(const void* X, const void* nodes,
                                const void* leaf_b, void* out_val,
                                void* out_idx, long long N, int D, int Tr,
                                int T, int steps, int G, int K, int strategy,
                                int link, float base0, float eta, int GW,
                                int xs, int Dp, int threads, int smem,
                                void* stream) {
  const long long want =
      4LL * ((leaf_b ? 2 : 1) * (long long)GW * (threads + 1) +
             (xs ? (long long)threads * Dp : 0));
  if (N < 1 || D < 1 || Tr < 1 || T < 1 || steps < 1 || K < 1 || K > G ||
      strategy < 0 || strategy > 2 || link < 0 || link > 3 ||
      (link == 1) != (leaf_b != nullptr) || GW < 1 || GW > 64 ||
      (threads != 128 && threads != 256) || (xs && Dp < D) || smem != want ||
      smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  decltype(&loco_tree_kernel<true>) kern =
      xs ? &loco_tree_kernel<true> : &loco_tree_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (N + threads - 1) / threads;
  kern<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)X, (const int4*)nodes, (const float*)leaf_b,
      (float*)out_val, (int32_t*)out_idx, N, D, Tr, T, steps, G, K, strategy,
      link, base0, eta, GW, Dp);
  return (int)cudaGetLastError();
}
