// tree_split — best xgb split per (lane, node) from a level's histograms,
// and (for fit_trees) the level's tree arrays written in the epilogue.
//
// Replaces (JAX): the rest of transmogrifai_tpu/models/trees.py:
// _fit_tree_compact's scan_chunk body (:339-356) — cumsum over bins,
// _gain_xgb (:202-209), the `ok` mask, max/argmax over bins and then over
// feature chunks with strict `>` — and the leaf flag, threshold and
// _leaf_xgb leaf value that follow it (:358-364, :220-221), with the level's
// writes into the tree arrays and the per-feature gain sum (:365-372, :381).
//
// Design: a warp owns a (lane, node), or one of W chunks of its features
// where the level has too few nodes to fill the card (``xgb_split_plan``
// picks W, at most 8: a block of 256 threads holds 8 / W nodes).  A node
// whose count total is below 2·min_instances cannot leave min_instances
// rows on both sides of any split (counts are non-negative: a left count
// c >= mi > pc/2 makes pc - c exact, and below mi), so its warps read none
// of its histogram: it is a leaf with gain -inf, feature 0 and bin 0, as
// the full scan gives it.  Otherwise the warp takes its features 32 at a
// time, a feature a lane, and their bins SB at a time (8 for up to 32
// features, 32 for up to 8: what a slice of 800 floats holds): it copies
// them (3 statistics a bin) from device memory into one
// of its two slices of shared memory with cp.async (no registers held; a
// feature's row at an odd stride, so that the lanes' reads fall in 32
// banks), and starts the next stage's copy before each lane walks its
// feature's bins of the current one.  The prefix over bins is added in the JAX
// package's own order (XLA:CPU's cumsum: serial f32 sums within blocks of
// 16 bins, each block then adding the serial sum of the blocks before it),
// the gain is _gain_xgb's f32 expression, and the lane keeps its running
// best with a strict `>` (lowest feature, then lowest bin, on a tie).  A
// warp reduction then keeps the best gain, the lowest feature on a tie;
// W > 1 chunks combine in the node's first warp the same way (the lowest
// chunk on a tie): the first max over (feature, bin), as the JAX argmax
// over feature chunks takes it (trees.py:352).  There is no walk of one
// thread over the features.  With the tree arrays given, the node's first
// warp writes the level's slices of feature (-1 on a leaf), threshold,
// is_leaf and the leaf value, and a second kernel of K blocks adds each
// split node's gain into gain[k, feature] in node order: a block stages
// its lane's nodes in shared memory a window at a time and thread t walks
// them in order, adding those of feature t — the bits of a serial
// scatter-add in node order.  The reductions, the level's writes and the
// gain kernel are split_level.cuh's, shared with tree_split_gini.cu.
//
// Bound: device-memory bytes — one read of bins 0 .. NB-2 of the
// histograms of the nodes that can split ([D, NB, 3] f32 a node, 10.75 KB
// at 28 features x 32 bins) and a few bytes per node in and out.
#include "split_level.cuh"

#define SPLIT_SLICE 800        // floats a slice of a warp's staged bins
#define SPLIT_WARP_FLOATS (2 * SPLIT_SLICE)   // two slices a warp

// Stage s of a warp's walk: feature group g = s / nstage (32 features from
// d0 + 32g), bins SB (s % nstage) .. into slice s % 2 at the odd stride
// 3·SB + 1; one commit group a stage (an empty one past the last, so that
// "all but the last" waits work)
template <int SB>
__device__ __forceinline__ void stage_copy(float* sw, const float* h, int s,
                                           int nstage, int total, int d0,
                                           int d1, int NB, int lane) {
  if (s < total) {
    const int g0 = d0 + 32 * (s / nstage), b0 = SB * (s % nstage);
    const int nf = min(32, d1 - g0), n3 = 3 * min(SB, NB - 1 - b0);
    float* dst = sw + (s & 1) * SPLIT_SLICE;
    const float* src = h + ((long long)g0 * NB + b0) * 3;
    for (int e = lane; e < nf * 3 * SB; e += 32) {
      const int f = e / (3 * SB), j = e - f * (3 * SB);
      if (j < n3)
        cp_async4(dst + f * (3 * SB + 1) + j, src + (long long)f * NB * 3 + j);
    }
  }
  cp_async_commit();
}

template <int SB>
__global__ void __launch_bounds__(256) tree_split_kernel(
    const float* __restrict__ hist, const float* __restrict__ totals,
    const uint8_t* __restrict__ fmask, const float* __restrict__ splits,
    const float* __restrict__ min_inst, const float* __restrict__ min_gain,
    const float* __restrict__ lam_k, float* __restrict__ out_gain,
    int32_t* __restrict__ out_feat, int32_t* __restrict__ out_bin,
    uint8_t* __restrict__ out_leaf, float* __restrict__ out_thr,
    float* __restrict__ out_value, int32_t* __restrict__ t_feat,
    float* __restrict__ t_thr, uint8_t* __restrict__ t_leaf,
    float* __restrict__ t_value, int P, int D, int NB, int W, int fc, int T,
    int offset) {
  extern __shared__ float s_dyn[];     // each warp's two slices
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.y;
  const int slot = warp / W, c = warp - slot * W;
  const int p = blockIdx.x * ((blockDim.x >> 5) / W) + slot;
  const bool valid = p < P;
  const long long node = (long long)k * P + p;
  const float lam = lam_k[k], mi = min_inst[k];
  const int d0 = c * fc, d1 = min(D, d0 + fc);
  float best = -INFINITY, pg = 0.f, ph = 0.f;
  int bf = d0 + lane < d1 ? d0 + lane : INT_MAX, bb = 0;
  if (valid && d0 < d1) {
    const float pc = totals[node * 3 + 0];
    pg = totals[node * 3 + 1];
    ph = totals[node * 3 + 2];
    if (pc >= 2.0f * mi) {
      const float ps = pg * pg / (ph + lam);
      float* sw = s_dyn + warp * SPLIT_WARP_FLOATS;
      const float* h = hist + node * D * NB * 3;
      const int nstage = (NB - 1 + SB - 1) / SB;
      const int total = nstage * ((d1 - d0 + 31) / 32);
      float ic = 0.f, ig = 0.f, ih = 0.f;   // this block of 16 bins
      float oc = 0.f, og = 0.f, oh = 0.f;   // the blocks before it
      bool allowed = false;
      stage_copy<SB>(sw, h, 0, nstage, total, d0, d1, NB, lane);
      for (int s = 0; s < total; ++s) {
        stage_copy<SB>(sw, h, s + 1, nstage, total, d0, d1, NB, lane);
        const int g0 = d0 + 32 * (s / nstage), b0 = SB * (s % nstage);
        const int nb = min(SB, NB - 1 - b0);
        if (b0 == 0) {
          ic = ig = ih = oc = og = oh = 0.f;
          allowed = g0 + lane < d1 && fmask[g0 + lane] != 0;
        }
        cp_async_wait_prev();
        __syncwarp();
        if (allowed) {
          const float* x = sw + (s & 1) * SPLIT_SLICE + lane * (3 * SB + 1);
#pragma unroll 4
          for (int j = 0; j < nb; ++j) {
            const int b = b0 + j;
            if ((b & 15) == 0 && b) {      // a new block of 16 bins
              oc = __fadd_rn(oc, ic); og = __fadd_rn(og, ig);
              oh = __fadd_rn(oh, ih);
              ic = ig = ih = 0.f;
            }
            ic = __fadd_rn(ic, x[3 * j]);
            ig = __fadd_rn(ig, x[3 * j + 1]);
            ih = __fadd_rn(ih, x[3 * j + 2]);
            const float cl = __fadd_rn(ic, oc), gl = __fadd_rn(ig, og),
                        hl = __fadd_rn(ih, oh);
            const float rc = pc - cl, rg = pg - gl, rh = ph - hl;
            const float gn = 0.5f * ((gl * gl / (hl + lam)
                                      + rg * rg / (rh + lam)) - ps);
            if (cl >= mi && rc >= mi && gn > best) {
              best = gn; bf = g0 + lane; bb = b;
            }
          }
        }
        __syncwarp();                     // the slice is copied into next
      }
    }
  }
  // the warp's best, then the node's chunks (split_level.cuh): the
  // highest gain, the lowest feature on a tie
  split_warp_best(best, bf, bb);
  if (W > 1) split_chunk_best(best, bf, bb, W, warp, slot, c, lane);
  if (valid && c == 0 && lane == 0) {
    const bool leaf = !(isfinite(best) && best > min_gain[k]);
    const float thr =
        splits[(long long)bf * (NB - 1) + min(max(bb, 0), NB - 2)];
    const float value = -(pg / (ph + lam));
    out_gain[node] = best;
    out_feat[node] = bf;
    out_bin[node] = bb;
    out_leaf[node] = leaf ? 1 : 0;
    out_thr[node] = thr;
    out_value[node] = value;
    if (t_feat) {
      const long long t = (long long)k * T + offset + p;
      split_write_node(t_feat, t_thr, t_leaf, t, leaf, bf, thr);
      t_value[t] = value;
    }
  }
}

// One xgb split level of K lanes x P nodes; returns a cudaError_t.  W warps
// a node (1, 2, 4 or 8), fc features a warp, sb bins a stage (8, or 32
// where a warp has at most 8 features), ``threads`` a block (a
// multiple of 32·W, at most 256).  t_feat .. t_value (null: the dict form
// only) are fit_trees' [K, T] arrays, written at columns offset ..
// offset+P-1; t_gain [K, D] (null: no gain sums) takes the split nodes'
// gains (a second kernel).  ``smem``: dynamic shared memory bytes, each
// warp's two slices of staged bins.
extern "C" int tree_split_launch(
    const void* hist, const void* totals, const void* fmask,
    const void* splits, const void* min_inst, const void* min_gain,
    const void* lam, void* out_gain, void* out_feat, void* out_bin,
    void* out_leaf, void* out_thr, void* out_value, void* t_feat, void* t_thr,
    void* t_leaf, void* t_value, void* t_gain, int K, int P, int D, int NB,
    int W, int fc, int sb, int threads, int T, int offset, int smem,
    void* stream) {
  if (NB > 127 || NB < 2 || K < 1 || K > 65535 || P < 1 || D < 1 || fc < 1 ||
      W < 1 || W > 8 || (W & (W - 1)) || threads > 256 ||
      threads % (32 * W) || (long long)W * fc < D || (sb != 8 && sb != 32) ||
      min(32, fc) * (3 * sb + 1) > SPLIT_SLICE ||
      smem < 4 * (threads / 32) * SPLIT_WARP_FLOATS ||
      (t_feat && (!t_thr || !t_leaf || !t_value || offset + P > T)))
    return (int)cudaErrorInvalidValue;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const cudaError_t e = sb == 8
                            ? cudaFuncSetAttribute(tree_split_kernel<8>, attr,
                                                   smem)
                            : cudaFuncSetAttribute(tree_split_kernel<32>,
                                                   attr, smem);
  if (e != cudaSuccess) return (int)e;
  const int per_block = threads / 32 / W;
  dim3 grid((P + per_block - 1) / per_block, K);
  const cudaStream_t s = (cudaStream_t)stream;
#define SPLIT_ARGS                                                          \
  (const float*)hist, (const float*)totals, (const uint8_t*)fmask,          \
      (const float*)splits, (const float*)min_inst, (const float*)min_gain, \
      (const float*)lam, (float*)out_gain, (int32_t*)out_feat,              \
      (int32_t*)out_bin, (uint8_t*)out_leaf, (float*)out_thr,               \
      (float*)out_value, (int32_t*)t_feat, (float*)t_thr, (uint8_t*)t_leaf, \
      (float*)t_value, P, D, NB, W, fc, T, offset
  if (sb == 8)
    tree_split_kernel<8><<<grid, threads, (size_t)smem, s>>>(SPLIT_ARGS);
  else
    tree_split_kernel<32><<<grid, threads, (size_t)smem, s>>>(SPLIT_ARGS);
#undef SPLIT_ARGS
  if (t_gain)
    tree_split_gain_kernel<<<K, 256, 0, s>>>(
        (const float*)out_gain, (const int32_t*)out_feat,
        (const uint8_t*)out_leaf, (float*)t_gain, P, D);
  return (int)cudaGetLastError();
}
