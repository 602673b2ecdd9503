// split_node.cuh — the body of the warp-per-node gini and variance splits
// (tree_split_gini.cu, tree_split_variance.cu: thin entry points that name
// their kernels), one layout, one plan (models/tree_kernels.py:
// gini_split_plan) and one epilogue, with the impurity a template flag.
//
// Replaces (JAX): the gini and variance cases of transmogrifai_tpu/models/
// trees.py:_fit_tree_compact's scan_chunk body (:331-357) — cumsum over
// bins, _gain_gini (:194-199) or _gain_variance (:186-191), the `ok` mask
// with the tree-level feature mask and the per-node subset drawn at
// :320-326, max/argmax over bins and then over feature chunks with strict
// `>` — the leaf flag and threshold that follow it (:364-366), the node's
// leaf values (_leaf_gini, :216-217; _leaf_variance, :212-213; written at
// :316) and the level's writes into the tree arrays and the per-feature
// gain sum (:365-372, :381).
//
// Gains, in the f32 order of the JAX package's expressions:
//   gini:     wgini(s) = cnt * (1 - sum_c (s_c / cnt)^2),  cnt = max(s_0, 1e-12)
//             gain = wgini(parent) - wgini(left) - wgini(right)
//   variance: sse(s) = s_2 - s_1^2 / max(s_0, 1e-12)   (s = (w, w·y, w·y²))
//             gain = sse(parent) - sse(left) - sse(right)
// with right = parent - left statistic by statistic, written with __f*_rn
// intrinsics so that nvcc contracts nothing into an FMA; the left side is
// the bin prefix in the JAX package's own order (XLA:CPU's cumsum: serial
// f32 sums within blocks of 16 bins, each block then adding the serial sum
// of the blocks before it), so the kernel gives the plain PyTorch twin's
// bits (tree_kernels.block_prefix).  A variance histogram row is three
// floats a bin, the staging width of a binary gini row (1 + C = 3).
//
// Design (tree_split.cu's layout).  A warp owns a (lane, node), or one of W
// chunks of its features where the level has too few nodes to fill the
// card.  A node whose count total is below 2·min_instances reads nothing
// (no split can leave min_instances on both sides: tree_split.cu's proof):
// it is a leaf with gain -inf, feature 0, bin 0, as the full scan gives it.
// Otherwise:
//  1. the warp compacts its chunk's features that the tree's mask and the
//     node's subset allow (a ballot over 32 features at a time) into groups
//     of at most FPS features, in feature order;
//  2. a group's candidate bins 0 .. NB-2 — the count and CT statistics a
//     bin (gini past 8 classes: one class chunk a stage) — arrive by
//     cp.async in one of the warp's two slices (a feature's row at a stride
//     = 1 mod 32, so that lanes on different features read different
//     banks), the next stage's copy in flight while the lanes work on this
//     one;
//  3. lane l takes feature l / ipf of the group and its HB bins (l % ipf):
//     it adds the bins before them (additions only, the JAX order), then
//     walks its HB bins computing the gain (a lane's bins may straddle two
//     blocks of 16), so a 5-feature subset keeps 30 lanes busy (HB = 6 at
//     32 bins) and not 5.  Past 8 classes each lane keeps its bins' sums of
//     squares over the class chunks, in class order;
//  4. the lane keeps its first max with a strict `>`; a warp reduction and
//     the W chunks' combination keep the highest gain, then the lowest
//     feature, then the lowest bin (split_level.cuh): the first max over
//     (feature, bin) of the JAX argmax.
// The node's first warp derives is_leaf (gain <= min_gain or non-finite)
// and the threshold splits[f, b], and with fit_trees' arrays given writes
// the level's feature (-1 on a leaf), threshold, is_leaf and leaf values
// (the mean label, or the C class shares of the node's totals, the JAX
// package's f32 division); a second kernel adds the split nodes' gains into
// gain[k, feature] in node order (split_level.cuh).
//
// Bound: device-memory bytes — one read of bins 0 .. NB-2 of the subset
// features' histograms of the nodes that can split ([w, NB, 1+C] f32 a
// node for w subset features; 1.9 KB at 5 features x 32 bins, binary or
// variance) and a few bytes per node in and out.
#pragma once
#include "split_level.cuh"

// sse of (count, sum, sum of squares) in _gain_variance's f32 order
__device__ __forceinline__ float split_sse(float c, float s1, float s2) {
  return __fsub_rn(s2, __fdiv_rn(__fmul_rn(s1, s1), fmaxf(c, 1e-12f)));
}

#define SPLIT_NODE_PARAMS \
    const float* __restrict__ hist, const float* __restrict__ totals, \
    const uint8_t* __restrict__ fmask, const uint8_t* __restrict__ node_mask, \
    const float* __restrict__ splits, const float* __restrict__ min_inst, \
    const float* __restrict__ min_gain, float* __restrict__ out_gain, \
    int32_t* __restrict__ out_feat, int32_t* __restrict__ out_bin, \
    uint8_t* __restrict__ out_leaf, float* __restrict__ out_thr, \
    int32_t* __restrict__ t_feat, float* __restrict__ t_thr, \
    uint8_t* __restrict__ t_leaf, float* __restrict__ t_value, int P, int D, \
    int NB, int C, int W, int fc, int FPS, int FST, int T, int offset
#define SPLIT_NODE_ARGS                                                  \
  hist, totals, fmask, node_mask, splits, min_inst, min_gain, out_gain,  \
      out_feat, out_bin, out_leaf, out_thr, t_feat, t_thr, t_leaf,       \
      t_value, P, D, NB, C, W, fc, FPS, FST, T, offset

// Up to FPS allowed features of [wbase + 32 .., d1) into flb, in order,
// from the warp's cursor (wbase, rem: the window's allowed features not yet
// taken); returns how many.  Warp-uniform.
__device__ __forceinline__ int gini_next_group(
    int* flb, int FPS, int& wbase, unsigned& rem, int d1,
    const uint8_t* __restrict__ fmask, const uint8_t* __restrict__ nm,
    int lane) {
  int n = 0;
  while (n < FPS) {
    if (rem == 0u) {
      wbase += 32;
      if (wbase >= d1) break;
      const int d = wbase + lane;
      const bool ok = d < d1 && fmask[d] && (nm == nullptr || nm[d]);
      rem = __ballot_sync(SPLIT_FULL, ok);
      continue;
    }
    const int take = min(__popc(rem), FPS - n);
    const int rank = __popc(rem & ((1u << lane) - 1u));
    if (((rem >> lane) & 1u) && rank < take) flb[n + rank] = wbase + lane;
    n += take;
    for (int t = 0; t < take; ++t) rem &= rem - 1u;
  }
  __syncwarp();
  return n;
}

// Stage (group features flb[0..n), class chunk from c0): bins 0 .. NB-2 of
// the count and ctn classes into dst at row stride FST; one commit group
// (an empty one when n == 0, so that "all but the last" waits work)
__device__ __forceinline__ void gini_stage_copy(float* dst, const float* h,
                                                const int* flb, int n, int NB,
                                                int S, int c0, int ctn,
                                                int FST, int lane) {
  const int SP = 1 + ctn, per = (NB - 1) * SP;
  for (int i = 0; i < n; ++i) {
    const float* src = h + (long long)flb[i] * NB * S;
    float* d = dst + i * FST;
    if (SP == S) {                    // every class: the row is contiguous
      for (int r = lane; r < per; r += 32) cp_async4(d + r, src + r);
    } else {
      for (int r = lane; r < per; r += 32) {
        const int b = r / SP, s = r - b * SP;
        cp_async4(d + r, src + b * S + (s ? c0 + s : 0));
      }
    }
  }
  cp_async_commit();
}

// The body of one block: CT classes a stage, HB bins a lane; VAR the
// variance impurity (S = 3 statistics (w, w·y, w·y²), CT = 2: one stage a
// group), else gini over C classes
template <int CT, int HB, bool VAR>
__device__ __forceinline__ void split_node_body(
    const float* __restrict__ hist, const float* __restrict__ totals,
    const uint8_t* __restrict__ fmask, const uint8_t* __restrict__ node_mask,
    const float* __restrict__ splits, const float* __restrict__ min_inst,
    const float* __restrict__ min_gain, float* __restrict__ out_gain,
    int32_t* __restrict__ out_feat, int32_t* __restrict__ out_bin,
    uint8_t* __restrict__ out_leaf, float* __restrict__ out_thr,
    int32_t* __restrict__ t_feat, float* __restrict__ t_thr,
    uint8_t* __restrict__ t_leaf, float* __restrict__ t_value, int P, int D,
    int NB, int C, int W, int fc, int FPS, int FST, int T, int offset) {
  extern __shared__ float s_dyn[];     // each warp's two slices and lists
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.y;
  const int slot = warp / W, c = warp - slot * W;
  const int p = blockIdx.x * ((blockDim.x >> 5) / W) + slot;
  const bool valid = p < P;
  const long long node = (long long)k * P + p;
  const int S = C + 1;
  const float mi = min_inst[k];
  const int d0 = c * fc, d1 = min(D, d0 + fc);
  const int SL = FPS * FST;                     // floats a slice
  float* sw = s_dyn + warp * (2 * SL + 2 * FPS);
  int* fl = (int*)(sw + 2 * SL);                // [2][FPS] the groups' features
  const int ipf = (NB - 1 + HB - 1) / HB;       // lanes a feature
  const int nCC = (C + CT - 1) / CT;            // class chunks
  float best = -INFINITY;
  int bf = INT_MAX, bb = 0;
  const float* tn = totals + node * S;
  const float pc = valid ? tn[0] : 0.f;
  if (valid && d0 < d1 && pc >= 2.0f * mi) {
    // the parent's impurity: its sse, or its weighted gini (classes in
    // order)
    float wpar;
    if (VAR) {
      wpar = split_sse(pc, tn[1], tn[2]);
    } else {
      const float pcnt = fmaxf(pc, 1e-12f);
      float psq = 0.f;
      for (int j = 0; j < C; ++j) {
        const float q = __fdiv_rn(tn[1 + j], pcnt);
        psq = __fadd_rn(psq, __fmul_rn(q, q));
      }
      wpar = __fmul_rn(pcnt, __fsub_rn(1.f, psq));
    }
    const uint8_t* nm = node_mask ? node_mask + node * D : nullptr;
    const float* h = hist + node * D * NB * S;
    int wbase = d0 - 32;
    unsigned rem = 0u;
    // stage s = (group g, class chunk cc); the group lists alternate
    int g = 0, cc = 0;
    int n = gini_next_group(fl, FPS, wbase, rem, d1, fmask, nm, lane);
    gini_stage_copy(sw, h, fl, n, NB, S, 0, min(CT, C), FST, lane);
    // this lane's feature slot and bins
    const int i = lane / ipf, b0 = (lane - i * ipf) * HB;
    const int b1 = min(b0 + HB, NB - 1);
    float lsq[HB], rsq[HB];
    for (int s = 0; n > 0; ++s) {
      // the next stage: the group's next class chunk, or the next group
      int ng = g, ncc = cc + 1, nn = n;
      if (ncc == nCC) {
        ng = g + 1;
        ncc = 0;
        nn = gini_next_group(fl + (ng & 1) * FPS, FPS, wbase, rem, d1, fmask,
                             nm, lane);
      }
      gini_stage_copy(sw + ((s + 1) & 1) * SL, h, fl + (ng & 1) * FPS, nn,
                      NB, S, ncc * CT, min(CT, C - ncc * CT), FST, lane);
      cp_async_wait_prev();
      __syncwarp();
      const int c0 = cc * CT, ctn = min(CT, C - c0), SP = 1 + ctn;
      if (i < n) {
        const float* x = sw + (s & 1) * SL + i * FST;
        const int f = fl[(g & 1) * FPS + i];
        float pv[CT];
#pragma unroll
        for (int j = 0; j < CT; ++j) pv[j] = j < ctn ? tn[1 + c0 + j] : 0.f;
        // the bins before b0: each whole block of 16 serially (its
        // loads unrolled ahead of the adds) into the blocks' running sum,
        // then the start of b0's block
        float ib[1 + CT], ob[1 + CT];
#pragma unroll
        for (int j = 0; j <= CT; ++j) ib[j] = ob[j] = 0.f;
        for (int b16 = 0; b16 + 16 <= b0; b16 += 16) {
          float t[1 + CT];
#pragma unroll
          for (int j = 0; j <= CT; ++j) t[j] = 0.f;
#pragma unroll
          for (int u = 0; u < 16; ++u)
#pragma unroll
            for (int j = 0; j <= CT; ++j)
              if (j <= ctn) t[j] = __fadd_rn(t[j], x[(b16 + u) * SP + j]);
#pragma unroll
          for (int j = 0; j <= CT; ++j) ob[j] = __fadd_rn(ob[j], t[j]);
        }
#pragma unroll 4
        for (int b = b0 & ~15; b < b0; ++b)
#pragma unroll
          for (int j = 0; j <= CT; ++j)
            if (j <= ctn) ib[j] = __fadd_rn(ib[j], x[b * SP + j]);
        const bool last = cc == nCC - 1;
#pragma unroll
        for (int hb = 0; hb < HB; ++hb) {
          const int b = b0 + hb;
          if (cc == 0) lsq[hb] = rsq[hb] = 0.f;
          if (b < b1) {
            if ((b & 15) == 0 && b) {
#pragma unroll
              for (int j = 0; j <= CT; ++j) { ob[j] = __fadd_rn(ob[j], ib[j]); ib[j] = 0.f; }
            }
            float l[1 + CT];
#pragma unroll
            for (int j = 0; j <= CT; ++j) {
              if (j <= ctn) ib[j] = __fadd_rn(ib[j], x[b * SP + j]);
              l[j] = __fadd_rn(ib[j], ob[j]);
            }
            const float lc = l[0], rc = __fsub_rn(pc, lc);
            if (VAR) {
              // _gain_variance: right = parent - left, statistic by
              // statistic
              const float gain = __fsub_rn(
                  __fsub_rn(wpar, split_sse(lc, l[1], l[2])),
                  split_sse(rc, __fsub_rn(pv[0], l[1]),
                            __fsub_rn(pv[1], l[2])));
              if (lc >= mi && rc >= mi && gain > best) {
                best = gain; bf = f; bb = b;
              }
              continue;
            }
            const float cl = fmaxf(lc, 1e-12f), cr = fmaxf(rc, 1e-12f);
#pragma unroll
            for (int j = 0; j < CT; ++j) {
              if (j < ctn) {
                const float ql = __fdiv_rn(l[1 + j], cl);
                lsq[hb] = __fadd_rn(lsq[hb], __fmul_rn(ql, ql));
                const float qr = __fdiv_rn(__fsub_rn(pv[j], l[1 + j]), cr);
                rsq[hb] = __fadd_rn(rsq[hb], __fmul_rn(qr, qr));
              }
            }
            if (last) {
              const float wl = __fmul_rn(cl, __fsub_rn(1.f, lsq[hb]));
              const float wr = __fmul_rn(cr, __fsub_rn(1.f, rsq[hb]));
              const float gain = __fsub_rn(__fsub_rn(wpar, wl), wr);
              if (lc >= mi && rc >= mi && gain > best) {
                best = gain; bf = f; bb = b;
              }
            }
          }
        }
      }
      __syncwarp();                     // the slice is copied into next
      g = ng;
      cc = ncc;
      n = nn;
    }
  }
  split_warp_best(best, bf, bb);
  if (W > 1) split_chunk_best(best, bf, bb, W, warp, slot, c, lane);
  if (!(best > -INFINITY)) { bf = 0; bb = 0; }  // no allowed split
  if (valid && c == 0) {
    const bool leaf = !(isfinite(best) && best > min_gain[k]);
    const float thr =
        splits[(long long)bf * (NB - 1) + min(max(bb, 0), NB - 2)];
    if (lane == 0) {
      out_gain[node] = best;
      out_feat[node] = bf;
      out_bin[node] = bb;
      out_leaf[node] = leaf ? 1 : 0;
      out_thr[node] = thr;
    }
    if (t_feat) {
      const long long t = (long long)k * T + offset + p;
      if (lane == 0) split_write_node(t_feat, t_thr, t_leaf, t, leaf, bf, thr);
      // the leaf values: the mean label (_leaf_variance), or the class
      // shares (_leaf_gini)
      const float cnt = fmaxf(tn[0], 1e-12f);
      const int V = VAR ? 1 : C;
      for (int j = lane; j < V; j += 32)
        t_value[t * V + j] = __fdiv_rn(tn[1 + j], cnt);
    }
  }
}

typedef void (*SplitNodeKernel)(
    const float*, const float*, const uint8_t*, const uint8_t*,
    const float*, const float*, const float*, float*, int32_t*, int32_t*,
    uint8_t*, float*, int32_t*, float*, uint8_t*, float*, int, int, int, int,
    int, int, int, int, int, int);

// One split level of K lanes x P nodes through `kern` (the entry point's
// instantiation for its impurity, ct statistics a stage and hb bins a
// lane); checks the plan's ints as the entry points' comments give them and
// returns a cudaError_t.
static int split_node_launch(
    SplitNodeKernel kern, const void* hist, const void* totals,
    const void* fmask, const void* node_mask, const void* splits,
    const void* min_inst, const void* min_gain, void* out_gain,
    void* out_feat, void* out_bin, void* out_leaf, void* out_thr,
    void* t_feat, void* t_thr, void* t_leaf, void* t_value, void* t_gain,
    int K, int P, int D, int NB, int C, int ct, int hb, int W, int fc,
    int FPS, int FST, int threads, int T, int offset, int smem,
    void* stream) {
  const int ipf = (NB - 1 + hb - 1) / max(hb, 1);
  if (kern == nullptr || NB > 127 || NB < 2 || C < 2 || K < 1 ||
      K > 65535 || P < 1 || D < 1 || fc < 1 || W < 1 || W > SPLIT_MAX_W ||
      (W & (W - 1)) || threads > 256 || threads % (32 * W) ||
      (long long)W * fc < D || FPS < 1 || FPS * ipf > 32 ||
      FST < (NB - 1) * (1 + min(ct, C)) ||
      (long long)smem < 4LL * (threads / 32) * (2 * FPS * FST + 2 * FPS) ||
      (t_feat && (!t_thr || !t_leaf || !t_value || offset + P > T)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int per_block = threads / 32 / W;
  dim3 grid((P + per_block - 1) / per_block, K);
  const cudaStream_t s = (cudaStream_t)stream;
  kern<<<grid, threads, (size_t)smem, s>>>(
      (const float*)hist, (const float*)totals, (const uint8_t*)fmask,
      (const uint8_t*)node_mask, (const float*)splits,
      (const float*)min_inst, (const float*)min_gain, (float*)out_gain,
      (int32_t*)out_feat, (int32_t*)out_bin, (uint8_t*)out_leaf,
      (float*)out_thr, (int32_t*)t_feat, (float*)t_thr, (uint8_t*)t_leaf,
      (float*)t_value, P, D, NB, C, W, fc, FPS, FST, T, offset);
  if (t_gain)
    tree_split_gain_kernel<<<K, 256, 0, s>>>(
        (const float*)out_gain, (const int32_t*)out_feat,
        (const uint8_t*)out_leaf, (float*)t_gain, P, D);
  return (int)cudaGetLastError();
}
