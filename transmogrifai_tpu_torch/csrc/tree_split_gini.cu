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
// features w, w+nwarps, ...; lane l holds bins l*Q .. l*Q+Q-1 (Q =
// ceil(NB/32), NB <= 127; split_scan.cuh), so the prefix over bins is each
// lane's running sum plus a warp shuffle scan, and the argmax over bins a
// reduction that keeps the LOWEST bin on equal gain.  A feature outside the
// tree mask or the node's subset skips its histogram read (warp-uniform
// branch).  The features pass in chunks of `dc` (dynamic shared memory);
// after each chunk thread 0 walks its per-feature winners in feature order
// with a strict `>` against the running best, so equal gains resolve to the
// lowest feature and an earlier chunk wins ties — the first-max rule of the
// JAX argmax over feature chunks.  Any D runs.
//
// Classes: with C <= CT (CT a template parameter, 2, 4 or 8, chosen by the
// wrapper's split_plan; ONE = true) the counts and all classes are scanned
// together in registers and the parent's totals are held in registers, so
// binary gini (CT = 2, whose C is 2) compiles to one unrolled scan of three
// sums.  Past 8 classes (ONE = false) they pass in chunks of CT: each chunk's
// running sums are scanned over bins in registers and its squares added to
// the left and right sums of squares in class order.  Either way the order
// of the sum is the twin's, and classes past C read as zero counts: each
// adds (0/cnt)^2 = 0 to the sum, which leaves it unchanged.
//
// Bound: device-memory bytes — one read of the [K, P, D, NB, 1+C] histogram
// (at the forest's deepest level, 60 lanes x 32 nodes x 28 features x 32 bins
// x 3 stats: 20.6 MB) plus the node masks and a few bytes per node out.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_scan.cuh"

// the squares of the CT values s_c / cnt, added to sq in class order
template <int CT>
__device__ __forceinline__ float add_squares(float sq, const float* s,
                                             float cnt) {
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    const float q = __fdiv_rn(s[c], cnt);
    sq = __fadd_rn(sq, __fmul_rn(q, q));
  }
  return sq;
}

template <int CT, bool ONE, int Q>
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
                                       int P, int D, int NB, int Cr, int dc) {
  extern __shared__ float fg[];          // [dc] gains, then [dc] bins
  int* fb = (int*)(fg + dc);
  const int C = ONE && CT == 2 ? 2 : Cr;   // CT = 2 holds exactly 2 classes
  const int S = C + 1;
  const int p = blockIdx.x, k = blockIdx.y;
  const long long node = (long long)k * P + p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float mi = min_inst[k];
  const float* par_g = totals + node * S;
  float par[1 + CT];                     // ONE: the parent's totals, padded
#pragma unroll
  for (int j = 0; j <= CT; ++j) par[j] = ONE && j <= C ? par_g[j] : 0.f;
  const float pcnt = fmaxf(par_g[0], 1e-12f);
  float psq = 0.f;
  for (int c = 0; c < C; ++c) {
    const float q = __fdiv_rn(par_g[1 + c], pcnt);
    psq = __fadd_rn(psq, __fmul_rn(q, q));
  }
  const float wpar = __fmul_rn(pcnt, __fsub_rn(1.f, psq));
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
      const float* h = hist + (node * D + d) * NB * S;
      float lc[Q], rc[Q], lsq[Q], rsq[Q];
      if (ONE) {
        // the count and every class: one prefix over bins
        float l[Q][1 + CT];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int b = lane * Q + q;
#pragma unroll
          for (int j = 0; j <= CT; ++j)
            l[q][j] = b < NB && j <= C ? h[b * S + j] : 0.f;
        }
        bin_prefix<Q, 1 + CT>(l, lane);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          float r[1 + CT];
#pragma unroll
          for (int j = 0; j <= CT; ++j) r[j] = __fsub_rn(par[j], l[q][j]);
          lc[q] = l[q][0];
          rc[q] = r[0];
          lsq[q] = add_squares<CT>(0.f, l[q] + 1, fmaxf(lc[q], 1e-12f));
          rsq[q] = add_squares<CT>(0.f, r + 1, fmaxf(rc[q], 1e-12f));
        }
      } else {
        // the counts: prefix over bins; then the classes CT at a time
        float cnt[Q][1];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int b = lane * Q + q;
          cnt[q][0] = b < NB ? h[b * S] : 0.f;
        }
        bin_prefix<Q, 1>(cnt, lane);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          lc[q] = cnt[q][0];
          rc[q] = __fsub_rn(par_g[0], lc[q]);
          lsq[q] = rsq[q] = 0.f;
        }
        for (int c0 = 0; c0 < C; c0 += CT) {
          float l[Q][CT];
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int b = lane * Q + q;
#pragma unroll
            for (int j = 0; j < CT; ++j)
              l[q][j] = b < NB && c0 + j < C ? h[b * S + 1 + c0 + j] : 0.f;
          }
          bin_prefix<Q, CT>(l, lane);
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            float r[CT];
#pragma unroll
            for (int j = 0; j < CT; ++j)
              r[j] = c0 + j < C ? __fsub_rn(par_g[1 + c0 + j], l[q][j]) : 0.f;
            lsq[q] = add_squares<CT>(lsq[q], l[q], fmaxf(lc[q], 1e-12f));
            rsq[q] = add_squares<CT>(rsq[q], r, fmaxf(rc[q], 1e-12f));
          }
        }
      }
      float gq[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float wl = __fmul_rn(fmaxf(lc[q], 1e-12f),
                                   __fsub_rn(1.f, lsq[q]));
        const float wr = __fmul_rn(fmaxf(rc[q], 1e-12f),
                                   __fsub_rn(1.f, rsq[q]));
        const float gain = __fsub_rn(__fsub_rn(wpar, wl), wr);
        const bool ok = lane * Q + q < NB - 1 && lc[q] >= mi && rc[q] >= mi;
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

template <int CT, bool ONE, int Q>
static cudaError_t launch_q(const void* hist, const void* totals,
                          const void* fmask, const void* node_mask,
                          const void* splits, const void* min_inst,
                          const void* min_gain, void* out_gain,
                          void* out_feat, void* out_bin, void* out_leaf,
                          void* out_thr, int K, int P, int D, int NB, int C,
                          int dc, int threads, cudaStream_t stream) {
  dim3 grid(P, K);
  tree_split_gini_kernel<CT, ONE, Q><<<grid, threads,
                                       2 * dc * sizeof(float), stream>>>(
      (const float*)hist, (const float*)totals, (const uint8_t*)fmask,
      (const uint8_t*)node_mask, (const float*)splits,
      (const float*)min_inst, (const float*)min_gain, (float*)out_gain,
      (int32_t*)out_feat, (int32_t*)out_bin, (uint8_t*)out_leaf,
      (float*)out_thr, P, D, NB, C, dc);
  return cudaGetLastError();
}

template <int CT, bool ONE>
static cudaError_t launch(const void* hist, const void* totals,
                          const void* fmask, const void* node_mask,
                          const void* splits, const void* min_inst,
                          const void* min_gain, void* out_gain,
                          void* out_feat, void* out_bin, void* out_leaf,
                          void* out_thr, int K, int P, int D, int NB, int C,
                          int dc, int threads, cudaStream_t stream) {
  switch (split_q(NB)) {
    case 1:
      return launch_q<CT, ONE, 1>(hist, totals, fmask, node_mask, splits,
                                  min_inst, min_gain, out_gain, out_feat,
                                  out_bin, out_leaf, out_thr, K, P, D, NB, C,
                                  dc, threads, stream);
    case 2:
      return launch_q<CT, ONE, 2>(hist, totals, fmask, node_mask, splits,
                                  min_inst, min_gain, out_gain, out_feat,
                                  out_bin, out_leaf, out_thr, K, P, D, NB, C,
                                  dc, threads, stream);
    default:
      return launch_q<CT, ONE, 4>(hist, totals, fmask, node_mask, splits,
                                  min_inst, min_gain, out_gain, out_feat,
                                  out_bin, out_leaf, out_thr, K, P, D, NB, C,
                                  dc, threads, stream);
  }
}

extern "C" int tree_split_gini_launch(const void* hist, const void* totals,
                                      const void* fmask,
                                      const void* node_mask,
                                      const void* splits,
                                      const void* min_inst,
                                      const void* min_gain, void* out_gain,
                                      void* out_feat, void* out_bin,
                                      void* out_leaf, void* out_thr, int K,
                                      int P, int D, int NB, int C, int ct,
                                      int dc, int threads, void* stream) {
  if (NB > 127 || NB < 2 || C < 1 || dc < 1 || P > 65535 || K > 65535 ||
      (ct == 2 && C != 2) || (ct == 4 && C > 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // ct is the smallest of 2 / 4 / 8 that holds C, else 8 (chunks)
  switch (ct) {
    case 2: return (int)launch<2, true>(hist, totals, fmask, node_mask,
                                        splits, min_inst, min_gain, out_gain,
                                        out_feat, out_bin, out_leaf, out_thr,
                                        K, P, D, NB, C, dc, threads, s);
    case 4: return (int)launch<4, true>(hist, totals, fmask, node_mask,
                                        splits, min_inst, min_gain, out_gain,
                                        out_feat, out_bin, out_leaf, out_thr,
                                        K, P, D, NB, C, dc, threads, s);
    case 8:
      if (C <= 8)
        return (int)launch<8, true>(hist, totals, fmask, node_mask, splits,
                                    min_inst, min_gain, out_gain, out_feat,
                                    out_bin, out_leaf, out_thr, K, P, D, NB,
                                    C, dc, threads, s);
      return (int)launch<8, false>(hist, totals, fmask, node_mask, splits,
                                   min_inst, min_gain, out_gain, out_feat,
                                   out_bin, out_leaf, out_thr, K, P, D, NB, C,
                                   dc, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
