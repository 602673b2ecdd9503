// tree_split — best split per (lane, node) from a level's histograms.
//
// Replaces (JAX): the rest of transmogrifai_tpu/models/trees.py:
// _fit_tree_compact's scan_chunk body (:339-356) — cumsum over bins,
// _gain_xgb (:202-209), the `ok` mask, max/argmax over bins and then over
// feature chunks with strict `>` — and the leaf flag, threshold and
// _leaf_xgb leaf value that follow it (:358-364, :220-221).
//
// Design: one block per (node, lane); warp w takes features w, w+nwarps, ...
// and lane b holds bin b (NB <= 32), so the prefix over bins is a warp
// shuffle scan and the argmax over bins a warp reduction that keeps the
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
      float c = 0.f, g = 0.f, hh = 0.f;
      if (lane < NB) {
        c = h[lane * 3 + 0];
        g = h[lane * 3 + 1];
        hh = h[lane * 3 + 2];
      }
      // inclusive prefix over bins
      for (int off = 1; off < 32; off <<= 1) {
        const float c2 = __shfl_up_sync(0xffffffffu, c, off);
        const float g2 = __shfl_up_sync(0xffffffffu, g, off);
        const float h2 = __shfl_up_sync(0xffffffffu, hh, off);
        if (lane >= off) { c += c2; g += g2; hh += h2; }
      }
      const float rc = pc - c, rg = pg - g, rh = ph - hh;
      float gain = 0.5f * ((g * g / (hh + lam) + rg * rg / (rh + lam))
                           - parent_score);
      const bool ok = lane < NB - 1 && c >= mi && rc >= mi && fmask[d];
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
        fg[dl] = gain;
        fb[dl] = gain == -INFINITY ? 0 : bin;
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
  if (NB > 32 || NB < 2 || dc < 1 || P > 65535 || K > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(P, K);
  tree_split_kernel<<<grid, threads, 2 * dc * sizeof(float),
                      (cudaStream_t)stream>>>(
      (const float*)hist, (const float*)totals, (const uint8_t*)fmask,
      (const float*)splits, (const float*)min_inst, (const float*)min_gain,
      (const float*)lam, (float*)out_gain, (int32_t*)out_feat,
      (int32_t*)out_bin, (uint8_t*)out_leaf, (float*)out_thr,
      (float*)out_value, P, D, NB, dc);
  return (int)cudaGetLastError();
}
