// loco_linear — leave-one-covariate-out explanations of a linear model
// (logistic regression, linear SVC or linear regression) with each row's
// top-K groups.
//
// Replaces (JAX): transmogrifai_tpu/record_insights.py:_device_topk's `loco`
// program (:140-160) on a linear model: the base forward, a lax.map of G
// masked forwards score(X * m_g) over the [G, D] group masks, the [N, G]
// diffs and lax.top_k.  The TPU form re-reads X once per group so that
// [G, N, D] is never formed in HBM.
//
// Here the model is linear, so zeroing group g's columns removes exactly
// c_g = sum_{j in g} x_j w_j from the margin m = x . w + b: each row needs
// one read of its own columns, and
//   score_g = link(m - c_g),  diff_g = link(m) - score_g,
// with link the sigmoid (logistic), the identity (an SVC's margin, a
// linear regression's prediction) or a GLM's inverse link of the margin
// clipped to [-30, 30] (linear.py:186-189): exp (poisson, gamma), the
// sigmoid (binomial) or the identity (gaussian).  Only the
// f32 summation order differs from the reference's masked forwards, and a
// group whose columns are all zero has c_g = 0 and a diff of exactly 0.
//
// Design: one warp per row (grid-stride over rows).  The wrapper hands the
// columns sorted by group (`perm`, their groups `sgid`, group g at
// perm[goff[g] .. goff[g+1]); `perm` null when the groups are already
// contiguous, as transmogrify lays them out).  The warp reads 4 x 32 of
// them at a time (four loads in flight a lane), each lane one column's
// x_j w_j a chunk — or, over a whole row of contiguous groups with D a
// multiple of 4, 2 x 128 at a time as float4 reads (`vec4`).  A chunk
// inside one group adds to lane partials that a butterfly of shuffles sums
// into the group's slot in shared memory when the group ends; a chunk that
// crosses groups is summed by a segmented shuffle scan, each run's last
// lane adding it to its group's slot (one writer a slot a step, in a fixed
// order: the same bits every launch).
// Groups pass in windows of `gw` slots (loco_plan): with one window the
// same pass sums the margin; with several a first pass does.  Then lane i
// takes group g0 + i of each 32: its diff goes to the warp's top-K
// (loco_topk.cuh).  X is read from device memory once.
//
// Bound: device-memory bytes — X read once (4 N D) and the [N, K] output
// written once (8 N K); 6.4 GB at 1M x 1,596, ~1.9 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include "loco_topk.cuh"

#define UNROLL 4                 // column chunks a warp reads at once
#define UNROLL4 2                // float4 chunks a warp reads at once

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(LOCO_FULL, v, off));
  return v;
}

// link codes (insights_kernels.LINKS): 0 sigmoid, 1 identity, and of the
// margin clipped to [-30, 30]: 2 exp, 3 sigmoid, 4 identity
__device__ __forceinline__ float linear_link(float m, int link) {
  if (link == 0) return loco_sigmoid(m);
  if (link == 1) return m;
  const float c = fminf(fmaxf(m, -30.f), 30.f);
  return link == 2 ? expf(c) : (link == 3 ? loco_sigmoid(c) : c);
}

// lane partials of one group, flushed into the group's slot when the run
// of chunks inside that group ends
struct Run {
  float sum;
  int key;
};

__device__ __forceinline__ void run_add(Run& r, float* c, int g0, int key,
                                        float v, int lane) {
  if (key != r.key) {
    if (r.key >= 0) {
      const float sum = warp_sum(r.sum);
      if (lane == 0) c[r.key - g0] = __fadd_rn(c[r.key - g0], sum);
    }
    r.sum = 0.f;
    r.key = key;
  }
  r.sum = __fadd_rn(r.sum, v);
}

// an inclusive scan within runs of one group across the lanes (keys sorted
// by lane: a run is contiguous, so an equal key `off` lanes back is in the
// run); each run's last lane adds it to its group's slot.  Lanes whose key
// is G hold no column.
__device__ __forceinline__ void segment_add(float* c, int g0, int G, int key,
                                            float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float tv = __shfl_up_sync(LOCO_FULL, v, off);
    const int tk = __shfl_up_sync(LOCO_FULL, key, off);
    if (lane >= off && tk == key) v = __fadd_rn(v, tv);
  }
  const int next = __shfl_down_sync(LOCO_FULL, key, 1);
  if (key < G && (lane == 31 || next != key))
    c[key - g0] = __fadd_rn(c[key - g0], v);
}

// the group sums of columns [j0, j1) of row x into c (window g0), one
// column a lane a chunk, UNROLL chunks of 32 in flight; returns the lane's
// share of the margin
__device__ __forceinline__ float sum_groups(const float* x, const float* w,
                                            const int32_t* perm,
                                            const int32_t* sgid, float* c,
                                            int g0, int G, int j0, int j1,
                                            int lane) {
  float part = 0.f;
  Run run{0.f, -1};
  for (; j0 < j1; j0 += 32 * UNROLL) {
    float v[UNROLL];
    int key[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + 32 * u + lane;
      key[u] = G;                      // past every group: no column
      v[u] = 0.f;
      if (j < j1) {
        const int col = perm ? perm[j] : j;
        v[u] = __fmul_rn(x[col], w[col]);
        key[u] = sgid[j];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      part = __fadd_rn(part, v[u]);
      const int k0 = __shfl_sync(LOCO_FULL, key[u], 0);
      if (__all_sync(LOCO_FULL, key[u] == k0) && k0 < G)
        run_add(run, c, g0, k0, v[u], lane);     // a chunk in one group
      else
        segment_add(c, g0, G, key[u], v[u], lane);
      __syncwarp();
    }
  }
  run_add(run, c, g0, -1, 0.f, lane);            // flush
  return part;
}

// the same over a whole row of contiguous groups, four columns a lane a
// chunk of 128 (float4 reads; D % 4 == 0 and X, w 16-byte aligned)
__device__ __forceinline__ float sum_groups4(const float* x, const float* w,
                                             const int32_t* sgid, float* c,
                                             int G, int D, int lane) {
  float part = 0.f;
  Run run{0.f, -1};
  for (int j0 = 0; j0 < D; j0 += 128 * UNROLL4) {
    float4 p[UNROLL4];
#pragma unroll
    for (int u = 0; u < UNROLL4; ++u) {
      const int j = j0 + 128 * u + 4 * lane;
      p[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < D) {
        const float4 xv = *reinterpret_cast<const float4*>(x + j);
        const float4 wv = *reinterpret_cast<const float4*>(w + j);
        p[u] = make_float4(__fmul_rn(xv.x, wv.x), __fmul_rn(xv.y, wv.y),
                           __fmul_rn(xv.z, wv.z), __fmul_rn(xv.w, wv.w));
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL4; ++u) {
      const int first = j0 + 128 * u;
      if (first >= D) break;                     // warp-uniform
      const int last = min(first + 127, D - 1);
      const float q = __fadd_rn(__fadd_rn(p[u].x, p[u].y),
                                __fadd_rn(p[u].z, p[u].w));
      part = __fadd_rn(part, q);
      const int kf = sgid[first];
      if (kf == sgid[last]) {
        run_add(run, c, 0, kf, q, lane);         // a chunk in one group
      } else {
        const int j = first + 4 * lane;
        const bool in = j < D;
        const int ka = in ? sgid[j] : G;
        if (__all_sync(LOCO_FULL, !in || ka == sgid[j + 3])) {
          segment_add(c, 0, G, ka, q, lane);     // each lane in one group
        } else {
          segment_add(c, 0, G, ka, p[u].x, lane);
          __syncwarp();
          segment_add(c, 0, G, in ? sgid[j + 1] : G, p[u].y, lane);
          __syncwarp();
          segment_add(c, 0, G, in ? sgid[j + 2] : G, p[u].z, lane);
          __syncwarp();
          segment_add(c, 0, G, in ? sgid[j + 3] : G, p[u].w, lane);
        }
      }
      __syncwarp();
    }
  }
  run_add(run, c, 0, -1, 0.f, lane);             // flush
  return part;
}

__global__ void loco_linear_kernel(const float* __restrict__ X,
                                   const float* __restrict__ w, float b,
                                   const int32_t* __restrict__ perm,
                                   const int32_t* __restrict__ sgid,
                                   const int32_t* __restrict__ goff,
                                   float* __restrict__ out_val,
                                   int32_t* __restrict__ out_idx,
                                   long long N, int D, int G, int K,
                                   int strategy, int link, int gw,
                                   int vec4) {
  extern __shared__ float csm[];
  float* c = csm + (threadIdx.x >> 5) * gw;      // this warp's group slots
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * blockDim.x
                           + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long n = first; n < N; n += n_warps) {
    const float* x = X + n * D;
    float m = 0.f;
    if (G > gw) {                      // several windows: the margin first
      float part = 0.f;
      for (int j = lane; j < D; j += 32)
        part = __fadd_rn(part, __fmul_rn(x[j], w[j]));
      m = __fadd_rn(warp_sum(part), b);
    }
    WarpTopK t = loco_topk_init(K, strategy, out_val + n * K,
                                out_idx + n * K);
    for (int g0 = 0; g0 < G; g0 += gw) {
      const int g1 = min(G, g0 + gw);
      for (int i = lane; i < g1 - g0; i += 32) c[i] = 0.f;
      __syncwarp();
      const float part =
          vec4 ? sum_groups4(x, w, sgid, c, G, D, lane)
               : sum_groups(x, w, perm, sgid, c, g0, G, goff[g0], goff[g1],
                            lane);
      __syncwarp();
      if (G <= gw) m = __fadd_rn(warp_sum(part), b);
      const float base = linear_link(m, link);
      for (int gb = g0; gb < g1; gb += 32) {
        const int g = gb + lane;
        const bool valid = g < g1;
        const float cg = valid ? c[g - g0] : 0.f;
        loco_topk_offer(t, valid, g,
                        __fsub_rn(base, linear_link(__fsub_rn(m, cg), link)));
      }
      __syncwarp();
    }
    loco_topk_write(t);
  }
}

extern "C" int loco_linear_launch(const void* X, const void* w, float b,
                                  const void* perm, const void* sgid,
                                  const void* goff, void* out_val,
                                  void* out_idx, long long N, int D, int G,
                                  int K, int strategy, int link, int gw,
                                  int vec4, int blocks, int threads,
                                  void* stream) {
  if (K < 1 || K > G || gw < 1 || threads % 32 || strategy < 0 ||
      strategy > 2 || link < 0 || link > 4 ||
      (vec4 && (G > gw || perm != nullptr || D % 4 != 0 ||
                (uintptr_t)X % 16 != 0 || (uintptr_t)w % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(threads / 32) * gw * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        loco_linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  loco_linear_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)w, b, (const int32_t*)perm,
      (const int32_t*)sgid, (const int32_t*)goff, (float*)out_val,
      (int32_t*)out_idx, N, D, G, K, strategy, link, gw, vec4);
  return (int)cudaGetLastError();
}
