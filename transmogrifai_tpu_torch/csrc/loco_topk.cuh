// loco_topk.cuh — a row's top-K of leave-one-covariate-out diffs, kept by
// the warp that computes them, or by the thread that owns the row
// (loco_push on a list of its own); shared by loco_linear.cu, loco_tree.cu
// and loco_softmax.cu.
//
// Replaces (JAX): the lax.top_k over the [N, G] diff matrix in
// transmogrifai_tpu/record_insights.py:_device_topk (:150-158).  On the TPU
// the whole [N, G] matrix is formed and then sorted; here the warp that owns
// a row offers its diffs 32 groups at a time (lane i: group g0 + i) and keeps
// the K best, so the matrix is never written.
//
// Order: by rank, highest first; rank(d) = |d| for strategy 0 ("abs"), d for
// 1 ("positive"), -d for 2 ("negative").  Groups are offered in increasing
// order, so a candidate whose rank EQUALS a listed one goes after it: ties
// resolve to the lower group index, as lax.top_k resolves them.
//
// K <= 32: the list lives in registers, lane i holding place i.  A batch's
// lanes that beat the K-th rank (or all, while the list fills) insert one by
// one in lane order: a ballot counts the places ahead of the candidate and
// one shuffle moves the places behind it down.  K > 32: lane 0 inserts into
// the row's output slice in device memory (an insertion sort, slow; only
// explanations that ask for more than 32 groups take it).
#pragma once
#include <math.h>
#include <stdint.h>

#define LOCO_FULL 0xffffffffu

__device__ __forceinline__ float loco_rank(float d, int strategy) {
  return strategy == 0 ? fabsf(d) : (strategy == 1 ? d : -d);
}

// the logistic link, in the f32 order torch.sigmoid rounds in
__device__ __forceinline__ float loco_sigmoid(float m) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-m)));
}

// insert (g, d) into the sorted list of n <= k entries at val / idx, entry
// i at val[i * stride] (a thread's own list in a block's interleaved slab)
__device__ __forceinline__ void loco_push(float* val, int32_t* idx, int k,
                                          int& n, int strategy, int g,
                                          float d, int stride = 1) {
  const float key = loco_rank(d, strategy);
  int i;
  if (n < k) {
    i = n++;
  } else if (key > loco_rank(val[(k - 1) * stride], strategy)) {
    i = k - 1;
  } else {
    return;
  }
  while (i > 0 && key > loco_rank(val[(i - 1) * stride], strategy)) {
    val[i * stride] = val[(i - 1) * stride];
    idx[i * stride] = idx[(i - 1) * stride];
    --i;
  }
  val[i * stride] = d;
  idx[i * stride] = g;
}

struct WarpTopK {
  float key, d;       // K <= 32: this lane's place
  int g;
  int cnt, k, strategy;
  float* val;         // the row's output slice
  int32_t* idx;
};

__device__ __forceinline__ WarpTopK loco_topk_init(int k, int strategy,
                                                   float* val, int32_t* idx) {
  WarpTopK t;
  t.key = -INFINITY;
  t.d = 0.f;
  t.g = 0;
  t.cnt = 0;
  t.k = k;
  t.strategy = strategy;
  t.val = val;
  t.idx = idx;
  return t;
}

// the list of a row whose first groups were offered before (cnt = min(k,
// groups offered)) and written out by loco_topk_write: read back from the
// row's output, so that a later batch of groups carries on with it
__device__ __forceinline__ WarpTopK loco_topk_resume(int k, int strategy,
                                                     float* val,
                                                     int32_t* idx, int cnt) {
  WarpTopK t = loco_topk_init(k, strategy, val, idx);
  t.cnt = cnt;
  const int lane = threadIdx.x & 31;
  if (k <= 32 && lane < cnt) {
    t.d = val[lane];
    t.g = idx[lane];
    t.key = loco_rank(t.d, strategy);
  }
  return t;
}

// offer each lane's (g, d) where `valid`; every lane of the warp calls it
__device__ __forceinline__ void loco_topk_offer(WarpTopK& t, bool valid,
                                                int g, float d) {
  const int lane = threadIdx.x & 31;
  if (t.k > 32) {
    unsigned todo = __ballot_sync(LOCO_FULL, valid);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const float cd = __shfl_sync(LOCO_FULL, d, src);
      const int cg = __shfl_sync(LOCO_FULL, g, src);
      if (lane == 0) loco_push(t.val, t.idx, t.k, t.cnt, t.strategy, cg, cd);
    }
    t.cnt = __shfl_sync(LOCO_FULL, t.cnt, 0);
    return;
  }
  const float key = loco_rank(d, t.strategy);
  float thr = __shfl_sync(LOCO_FULL, t.key, t.k - 1);
  unsigned todo = __ballot_sync(LOCO_FULL,
                                valid && (t.cnt < t.k || key > thr));
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const float ck = __shfl_sync(LOCO_FULL, key, src);
    const float cd = __shfl_sync(LOCO_FULL, d, src);
    const int cg = __shfl_sync(LOCO_FULL, g, src);
    if (t.cnt == t.k && !(ck > thr)) continue;   // the K-th rose past it
    const int pos = __popc(__ballot_sync(LOCO_FULL,
                                         lane < t.cnt && t.key >= ck));
    const float uk = __shfl_up_sync(LOCO_FULL, t.key, 1);
    const float ud = __shfl_up_sync(LOCO_FULL, t.d, 1);
    const int ug = __shfl_up_sync(LOCO_FULL, t.g, 1);
    if (lane > pos) {
      t.key = uk;
      t.d = ud;
      t.g = ug;
    } else if (lane == pos) {
      t.key = ck;
      t.d = cd;
      t.g = cg;
    }
    t.cnt = min(t.cnt + 1, t.k);
    thr = __shfl_sync(LOCO_FULL, t.key, t.k - 1);
  }
}

// write the register list to the row's output (K > 32: already there)
__device__ __forceinline__ void loco_topk_write(const WarpTopK& t) {
  const int lane = threadIdx.x & 31;
  if (t.k <= 32 && lane < t.k) {
    t.val[lane] = t.d;
    t.idx[lane] = t.g;
  }
}
