// tree_hist.cuh — what tree_hist.cu and tree_hist_deep.cu share: a block
// holds the histograms of a group of a level's nodes in shared memory,
// [Pg][Wc][SS] cells (each node's "slots": the features of a feature
// chunk, or with a node mask only those of the node's subset, compacted;
// a slot holds NB bins x sc statistics at stride SS >= NB·sc) and [Pg][sc]
// totals, f32 or, where every statistic is an integer, int32.
//
//   hist_build_slots  each node's slots from its mask, in feature order;
//   hist_row          one row's statistics into its node's slots (and, for a
//                     node with no slot in the block, into its totals);
//   hist_flush_totals the node totals: a node's total is the sum over the
//                     bins of its first slot (every live row of the node
//                     added into exactly one of them), plus the rows added
//                     one by one where the node has no slot.
//
// Adding zero changes no sum, so rows and statistics that are zero are
// skipped wherever that saves an atomic.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// the cells of one row: its statistics j0..j0+SR into the slots of node p
// (smem cells [Pg][Wc][SS], slot stride SS >= NB·S: bin b's S statistics
// at b·S).  C is the cells' type: float, or int where every statistic is
// an integer (native shared atomics; float adds are CAS loops).  PRE: a
// masked row's bins of its first 8 slots are loaded before its adds.
template <int SR, typename C = float, bool PRE = false>
__device__ __forceinline__ void add_row(
    C* __restrict__ hcell, const int8_t* __restrict__ brow,
    const int16_t* __restrict__ flist, int cnt, int p, int Wc, int SS, int S,
    int j0, const float (&sv)[SR], int d0, int dc, bool masked, bool words,
    int rot) {
  const int cell0 = p * Wc;
  if (masked) {
    // each lane starts at its own slot, so the warp's lanes add into
    // different features' cells at once
    const int t0 = rot % max(cnt, 1);
    int pre[PRE ? 8 : 1];
    if (PRE) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = t0 + i < cnt ? t0 + i : t0 + i - cnt;
        pre[i] = i < cnt ? __ldg(brow + d0 + flist[cell0 + t]) : 0;
      }
    }
    int t = t0;
    for (int i = 0; i < cnt; ++i, t = t + 1 == cnt ? 0 : t + 1) {
      int b;
      if (PRE && i < 8) {
        b = pre[0];
#pragma unroll
        for (int u = 1; u < 8; ++u) b = i == u ? pre[u] : b;
      } else {
        b = __ldg(brow + d0 + flist[cell0 + t]);
      }
      C* h = hcell + (cell0 + t) * SS + b * S + j0;
#pragma unroll
      for (int j = 0; j < SR; ++j)
        if (sv[j] != 0.f) atomicAdd(h + j, (C)sv[j]);
    }
    return;
  }
  int t = 0;
  if (words) {
    const uint32_t* w = (const uint32_t*)(brow + d0);
    const int nw4 = dc >> 2;
    // up to 8 words (32 features) loaded at once, the rest as they come
    uint32_t pre[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) pre[i] = i < nw4 ? __ldg(w + i) : 0u;
    int q = rot % max(nw4, 1);
    for (int i = 0; i < nw4; ++i, q = q + 1 == nw4 ? 0 : q + 1) {
      uint32_t v = pre[0];
#pragma unroll
      for (int k = 1; k < 8; ++k) v = q == k ? pre[k] : v;
      if (q >= 8) v = __ldg(w + q);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int b = (int)((v >> (8 * u)) & 0xffu);
        C* h = hcell + (cell0 + 4 * q + u) * SS + b * S + j0;
#pragma unroll
        for (int j = 0; j < SR; ++j)
          if (sv[j] != 0.f) atomicAdd(h + j, (C)sv[j]);
      }
    }
    t = 4 * nw4;
  }
  for (; t < dc; ++t) {
    const int b = __ldg(brow + d0 + t);
    C* h = hcell + (cell0 + t) * SS + b * S + j0;
#pragma unroll
    for (int j = 0; j < SR; ++j)
      if (sv[j] != 0.f) atomicAdd(h + j, (C)sv[j]);
  }
}

// each of the pn nodes' slots in the chunk [d0, d0 + dc): the features of
// its subset (mask rows of D bytes from m0), in order, as offsets from d0;
// a warp a node.  Nodes pn..Pg-1 (past the level) get none.
__device__ __forceinline__ void hist_build_slots(
    const uint8_t* __restrict__ m0, int Pg, int pn, int D, int d0, int dc,
    int Wc, int16_t* __restrict__ flist, int* __restrict__ cnt_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int p = warp; p < Pg; p += nw) {
    int cnt = 0;
    if (p < pn) {
      const uint8_t* m = m0 + (long long)p * D;
      for (int a = 0; a < dc; a += 32) {
        const bool on = a + lane < dc && m[d0 + a + lane];
        const unsigned bal = __ballot_sync(0xffffffffu, on);
        const int pos = cnt + __popc(bal & ((1u << lane) - 1u));
        if (on && pos < Wc) flist[p * Wc + pos] = (int16_t)(a + lane);
        cnt += __popc(bal);
      }
    }
    if (lane == 0) cnt_s[p] = min(cnt, Wc);
  }
}

// one live row (statistics s[0..sc), bins brow) of node p: into the node's
// totals where it has no slot here (cnt == 0, and the block adds totals),
// and into its slots' cells (slot stride SS), SR statistics a pass
template <int SR, typename C = float, bool PRE = false>
__device__ __forceinline__ void hist_row(
    C* __restrict__ hcell, C* __restrict__ tot,
    const int8_t* __restrict__ brow, const float* __restrict__ s, int sc,
    const int16_t* __restrict__ flist, int cnt, int p, int Wc, int SS,
    int d0, int dc, bool masked, bool words, bool with_hist, bool do_tot,
    int rot) {
  if (do_tot && cnt == 0)
    for (int j = 0; j < sc; ++j) {
      const float v = __ldg(s + j);
      if (v != 0.f) atomicAdd(tot + p * sc + j, (C)v);
    }
  if (!with_hist) return;
  for (int j0 = 0; j0 < sc; j0 += SR) {
    float sv[SR];
#pragma unroll
    for (int j = 0; j < SR; ++j) sv[j] = j0 + j < sc ? __ldg(s + j0 + j) : 0.f;
    add_row<SR, C, PRE>(hcell, brow, flist, cnt, p, Wc, SS, sc, j0, sv, d0,
                        dc, masked, words, rot);
  }
}

// the totals of nodes 0..pn-1 into gt (node p's statistic j at
// gt[p * S_out + j]; f32 atomics of the non-zero sums): tot plus, for a
// node with a slot here (masked ? cnt_s[p] : dc) > 0, its first slot's
// bins (slot stride SS)
template <typename C = float>
__device__ __forceinline__ void hist_flush_totals(
    float* __restrict__ gt, int S_out, const C* __restrict__ tot,
    const C* __restrict__ hcell, const int* __restrict__ cnt_s, int pn,
    int Wc, int SS, int NB, int sc, bool masked, int dc, bool with_hist) {
  for (int i = threadIdx.x; i < pn * sc; i += blockDim.x) {
    const int p = i / sc, j = i - p * sc;
    C v = tot[i];
    if (with_hist && (masked ? cnt_s[p] : dc) > 0)
      for (int b = 0; b < NB; ++b) v += hcell[p * Wc * SS + b * sc + j];
    if (v != (C)0) atomicAdd(gt + (long long)p * S_out + j, (float)v);
  }
}
