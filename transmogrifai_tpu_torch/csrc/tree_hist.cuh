// tree_hist.cuh — what tree_hist.cu and tree_hist_deep.cu share: a block
// holds the histograms of a group of a level's nodes in shared memory,
// [Pg][Wc][SS] cells (each node's "slots": the features of a feature
// chunk, or with a node mask only those of the node's subset, compacted;
// a slot holds NB bins x sc statistics at stride SS >= NB·sc) and [Pg][sc]
// totals.
//
// The cells' type C follows the launch's statistics
// (models/tree_kernels.hist_scale reads them once a fit):
//   - every statistic an integer and every lane's sums below 2^24 (a
//     classification forest's counts): f32 cells in tree_hist.cu, int32
//     cells in tree_hist_deep.cu — exact in any order;
//   - otherwise (GBT's (w, g, h), a regression forest's (w, wy, wy²)):
//     fixed point.  Each (lane, statistic) has a power-of-two scale 2^e
//     with max|v|·2^e·N <= 2^62, each row's value is rounded once to the
//     integer v·2^e and the cells are 64-bit integers, each added as two
//     32-bit integer adds with the carry (shared_add; shared float adds
//     are compare-and-swap loops).
//     An integer sum does not depend on the order of its adds, so every
//     launch gives the same bits; one conversion writes each sum, rounded
//     once to f32, times 2^-e.
//
//   hist_build_slots  each node's slots from its mask, in feature order;
//   hist_row          one row's statistics into its node's slots (and, for a
//                     node with no slot in the block, into its totals);
//   hist_flush_totals the node totals: a node's total is the sum over the
//                     bins of its first slot (every live row of the node
//                     added into exactly one of them), plus the rows added
//                     one by one where the node has no slot;
//   fixed_convert     the 64-bit sums of a range of cells to f32.
//
// Adding zero changes no sum, so rows and statistics that are zero are
// skipped wherever that saves an atomic.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long fixed_t;   // a fixed-point cell (two's complement)

// 2^e as a double, for -1022 <= e <= 1023
__device__ __forceinline__ double pow2(int e) {
  return __longlong_as_double((long long)(1023 + e) << 52);
}

// a fixed-point sum as f32: rounded once, then scaled (exactly) by 2^-e
__device__ __forceinline__ float fixed_f32(fixed_t s, int e) {
  return ldexpf(__ll2float_rn((long long)s), -e);
}

// a statistic's value in a cell of type C (e: its fixed-point exponent),
// and (tree_hist_deep's cells) a cell's sum as f32
template <typename C> struct Cell;
template <> struct Cell<float> {
  static __device__ __forceinline__ float of(float v, int) { return v; }
};
template <> struct Cell<int> {
  static __device__ __forceinline__ int of(float v, int) { return (int)v; }
  static __device__ __forceinline__ float f32(int v, int) { return (float)v; }
};
template <> struct Cell<fixed_t> {
  // v·2^e is exact in f64; rounded once, to nearest even
  static __device__ __forceinline__ fixed_t of(float v, int e) {
    return (fixed_t)__double2ll_rn((double)v * pow2(e));
  }
  static __device__ __forceinline__ float f32(fixed_t v, int e) {
    return fixed_f32(v, e);
  }
};

// v added into the shared cell h: atomicAdd for f32 and int32 cells; a
// 64-bit cell as two 32-bit adds — the low word's, whose carry (the old
// word plus v's low half wrapping past 2^32) joins the high word's add.
// atomicAdd on a shared u64 measured 1.7x slower (tree_hist_deep at GBT
// level 11, 6 lanes: 4.46 against 2.63 ms, "NVIDIA H100 80GB HBM3, 700.00
// W", scripts/tree_hist_time.py).  Each wrap is counted by the add that
// made it, so the cell's 64-bit sum is exact once the block syncs.
template <typename C>
__device__ __forceinline__ void shared_add(C* h, C v) { atomicAdd(h, v); }
template <>
__device__ __forceinline__ void shared_add<fixed_t>(fixed_t* h, fixed_t v) {
  unsigned* w = (unsigned*)h;                    // little endian: lo, hi
  const unsigned lo = (unsigned)v;
  unsigned hi = (unsigned)(v >> 32);
  if (lo) {
    const unsigned old = atomicAdd(w, lo);
    hi += old + lo < old;
  }
  if (hi) atomicAdd(w + 1, hi);
}

// the cells of one row: its statistics j0..j0+SR into the slots of node p
// (smem cells [Pg][Wc][SS], slot stride SS >= NB·S: bin b's S statistics
// at b·S), cv their cell values.  PRE: a masked row's bins of its first 8
// slots are loaded before its adds.
template <int SR, typename C, bool PRE = false>
__device__ __forceinline__ void add_row(
    C* __restrict__ hcell, const int8_t* __restrict__ brow,
    const int16_t* __restrict__ flist, int cnt, int p, int Wc, int SS, int S,
    int j0, const C (&cv)[SR], int d0, int dc, bool masked, bool words,
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
        if (cv[j] != (C)0) shared_add(h + j, cv[j]);
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
          if (cv[j] != (C)0) shared_add(h + j, cv[j]);
      }
    }
    t = 4 * nw4;
  }
  for (; t < dc; ++t) {
    const int b = __ldg(brow + d0 + t);
    C* h = hcell + (cell0 + t) * SS + b * S + j0;
#pragma unroll
    for (int j = 0; j < SR; ++j)
      if (cv[j] != (C)0) shared_add(h + j, cv[j]);
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
// and into its slots' cells (slot stride SS), SR statistics a pass; ex:
// the statistics' fixed-point exponents (shared memory)
template <int SR, typename C, bool PRE = false>
__device__ __forceinline__ void hist_row(
    C* __restrict__ hcell, C* __restrict__ tot,
    const int8_t* __restrict__ brow, const float* __restrict__ s, int sc,
    const int* __restrict__ ex, const int16_t* __restrict__ flist, int cnt,
    int p, int Wc, int SS, int d0, int dc, bool masked, bool words,
    bool with_hist, bool do_tot, int rot) {
  if (do_tot && cnt == 0)
    for (int j = 0; j < sc; ++j) {
      const C v = Cell<C>::of(__ldg(s + j), ex[j]);
      if (v != (C)0) shared_add(tot + p * sc + j, v);
    }
  if (!with_hist) return;
  for (int j0 = 0; j0 < sc; j0 += SR) {
    C cv[SR];
#pragma unroll
    for (int j = 0; j < SR; ++j)
      cv[j] = j0 + j < sc ? Cell<C>::of(__ldg(s + j0 + j), ex[j0 + j])
                          : (C)0;
    add_row<SR, C, PRE>(hcell, brow, flist, cnt, p, Wc, SS, sc, j0, cv, d0,
                        dc, masked, words, rot);
  }
}

// the totals of nodes 0..pn-1 into gt (node p's statistic j at
// gt[p * S_out + j], atomics of the non-zero sums; G: f32 for integer
// cells, whose sums are exact, fixed_t for fixed-point ones): tot plus,
// for a node with a slot here (masked ? cnt_s[p] : dc) > 0, its first
// slot's bins (slot stride SS)
template <typename C, typename G>
__device__ __forceinline__ void hist_flush_totals(
    G* __restrict__ gt, int S_out, const C* __restrict__ tot,
    const C* __restrict__ hcell, const int* __restrict__ cnt_s, int pn,
    int Wc, int SS, int NB, int sc, bool masked, int dc, bool with_hist) {
  for (int i = threadIdx.x; i < pn * sc; i += blockDim.x) {
    const int p = i / sc, j = i - p * sc;
    C v = tot[i];
    if (with_hist && (masked ? cnt_s[p] : dc) > 0)
      for (int b = 0; b < NB; ++b) v += hcell[p * Wc * SS + b * sc + j];
    if (v != (C)0) atomicAdd(gt + (long long)p * S_out + j, (G)v);
  }
}

// cells [k][lo, lo + n) of K lanes (lane stride `stride` cells, statistic
// j = cell % S, exponents ex[k·S + j]): the 64-bit sums of src as f32 in
// dst
__global__ void __launch_bounds__(256) fixed_convert_kernel(
    const fixed_t* __restrict__ src, float* __restrict__ dst,
    const int* __restrict__ ex, int K, long long stride, long long lo,
    long long n, int S) {
  const long long total = (long long)K * n;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long k = i / n;
    const long long c = k * stride + lo + (i - k * n);
    dst[c] = fixed_f32(src[c], __ldg(ex + k * S + (int)(c % S)));
  }
}

static int fixed_convert(const void* src, void* dst, const void* ex, int K,
                         long long stride, long long lo, long long n, int S,
                         cudaStream_t s) {
  if (K < 1 || n < 1) return 0;
  const long long need = ((long long)K * n + 255) / 256;
  const long long blocks = need < 132 * 16 ? need : 132 * 16;
  fixed_convert_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      (const fixed_t*)src, (float*)dst, (const int*)ex, K, stride, lo, n, S);
  return (int)cudaGetLastError();
}
