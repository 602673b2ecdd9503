// fista_tc.cuh — one gradient evaluation of the FISTA grid solver on tensor
// cores, shared by fista_step.cu (the elementwise losses), fista_softmax.cu
// (the per-lane softmax over C classes) and fista_glm.cu (the exp-link GLM
// losses, with each column's loss sum; its value form without X^T g).
//
// Replaces (JAX): transmogrifai_tpu/models/solvers.py:_fista_loop's
// smooth_grad (:160-166) with the dense closures xs_mv / xs_tmv (:270-286),
// vmapped over the (fold x grid) lanes by linear_grid_fit (:334-376); the
// losses are _logistic / _squared_hinge / _squared_loss_grad (:53-56) and
// _softmax_loss_grad (:44-50).  XLA runs that as two matmuls that each read
// X from memory, with the loss gradient between them.
//
// Computes, for the J = L*C columns of one launch (column j: lane l = j / C,
// class c = j % C, fold f(l) = (lane0 + l) / G) and rows n < N:
//   m[n,j] = (sum_d X[n,d] * V[j,d] - muv[j]) + b[j]
//   g[n,j] = C == 1: the elementwise loss derivative of m (logistic,
//            squared hinge, gram, squared) times W[f,n] / wsum[l]
//            C >= 2: W[f,n] * (softmax_c(m[n, lane l]) - [y[n] == c]) / wsum[l]
//   out[d, j] = sum_n X[n,d] * g[n,j]   (d < D),   out[D, j] = sum_n g[n,j]
// and for the GLM losses (poisson, gamma; C == 1) each column's loss sum
//   out[(D+1)*J + j] = sum_n lw[n,j]   (lw: fl_glm's weighted loss term)
// after the X^T g rows, or alone in the value form (vonly: the backtracking
// ladder's trial steps need the loss and not the gradient), which skips
// step 4 below.
//
// Design.  A cluster of CS blocks (CS = 1 for a narrow X) walks row tiles of
// TR rows in a fixed order; block r of the cluster owns the feature slice
// [r*DS, r*DS + DS).  Per tile:
//  1. the block's slice of the X tile (TR x DS) and the tile's fold weights
//     and y arrive by cp.async into a ring of two stages (the next tile's
//     load overlaps this tile's work), X stored with an XOR swizzle of its
//     16-byte groups so that both products below read it from shared
//     memory without bank conflicts;
//  2. partial margins X_tile . V_slice^T on tensor cores: mma.sync m16n8k8
//     TF32 (X and V fragments by ldmatrix, V split once a launch), warps
//     split as WM (row m-tiles) x WK (k-ranges); the partials add over the
//     WK warps in shared memory and over the cluster's blocks through
//     distributed shared memory (each block pushes its sum into a slot of
//     every block by remote stores), each in a fixed order, so every block
//     holds the same full margins;
//  3. the loss gradient: where a warp holds whole margins (WK = CS = 1) in
//     its accumulator fragments — a lane's classes over one quad, by quad
//     shuffles (C = 2, 4, 8 within one column tile, any other C lane by
//     lane); else over the slots in shared memory, a thread per (row, lane)
//     (C <= 16) or a warp per four of them (the 40-class case);
//  4. acc += X_slice^T . G_tile on tensor cores; 16 extra columns of the X
//     tile, the first all ones, make an m-tile whose X^T g row is sum_n g
//     (on rank 0).  The accumulators persist across the tiles in shared
//     memory (in device memory only when a 16,384-wide slice does not fit).
// With a cluster the tiles pipeline: tile t's partial margins are pushed
// and the cluster barrier arrived at (barrier.cluster.arrive.release), the
// block adds X^T g of tile t - 1, then waits and forms tile t's gradient —
// the barrier's latency and the blocks' skew hide behind the MMAs.
// X is read from device memory once and g never goes there.  A GLM loss
// term adds to its own (row slot, column) sum in shared memory, which only
// the thread that forms it ever touches (the same thread every tile); at
// the end a thread a column adds its TR slots in slot order.  Each block
// writes its sums to partial[cluster][(D+1)*J]; fista_tc_reduce adds the
// clusters in a fixed order.  No float atomics anywhere: two launches give
// the same bits, so the solver's tolerance stop (n_iter) repeats.
//
// Numerics: split TF32, never plain TF32.  Each operand a = hi + lo with
// hi = rna_tf32(a), lo = rna_tf32(a - hi) (the rounding of cvt.rna.tf32.f32,
// done with an integer add: the MMA ignores a .tf32 operand's low 13 bits);
// a product is the three MMAs lo*hi + hi*lo + hi*hi (lo*lo, ~2^-22
// relative, is dropped).  The tensor cores truncate inside an MMA, so no
// chain runs long in an MMA accumulator: every TC_CHAIN k-steps start from
// zero and are added to an f32 sum with an ordinary (round-to-nearest) add.
// Plain TF32 (10 mantissa bits) would move the gradient by ~1e-3 relative.
//
// Route: mma.sync through inline PTX.  wgmma with TF32 takes only K-major
// operands from shared memory, which fits the margins but not X^T g, whose
// contraction runs over rows (X's tile is M-major there); mma.sync reads its
// fragments from shared memory in either orientation, and the swizzle keeps
// both conflict-free.  The kernel is a template on NT (column tiles, so the
// accumulators are registers sized at compile time) and BIG (V and the
// accumulators in device memory); its inner loops hold no branch, so the
// independent MMA chains (PM k-step accumulators, two X^T g m-tiles a warp
// where NT <= 2) interleave.
//
// Why a cluster and not a feature-sliced grid re-reading X from L2: at
// 1,596 columns a 16-row tile is 102 KB and the 24-lane accumulator 153 KB,
// which no single block holds at once.  Slicing the features over 2-8
// blocks of a cluster keeps each block's slice of the tile, of V and of the
// accumulator in its own shared memory, so X crosses device memory once and
// is never re-read; the price is the exchange and one cluster barrier a
// tile, pipelined as above.  A re-read from L2 would add X's bytes again to
// L2 traffic and serialise each block's two sweeps.
//
// Bound: bytes (X once, the lanes' fold weights, y, V) over 3.35 TB/s
// against f32 operations (4*N*D*J) over 67 TFLOP/s; on tensor cores the
// split costs 3 x 4*N*D*J over 495 TFLOP/s (the wide 24-lane shape: 0.93 ms
// against a 1.91 ms byte bound), so the kernel can be bound by bytes.  With
// few columns (a wide X at 6-8 lanes, one column tile) each X element's
// split and fragment loads outweigh its MMAs: instruction issue and the
// per-tile exchange, not bytes, set the pace (PERF.md, PR 10).
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "fista_loss.cuh"

namespace tc_cg = cooperative_groups;

#define TC_THREADS 256
#define TC_WARPS 8
#define TC_NTMAX 8          // column tiles of 8: at most 64 columns a launch
#define TC_CHAIN 4          // k-steps of one MMA chain before an f32 add
#define TC_FOLDS 4          // fold-weight rows a launch reads (staged with X)

struct TcParams {
  const float* X;           // [N, D]
  const float* V;           // [J, D]
  const float* muv;         // [J]
  const float* b;           // [J]
  const float* W;           // [F, N]
  const void* y;            // f32 [N] (C == 1), int32 [N] (softmax)
  const float* wsum;        // [L]
  float* partial;           // [ncl, (D+1)*J]
  float* accg;              // per-block accumulators when not in smem
  float* vg;                // V split [2][Jc][CS*DS] when not in smem
  long long N;
  int D, L, C, J, Jc, NT, lane0, G, loss, fold0, FU;
  int TR, lTR, WM, WK, CS, DS, DSX, DSA, DSV, Jp, MT, KG, S, v_res, acc_res,
      vec;
  int ncl;
  int glm;                  // an exp-link loss: per-column loss sums
  int vonly;                // the value form: loss sums only, no X^T g
  int R;                    // partial floats a cluster: (D+1)*J, + J (glm)
};

// shared-memory floats of one block; the Python plan computes the same sum
static inline long long tc_smem_floats(const TcParams& p) {
  return (long long)p.S * p.TR * (p.DSX + TC_FOLDS + 1)
         + (p.CS > 1 && p.S == 2 ? 4LL : 2LL) * p.TR * p.Jp
         + (p.WK > 1 ? (long long)p.WK * p.TR * p.Jp : 0)
         + (p.CS > 1 ? 2LL * p.CS * p.TR * p.Jp : 0)
         + (p.v_res && p.acc_res ? 2LL * p.Jc * p.DSV : 0)
         + (p.acc_res ? (long long)p.KG * p.MT * 16 * p.Jp : 0)
         + 4LL * p.Jc
         + (p.glm && !p.vonly ? (long long)p.TR * p.Jp : 0);
}

// the rounding of cvt.rna.tf32.f32 (to 10 mantissa bits, ties away from
// zero) on the bit pattern of a finite f32: add half a TF32 ulp; the MMA
// reads a .tf32 operand's upper 19 bits and ignores the lower 13, so the
// sum is the rounded operand and the mask is needed only for its value
__device__ __forceinline__ uint32_t tc_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo as MMA operands (lo = x - hi exactly, then rounded alike):
// four integer and float operations
__device__ __forceinline__ void tc_split(float x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

__device__ __forceinline__ void tc_mma(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in split TF32: the two small terms first, then hi * hi
__device__ __forceinline__ void tc_mma3(float (&d)[4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], uint32_t bh0,
                                        uint32_t bh1, uint32_t bl0,
                                        uint32_t bl1) {
  tc_mma(d, al, bh0, bh1);
  tc_mma(d, ah, bl0, bl1);
  tc_mma(d, ah, bh0, bh1);
}

// four 8x8 b16 matrices from shared memory = four 8 x 4 f32 (TF32)
// blocks: thread l gives the address of row l & 7 of matrix l >> 3 and gets
// element (l >> 2, l & 3) of each
__device__ __forceinline__ void tc_ldsm4(uint32_t (&r)[4], const float* a) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(a);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void tc_cp16(float* sdst, const float* gsrc,
                                        int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(sdst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gsrc), "r"(bytes));
}

__device__ __forceinline__ void tc_cp4(float* sdst, const float* gsrc,
                                       int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(sdst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gsrc), "r"(bytes));
}

__device__ __forceinline__ void tc_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int K>
__device__ __forceinline__ void tc_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

// the XOR key of row r: 16-byte group q of the row is stored at q ^ key.
// Rows r0+g (g < 8) under one group and rows k0+t, k0+t+4 (t < 4) under two
// neighbouring groups then fall on 32 distinct banks (row stride DSX % 32 == 0)
__device__ __forceinline__ int tc_key(int r) {
  return ((r & 3) << 1) | ((r >> 2) & 1);
}

// the block's slice of a row tile: TR rows x DSA columns from row r0 and
// column f0 into xs, zero past N rows and fs columns; and the tile's rows of
// the FU fold weights the launch's lanes read and of y into wy [FU+1][TR]
__device__ __forceinline__ void tc_load_tile(const TcParams& p, float* xs,
                                             float* wy, long long r0, int f0,
                                             int fs) {
  const int tid = threadIdx.x;
  // element e = tid + i * TC_THREADS of a [rows][width] walk, stepped
  // without a division per element
  if (p.vec) {
    const int g4 = p.DSA >> 2, dr = TC_THREADS / g4, dq = TC_THREADS % g4;
    int r = tid / g4, q = tid % g4;
    while (r < p.TR) {
      const long long n = r0 + r;
      const bool ok = n < p.N && 4 * q < fs;
      tc_cp16(xs + r * p.DSX + ((q ^ tc_key(r)) << 2),
              ok ? p.X + n * p.D + f0 + 4 * q : p.X, ok ? 16 : 0);
      q += dq;
      r += dr;
      if (q >= g4) {
        q -= g4;
        ++r;
      }
    }
  } else {
    const int w = p.DSA, dr = TC_THREADS / w, dc = TC_THREADS % w;
    int r = tid / w, c = tid % w;
    while (r < p.TR) {
      const long long n = r0 + r;
      const bool ok = n < p.N && c < fs;
      tc_cp4(xs + r * p.DSX + ((((c >> 2) ^ tc_key(r)) << 2) | (c & 3)),
             ok ? p.X + n * p.D + f0 + c : p.X, ok ? 4 : 0);
      c += dc;
      r += dr;
      if (c >= w) {
        c -= w;
        ++r;
      }
    }
  }
  for (int e = tid; e < (p.FU + 1) * p.TR; e += TC_THREADS) {
    const int f = e >> p.lTR, r = e & (p.TR - 1);
    const long long n = r0 + r;
    const bool wrow = f < p.FU;
    const bool ok = n < p.N && (wrow || p.loss != FL_GRAM);
    const float* src = wrow ? p.W + (long long)(p.fold0 + f) * p.N + n
                            : (const float*)p.y + n;
    tc_cp4(wy + e, ok ? src : p.X, ok ? 4 : 0);
  }
}

__device__ __forceinline__ void tc_store_g(float* ghi, float* glo, int i,
                                           float g) {
  const uint32_t h = tc_tf32(g);
  const uint32_t l = tc_tf32(g - __uint_as_float(h));
  ghi[i] = __uint_as_float(h);
  glo[i] = __uint_as_float(l);
}

// the cluster barrier in two halves: arrive (releasing this thread's
// stores, remote ones included), then wait (acquiring the others')
__device__ __forceinline__ void tc_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void tc_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// NT column tiles of 8; up to 4 tiles, two blocks an SM (128 registers).
// BIG: V's slice split in device memory (vg) and the accumulators wherever
// acc_res puts them, for a slice too wide for shared memory; else both in
// shared memory.  Independent MMA accumulators: the margins' k-steps of a
// chain go to PM accumulators in turn, X^T g's to two, and with NT <= 2 a
// warp runs two X^T g m-tiles at once — the column tiles alone leave too
// few.  The inner loops hold no branch, so the MMA streams interleave.
template <int NT, bool BIG>
__global__ void __launch_bounds__(TC_THREADS, NT <= 4 ? 2 : 1)
    fista_tc_kernel(const TcParams p) {
  constexpr int PM = NT <= 2 ? 4 : 2;
  constexpr int IP = NT <= 2 ? 2 : 1;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rank = p.CS > 1 ? (int)tc_cg::this_cluster().block_rank() : 0;
  const int cid = blockIdx.x / p.CS;
  const int f0 = rank * p.DS, fs = min(p.DS, p.D - f0);
  const int TR = p.TR, Jp = p.Jp, Jc = p.Jc, J = p.J, DSX = p.DSX;
  // the cluster pipeline: tile t's partial margins are exchanged while
  // the block adds X^T g of tile t - 1 (two g buffers, two stages)
  const bool pipe = p.CS > 1 && p.S == 2;

  float* xs = sm;                                  // [S][TR][DSX]
  float* wys = xs + p.S * TR * DSX;                // [S][FU+1][TR] W, y
  float* gbuf = wys + p.S * (TC_FOLDS + 1) * TR;   // [GB][2][TR][Jp] hi, lo
  float* red = gbuf + (pipe ? 4 : 2) * TR * Jp;    // [WK][TR][Jp]
  float* xb = red + (p.WK > 1 ? p.WK * TR * Jp : 0);   // [2][CS][TR][Jp]
  float* vs = xb + (p.CS > 1 ? 2 * p.CS * TR * Jp : 0);  // [2][Jc][DSV]
  float* accs = vs + (BIG ? 0 : 2 * Jc * p.DSV);   // [KG][MT*16][Jp]
  float* cmuv = accs + (!BIG || p.acc_res ? p.KG * p.MT * 16 * Jp : 0);
  float* cb = cmuv + Jc;                           // per column: b,
  float* crw = cb + Jc;                            // 1 / wsum of its lane,
  int* cfo = (int*)(crw + Jc);                     // its fold's W row * TR
  // the GLM loss sums [TR][Jp] (the value form keeps no g: its g buffer)
  float* lacc = p.vonly ? gbuf : (float*)(cfo + Jc);
  const int acc_n = p.KG * p.MT * 16 * Jp;
  float* acc = !BIG || p.acc_res ? accs
                                  : p.accg + (long long)blockIdx.x * acc_n;
  // V's slice, split: hi rows then lo rows, row stride vstr
  const float* vsp = BIG ? p.vg + f0 : vs;
  const int vstr = BIG ? p.CS * p.DS : p.DSV;
  const int vlo = Jc * vstr;
  const int wys_n = (TC_FOLDS + 1) * TR;

  for (int i = tid; i < (pipe ? 4 : 2) * TR * Jp; i += TC_THREADS)
    gbuf[i] = 0.f;
  for (int i = tid; i < acc_n; i += TC_THREADS) acc[i] = 0.f;
  if (p.glm && !p.vonly)
    for (int i = tid; i < TR * Jp; i += TC_THREADS) lacc[i] = 0.f;
  for (int j = tid; j < Jc; j += TC_THREADS) {
    const bool real = j < J;
    const int l = j / p.C;
    cmuv[j] = real ? p.muv[j] : 0.f;
    cb[j] = real ? p.b[j] : 0.f;
    crw[j] = real ? 1.f / p.wsum[l] : 1.f;
    cfo[j] = real ? ((p.lane0 + l) / p.G - p.fold0) * TR : 0;
  }
  // the ones m-tile after the slice's columns (16 * MTx..): column 0 of it
  // is 1, so X^T g there gives sum_n g
  for (int i = tid; i < p.S * TR * 16; i += TC_THREADS) {
    const int st = i / (TR * 16), r = (i / 16) % TR, c = p.DSA + (i & 15);
    xs[st * TR * DSX + r * DSX + ((((c >> 2) ^ tc_key(r)) << 2) | (c & 3))] =
        (i & 15) == 0 ? 1.f : 0.f;
  }
  if (!BIG)                    // V's slice, split once: hi, then lo
    for (int i = tid; i < Jc * p.DSV; i += TC_THREADS) {
      const int n = i / p.DSV, k = i - n * p.DSV;
      const float v = (n < J && k < fs) ? p.V[(long long)n * p.D + f0 + k]
                                        : 0.f;
      const uint32_t h = tc_tf32(v);
      vs[i] = __uint_as_float(h);
      vs[Jc * p.DSV + i] = __uint_as_float(tc_tf32(v - __uint_as_float(h)));
    }
  // every block of the cluster runs before any remote store
  if (p.CS > 1) tc_cg::this_cluster().sync();

  // margins: warp (wm, wk) owns rows wm*16.. and k-steps [ka, kb) of the slice
  const int wm = warp % p.WM, wk = warp / p.WM;
  const int KS = p.DS >> 3;
  const int kper = (KS + p.WK - 1) / p.WK;
  const int ka = wk * kper, kb = min(KS, ka + kper);
  const int ra = wm * 16 + gq;                     // fragment rows ra, ra + 8
  // whole margins in each warp's fragments: the loss runs there
  const bool fragloss = p.WK == 1 && p.CS == 1;
  const bool quad = p.C == 2 || p.C == 4 || p.C == 8;
  // the lane (model lane) of this thread's fragment columns, -1 past J
  int lane_of[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = nt * 8 + 2 * tq + e;
      lane_of[nt][e] = j < J ? j / p.C : -1;
    }
  // X^T g: item i -> m-tile i % MT (the last is the ones tile), k-group i / MT
  const int MTx = p.DSA >> 4, KT = TR >> 3;
  const int kper2 = (KT + p.KG - 1) / p.KG;

  // ---- 2. partial margins of the tile in xt over this block's slice ------
  // chains of TC_CHAIN k-steps from ka, k-step kc + i into accumulator
  // i % PM, added to mr in accumulator order; full chains unrolled, then
  // the tail
  // ldmatrix rows: X's tile rows wm*16 + (lane & 7) + 8 * (lane >> 3 & 1),
  // group 2 ks + (lane >> 4); V's rows nt*8 + (lane & 7), hi / lo by lane >> 4
  const int lr = lane & 7, lm = lane >> 3;
  const int xrow = wm * 16 + lr + 8 * (lm & 1), xkey = tc_key(xrow);
  const float* vl = vs + (lm >> 1) * Jc * p.DSV + lr * p.DSV + 4 * (lm & 1);
  auto mstep = [&](const float* xt, int ks, float (&c)[NT][4]) {
    uint32_t x[4], ah[4], al[4];
    tc_ldsm4(x, xt + xrow * DSX + (((2 * ks + (lm >> 1)) ^ xkey) << 2));
#pragma unroll
    for (int i = 0; i < 4; ++i) tc_split(__uint_as_float(x[i]), ah[i], al[i]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b[4];
      if (BIG) {
        const float* v = vsp + (nt * 8 + gq) * vstr + ks * 8 + tq;
        b[0] = __float_as_uint(v[0]);
        b[1] = __float_as_uint(v[4]);
        b[2] = __float_as_uint(v[vlo]);
        b[3] = __float_as_uint(v[vlo + 4]);
      } else {
        tc_ldsm4(b, vl + nt * 8 * p.DSV + ks * 8);
      }
      tc_mma3(c[nt], ah, al, b[0], b[1], b[2], b[3]);
    }
  };
  auto margins = [&](const float* xt, float (&mr)[NT][4]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mr[nt][0] = mr[nt][1] = mr[nt][2] = mr[nt][3] = 0.f;
    int kc = ka;
    for (; kc + TC_CHAIN <= kb; kc += TC_CHAIN) {
      float ch[PM][NT][4] = {};
#pragma unroll
      for (int i = 0; i < TC_CHAIN; ++i) mstep(xt, kc + i, ch[i % PM]);
#pragma unroll
      for (int h = 0; h < PM; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) mr[nt][e] += ch[h][nt][e];
    }
    if (kc < kb) {                               // 1 to TC_CHAIN - 1 k-steps
      float ch[PM][NT][4] = {};
#pragma unroll
      for (int i = 0; i < TC_CHAIN - 1; ++i)
        if (kc + i < kb) mstep(xt, kc + i, ch[i % PM]);
#pragma unroll
      for (int h = 0; h < PM; ++h)
        if (kc + h < kb)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) mr[nt][e] += ch[h][nt][e];
    }
  };

  // ---- 3a. the loss in the fragments (whole margins in this warp; a lane's
  // C = 1, 2, 4, 8 classes in one quad's 8 columns) -> g hi, lo
  auto frag_loss = [&](const float (&mr)[NT][4], const float* wt,
                       const float* yt, long long r0, float* gh, float* gl) {
    const float yA = yt[ra], yB = yt[ra + 8];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {              // rows ra (h = 0), ra + 8
        const int row = ra + 8 * h;
        const int j0 = nt * 8 + 2 * tq;
        const float m0 = (mr[nt][2 * h] - cmuv[j0]) + cb[j0];
        const float m1 = (mr[nt][2 * h + 1] - cmuv[j0 + 1]) + cb[j0 + 1];
        const float yn = h ? yB : yA;
        float g0, g1;
        if (p.C == 1 && p.glm) {
          float lw0, lw1;
          fl_glm(p.loss == FL_POISSON, m0, yn, wt[cfo[j0] + row], crw[j0],
                 lw0, g0);
          fl_glm(p.loss == FL_POISSON, m1, yn, wt[cfo[j0 + 1] + row],
                 crw[j0 + 1], lw1, g1);
          const bool live = r0 + row < p.N;
          if (live && j0 < J) lacc[row * Jp + j0] += lw0;
          if (live && j0 + 1 < J) lacc[row * Jp + j0 + 1] += lw1;
          if (p.vonly) continue;
        } else if (p.C == 1) {
          g0 = fl_grad(p.loss, m0, yn, wt[cfo[j0] + row], crw[j0]);
          g1 = fl_grad(p.loss, m1, yn, wt[cfo[j0 + 1] + row], crw[j0 + 1]);
        } else if (!quad) {
          continue;                              // below, lane by lane
        } else {
          float mx = fmaxf(m0, m1);
          for (int s = 1; s < p.C / 2; s <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
          const float e0 = expf(m0 - mx), e1 = expf(m1 - mx);
          float se = e0 + e1;
          for (int s = 1; s < p.C / 2; s <<= 1)
            se += __shfl_xor_sync(0xffffffffu, se, s);
          const float rs = __frcp_rn(se);
          const int c0 = j0 & (p.C - 1), yc = __float_as_int(yn);
          const float wr = wt[cfo[j0] + row] * crw[j0];
          g0 = wr * (e0 * rs - (c0 == yc ? 1.f : 0.f));
          g1 = wr * (e1 * rs - (c0 + 1 == yc ? 1.f : 0.f));
        }
        const bool live = r0 + row < p.N;
        tc_store_g(gh, gl, row * Jp + j0, live && j0 < J ? g0 : 0.f);
        tc_store_g(gh, gl, row * Jp + j0 + 1, live && j0 + 1 < J ? g1 : 0.f);
      }
    }
    if (p.C == 1 || quad) return;
    // any C: a lane's classes spread over the quad's columns; per lane its
    // max and sum over the quad (xor shuffles: the same sum in all four)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ra + 8 * h;
      const bool live = r0 + row < p.N;
      const int yc = __float_as_int(h ? yB : yA);
      float mm[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + 2 * tq + e;
          mm[nt][e] = (mr[nt][2 * h + e] - cmuv[j]) + cb[j];
        }
      for (int l = 0; l < p.L; ++l) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (lane_of[nt][e] == l) mx = fmaxf(mx, mm[nt][e]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float se = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (lane_of[nt][e] == l) se += expf(mm[nt][e] - mx);
        se += __shfl_xor_sync(0xffffffffu, se, 1);
        se += __shfl_xor_sync(0xffffffffu, se, 2);
        const float rs = __frcp_rn(se);
        const int j0 = l * p.C;
        const float wr = wt[cfo[j0] + row] * crw[j0];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (lane_of[nt][e] == l) {
              const int j = nt * 8 + 2 * tq + e;
              const float pr = expf(mm[nt][e] - mx) * rs;
              tc_store_g(gh, gl, row * Jp + j,
                         live ? wr * (pr - (j - j0 == yc ? 1.f : 0.f)) : 0.f);
            }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (lane_of[nt][e] < 0)
            tc_store_g(gh, gl, row * Jp + nt * 8 + 2 * tq + e, 0.f);
    }
  };

  // ---- 3b. partial margins to slots: the WK warps' in red; with a cluster
  // their sum pushed (remote stores) into slot [rank] of every block's
  // xb[buf]
  auto stage = [&](const float (&mr)[NT][4], int buf) {
    if (p.WK > 1) {
      float* rw = red + wk * TR * Jp;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = nt * 8 + 2 * tq;
        *(float2*)(rw + ra * Jp + j) = make_float2(mr[nt][0], mr[nt][1]);
        *(float2*)(rw + (ra + 8) * Jp + j) = make_float2(mr[nt][2], mr[nt][3]);
      }
      if (p.CS > 1) {
        __syncthreads();
        tc_cg::cluster_group cluster = tc_cg::this_cluster();
        for (int e = tid; e < TR * J; e += TC_THREADS) {
          const int r = e / J, j = e - r * J;
          float s = red[r * Jp + j];
          for (int w = 1; w < p.WK; ++w) s += red[(w * TR + r) * Jp + j];
          const int off = ((buf * p.CS + rank) * TR + r) * Jp + j;
          for (int q = 0; q < p.CS; ++q)
            cluster.map_shared_rank(xb, q)[off] = s;
        }
      }
    } else {                                     // WK == 1, CS > 1
      tc_cg::cluster_group cluster = tc_cg::this_cluster();
      const int off = (buf * p.CS + rank) * TR * Jp;
      for (int q = 0; q < p.CS; ++q) {
        float* dst = cluster.map_shared_rank(xb, q) + off;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int j = nt * 8 + 2 * tq;
          *(float2*)(dst + ra * Jp + j) = make_float2(mr[nt][0], mr[nt][1]);
          *(float2*)(dst + (ra + 8) * Jp + j) =
              make_float2(mr[nt][2], mr[nt][3]);
        }
      }
    }
  };

  // ---- 3c. the loss from the slots (their sum in slot order) -> g hi, lo
  auto slot_loss = [&](int buf, const float* wt, const float* yt,
                       long long r0, float* gh, float* gl) {
    const float* src = p.CS > 1 ? xb + buf * p.CS * TR * Jp : red;
    const int nsl = p.CS > 1 ? p.CS : p.WK;
    if (p.C == 1) {
      // a thread per (row, column)
      for (int e = tid; e < TR * J; e += TC_THREADS) {
        const int r = e / J, j = e - r * J;
        float m = src[r * Jp + j];
        for (int q = 1; q < nsl; ++q) m += src[(q * TR + r) * Jp + j];
        m = (m - cmuv[j]) + cb[j];
        if (p.glm) {
          float lw = 0.f, g = 0.f;
          if (r0 + r < p.N)
            fl_glm(p.loss == FL_POISSON, m, yt[r], wt[cfo[j] + r], crw[j], lw,
                   g);
          lacc[r * Jp + j] += lw;
          if (!p.vonly) tc_store_g(gh, gl, r * Jp + j, g);
          continue;
        }
        const float g = r0 + r < p.N
                            ? fl_grad(p.loss, m, yt[r], wt[cfo[j] + r], crw[j])
                            : 0.f;
        tc_store_g(gh, gl, r * Jp + j, g);
      }
    } else if (p.C <= 16) {
      // a thread per (row, lane): the lane's C classes in turn
      for (int e = tid; e < TR * p.L; e += TC_THREADS) {
        const int r = e % TR, j0 = (e / TR) * p.C;
        float mx = -INFINITY;
        for (int c = 0; c < p.C; ++c) {
          float m = src[r * Jp + j0 + c];
          for (int q = 1; q < nsl; ++q) m += src[(q * TR + r) * Jp + j0 + c];
          m = (m - cmuv[j0 + c]) + cb[j0 + c];
          gh[r * Jp + j0 + c] = m;
          mx = fmaxf(mx, m);
        }
        float se = 0.f;
        for (int c = 0; c < p.C; ++c) se += expf(gh[r * Jp + j0 + c] - mx);
        const float rs = __frcp_rn(se);
        const bool live = r0 + r < p.N;
        const float wr = wt[cfo[j0] + r] * crw[j0];
        const int yc = __float_as_int(yt[r]);
        for (int c = 0; c < p.C; ++c) {
          const float pr = expf(gh[r * Jp + j0 + c] - mx) * rs;
          tc_store_g(gh, gl, r * Jp + j0 + c,
                     live ? wr * (pr - (c == yc ? 1.f : 0.f)) : 0.f);
        }
      }
    } else {
      // a warp per 4 (row, lane) items at once: its threads take classes
      // c, c + 32, ...; the maxima and sums over shuffles (four chains
      // interleaved), lane 0's sums broadcast
      constexpr int RB = 4;
      for (int e0 = warp * RB; e0 < TR * p.L; e0 += TC_WARPS * RB) {
        float mx[RB], se[RB];
#pragma unroll
        for (int u = 0; u < RB; ++u) {
          mx[u] = -INFINITY;
          se[u] = 0.f;
          const int e = e0 + u;
          if (e >= TR * p.L) continue;
          const int r = e % TR, j0 = (e / TR) * p.C;
          for (int c = lane; c < p.C; c += 32) {
            float m = src[r * Jp + j0 + c];
            for (int q = 1; q < nsl; ++q)
              m += src[(q * TR + r) * Jp + j0 + c];
            m = (m - cmuv[j0 + c]) + cb[j0 + c];
            gh[r * Jp + j0 + c] = m;
            mx[u] = fmaxf(mx[u], m);
          }
        }
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < RB; ++u)
            mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], o));
#pragma unroll
        for (int u = 0; u < RB; ++u) {
          const int e = e0 + u;
          if (e >= TR * p.L) continue;
          const int r = e % TR, j0 = (e / TR) * p.C;
          for (int c = lane; c < p.C; c += 32)
            se[u] += expf(gh[r * Jp + j0 + c] - mx[u]);
        }
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < RB; ++u)
            se[u] += __shfl_xor_sync(0xffffffffu, se[u], o);
#pragma unroll
        for (int u = 0; u < RB; ++u) {
          const int e = e0 + u;
          const float rs = __frcp_rn(__shfl_sync(0xffffffffu, se[u], 0));
          if (e >= TR * p.L) continue;
          const int r = e % TR, j0 = (e / TR) * p.C;
          const bool live = r0 + r < p.N;
          const float wr = wt[cfo[j0] + r] * crw[j0];
          const int yc = __float_as_int(yt[r]);
          for (int c = lane; c < p.C; c += 32) {
            const float pr = expf(gh[r * Jp + j0 + c] - mx[u]) * rs;
            tc_store_g(gh, gl, r * Jp + j0 + c,
                       live ? wr * (pr - (c == yc ? 1.f : 0.f)) : 0.f);
          }
        }
      }
    }
  };

  // ---- 4. acc += X_slice^T g (+ the ones tile: sum_n g) -------------------
  // items (m-tile i % MT, k-group i / MT), the ones tile (m-tile MTx) on
  // rank 0 only; a warp takes items warp, warp + 8, ..., two at once where
  // it may (one k-group, NT <= 2).  k-ranges are even: chains of TC_CHAIN
  // k-steps, even and odd k-steps in two accumulators
  auto xitems = [&](auto cnt, int i0, const float* xt, const float* gh,
                    const float* gl) {
    constexpr int U = decltype(cnt)::value;
    float* ap[U];
    int grp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int iu = i0 + u * TC_WARPS, mt = iu % p.MT;
      ap[u] = acc + ((iu / p.MT) * p.MT + mt) * 16 * Jp;
      grp[u] = mt * 4 + (gq >> 2);
    }
    const int kg = i0 / p.MT;
    const int k0 = kg * kper2, k1 = min(KT, k0 + kper2);
    float run[U][NT][4];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = nt * 8 + 2 * tq;
        const float2 a = *(const float2*)(ap[u] + gq * Jp + j);
        const float2 c = *(const float2*)(ap[u] + (gq + 8) * Jp + j);
        run[u][nt][0] = a.x;
        run[u][nt][1] = a.y;
        run[u][nt][2] = c.x;
        run[u][nt][3] = c.y;
      }
    const int wq = gq & 3, k0r = 2 * tq, k4r = 2 * tq + 1;  // keys of rr, rr+4
    for (int kc = k0; kc < k1; kc += TC_CHAIN) {
      float ch[U][2][NT][4] = {};
      const int kce = min(k1, kc + TC_CHAIN);
      for (int k2 = kc; k2 < kce; k2 += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = (k2 + h) * 8 + tq;
          uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int o = rr * Jp + nt * 8 + gq;
            bh[nt][0] = __float_as_uint(gh[o]);
            bh[nt][1] = __float_as_uint(gh[o + 4 * Jp]);
            bl[nt][0] = __float_as_uint(gl[o]);
            bl[nt][1] = __float_as_uint(gl[o + 4 * Jp]);
          }
          const float* x0 = xt + rr * DSX;
          const float* x4 = x0 + 4 * DSX;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            uint32_t ah[4], al[4];
            tc_split(x0[((grp[u] ^ k0r) << 2) | wq], ah[0], al[0]);
            tc_split(x0[(((grp[u] + 2) ^ k0r) << 2) | wq], ah[1], al[1]);
            tc_split(x4[((grp[u] ^ k4r) << 2) | wq], ah[2], al[2]);
            tc_split(x4[(((grp[u] + 2) ^ k4r) << 2) | wq], ah[3], al[3]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              tc_mma3(ch[u][h][nt], ah, al, bh[nt][0], bh[nt][1], bl[nt][0],
                      bl[nt][1]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) run[u][nt][e] += ch[u][h][nt][e];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = nt * 8 + 2 * tq;
        *(float2*)(ap[u] + gq * Jp + j) =
            make_float2(run[u][nt][0], run[u][nt][1]);
        *(float2*)(ap[u] + (gq + 8) * Jp + j) =
            make_float2(run[u][nt][2], run[u][nt][3]);
      }
  };
  auto xtg = [&](const float* xt, const float* gh, const float* gl) {
    const int items = p.MT * p.KG;
    auto on = [&](int i) { return !(i % p.MT == MTx && rank != 0); };
    for (int i = warp; i < items;) {
      if (!on(i)) {
        i += TC_WARPS;
      } else if (IP == 2 && p.KG == 1 && i + TC_WARPS < items &&
                 on(i + TC_WARPS)) {
        xitems(std::integral_constant<int, 2>{}, i, xt, gh, gl);
        i += 2 * TC_WARPS;
      } else {
        xitems(std::integral_constant<int, 1>{}, i, xt, gh, gl);
        i += TC_WARPS;
      }
    }
  };

  auto load = [&](int it, int slot) {      // the cluster's it-th row tile
    const long long t = cid + (long long)it * p.ncl;
    if (t * TR < p.N)
      tc_load_tile(p, xs + slot * TR * DSX, wys + slot * wys_n, t * TR, f0,
                   fs);
    tc_commit();
  };
  const long long T = (p.N + TR - 1) / TR;
  const int n_it = (int)((T - cid + p.ncl - 1) / p.ncl);   // >= 1
  float* gh0 = gbuf;
  float* gl0 = gbuf + TR * Jp;
  load(0, 0);
  if (!pipe) {
    // one block a cluster (or one stage): per tile, the wait for its load
    // and one barrier, then margins, loss and X^T g
    for (int it = 0; it < n_it; ++it) {
      const int slot = p.S == 2 ? (it & 1) : 0;
      const float* xt = xs + slot * TR * DSX;
      const float* wt = wys + slot * wys_n;        // [FU][TR] W, then y
      const float* yt = wt + p.FU * TR;
      const long long r0 = (cid + (long long)it * p.ncl) * TR;
      tc_wait<0>();
      __syncthreads();
      if (p.S == 2) load(it + 1, slot ^ 1);
      float mr[NT][4];
      margins(xt, mr);
      if (fragloss) {
        frag_loss(mr, wt, yt, r0, gh0, gl0);
      } else {
        stage(mr, it & 1);
        if (p.CS > 1) tc_cg::this_cluster().sync();
        else __syncthreads();
        slot_loss(it & 1, wt, yt, r0, gh0, gl0);
      }
      __syncthreads();
      if (!p.vonly) xtg(xt, gh0, gl0);
      if (p.S == 1) {
        __syncthreads();
        load(it + 1, 0);
      }
    }
  } else {
    // the cluster pipeline: margins of tile it, their exchange released;
    // X^T g of tile it - 1 while the others' partials arrive; then tile
    // it's loss.  Tile it + 1 loads into tile it - 1's stage once its X^T g
    // is done
    for (int it = 0; it < n_it; ++it) {
      const int slot = it & 1, prev = slot ^ 1;
      const float* xt = xs + slot * TR * DSX;
      const float* wt = wys + slot * wys_n;
      const float* yt = wt + p.FU * TR;
      const long long r0 = (cid + (long long)it * p.ncl) * TR;
      float* gh = gbuf + (it & 1) * 2 * TR * Jp;
      float* ghp = gbuf + ((it & 1) ^ 1) * 2 * TR * Jp;
      tc_wait<0>();
      __syncthreads();
      float mr[NT][4];
      margins(xt, mr);
      stage(mr, it & 1);
      tc_cluster_arrive();
      if (it > 0 && !p.vonly) xtg(xs + prev * TR * DSX, ghp, ghp + TR * Jp);
      __syncthreads();
      load(it + 1, prev);
      tc_cluster_wait();
      slot_loss(it & 1, wt, yt, r0, gh, gh + TR * Jp);
    }
    __syncthreads();
    const int last = n_it - 1;
    float* ghl = gbuf + (last & 1) * 2 * TR * Jp;
    if (!p.vonly) xtg(xs + (last & 1) * TR * DSX, ghl, ghl + TR * Jp);
  }
  tc_wait<0>();
  // no block leaves while another of its cluster may still store to it
  if (p.CS > 1) tc_cg::this_cluster().sync();
  __syncthreads();

  // the block's sums, k-groups added in order: features f0.. and (rank 0)
  // the ones row, to this cluster's partial row
  float* out = p.partial + (long long)cid * p.R;
  const int nrow = p.vonly ? 0 : fs + (rank == 0 ? 1 : 0);
  for (int e = tid; e < nrow * J; e += TC_THREADS) {
    const int d = e / J, j = e - d * J;
    const int ar = d < fs ? d : MTx * 16;
    float s = acc[ar * Jp + j];
    for (int k = 1; k < p.KG; ++k) s += acc[(k * p.MT * 16 + ar) * Jp + j];
    out[(long long)(d < fs ? f0 + d : p.D) * J + j] = s;
  }
  // the GLM loss sums, slots in order (every block of a cluster holds the
  // same: rank 0 writes them)
  if (p.glm && rank == 0) {
    float* lo = out + (p.vonly ? 0 : (long long)(p.D + 1) * J);
    for (int j = tid; j < J; j += TC_THREADS) {
      float s = 0.f;
      for (int r = 0; r < TR; ++r) s += lacc[r * Jp + j];
      lo[j] = s;
    }
  }
}

// out[i] = sum over clusters c of partial[c, i], in a fixed order: eight
// strided running sums (c = s, s + 8, ...) added s = 0..7
__global__ void fista_tc_reduce(const float* __restrict__ partial,
                                float* __restrict__ out, long long R,
                                int ncl) {
  __shared__ float red[8][33];
  const int ii = threadIdx.x & 31, ci = threadIdx.x >> 5;
  const long long i = blockIdx.x * 32LL + ii;
  float s = 0.f;
  if (i < R)
    for (int c = ci; c < ncl; c += 8) s += partial[(long long)c * R + i];
  red[ci][ii] = s;
  __syncthreads();
  if (ci == 0 && i < R) {
    float t = red[0][ii];
    for (int k = 1; k < 8; ++k) t += red[k][ii];
    out[i] = t;
  }
}

typedef void (*TcKernel)(const TcParams);

#define TC_K(n) (big ? fista_tc_kernel<n, true> : fista_tc_kernel<n, false>)
// the instantiation for NT column tiles, V in device memory or not
static TcKernel tc_kernel(int NT, bool big) {
  switch (NT) {
    case 1: return TC_K(1);
    case 2: return TC_K(2);
    case 3: return TC_K(3);
    case 4: return TC_K(4);
    case 5: return TC_K(5);
    case 6: return TC_K(6);
    case 7: return TC_K(7);
    case 8: return TC_K(8);
  }
  return nullptr;
}
#undef TC_K

// V [J, D] split into vg: hi [Jc][vstr] then lo, zero past J rows, D columns
__global__ void fista_tc_vsplit(const float* __restrict__ V,
                                float* __restrict__ vg, int J, int Jc, int D,
                                int vstr) {
  const long long n_all = (long long)Jc * vstr;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_all; i += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(i / vstr), k = (int)(i % vstr);
    const float v = n < J && k < D ? V[(long long)n * D + k] : 0.f;
    const uint32_t h = tc_tf32(v);
    vg[i] = __uint_as_float(h);
    vg[n_all + i] = __uint_as_float(tc_tf32(v - __uint_as_float(h)));
  }
}

// clusters co-resident on the card for one (kernel, shared memory, cluster
// size): queried once per triple
static int tc_max_clusters(TcKernel k, int NT, int smem, int CS,
                           cudaStream_t s) {
  static TcKernel kk[64];
  static int keys[64][3], vals[64], n_cached = 0;
  for (int i = 0; i < n_cached; ++i)
    if (kk[i] == k && keys[i][1] == smem && keys[i][2] == CS)
      return vals[i];
  int dev = 0, sms = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  if (CS == 1) {
    int bps = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, k, TC_THREADS,
                                                      smem) != cudaSuccess)
      return 0;
    n = bps * sms;
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = CS;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(CS);
    cfg.blockDim = dim3(TC_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&n, (void*)k, &cfg) != cudaSuccess)
      return 0;
  }
  if (n_cached < 64) {
    kk[n_cached] = k;
    keys[n_cached][0] = NT;
    keys[n_cached][1] = smem;
    keys[n_cached][2] = CS;
    vals[n_cached++] = n;
  }
  return n;
}

// Fill the derived fields of p from its plan fields, check them, launch the
// kernel on at most ncl_max clusters and the fixed-order reduction into out
// [(D+1) * J].  Returns a CUDA error code.
static int fista_tc_run(TcParams p, int ncl_max, int smem, void* out,
                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.N < 1 || p.D < 1 || p.L < 1 || p.C < 1 || p.G < 1 || ncl_max < 1 ||
      p.L * p.C > 8 * TC_NTMAX || p.loss < 0 || p.loss > FL_GAMMA ||
      (p.loss == FL_SOFTMAX) != (p.C > 1))
    return (int)cudaErrorInvalidValue;
  p.glm = p.loss == FL_POISSON || p.loss == FL_GAMMA;
  if (p.vonly && !p.glm) return (int)cudaErrorInvalidValue;
  p.J = p.L * p.C;
  p.R = (p.vonly ? 0 : (p.D + 1) * p.J) + (p.glm ? p.J : 0);
  p.Jc = (p.J + 7) / 8 * 8;
  p.NT = p.Jc / 8;
  p.fold0 = p.lane0 / p.G;
  p.FU = (p.lane0 + p.L - 1) / p.G - p.fold0 + 1;
  const bool big = !(p.v_res && p.acc_res);
  const TcKernel k = tc_kernel(p.NT, big);
  if (k == nullptr || p.FU > TC_FOLDS) return (int)cudaErrorInvalidValue;
  if (!(p.TR == 16 || p.TR == 32 || p.TR == 64 || p.TR == 128) ||
      !(p.CS == 1 || p.CS == 2 || p.CS == 4 || p.CS == 8) ||
      p.S < 1 || p.S > 2 || p.DS < 8 || p.DS % 8 ||
      (long long)(p.CS - 1) * p.DS >= p.D || (long long)p.CS * p.DS < p.D)
    return (int)cudaErrorInvalidValue;
  p.WM = p.TR / 16;
  p.WK = TC_WARPS / p.WM;
  p.lTR = p.TR == 16 ? 4 : p.TR == 32 ? 5 : p.TR == 64 ? 6 : 7;
  p.DSA = (p.DS + 15) / 16 * 16;
  p.DSX = (p.DSA + 16 + 31) / 32 * 32;            // + the ones m-tile
  p.DSV = p.DS + ((4 - p.DS) % 32 + 32) % 32;
  p.Jp = p.Jc;
  while (p.Jp % 32 != 8 && p.Jp % 32 != 24) p.Jp += 8;
  p.MT = p.DSA / 16 + 1;
  p.KG = TC_WARPS / p.MT > 1 ? TC_WARPS / p.MT : 1;
  p.vec = (p.D % 4 == 0) && ((uintptr_t)p.X % 16 == 0);
  if ((!p.acc_res && p.accg == nullptr) || (big && p.vg == nullptr))
    return (int)cudaErrorInvalidValue;
  if (4 * tc_smem_floats(p) > smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long T = (p.N + p.TR - 1) / p.TR;
  // a GLM's launches take the clusters its 64-column kernel holds
  // co-resident, whatever their own columns: with one plan (one tile size,
  // cluster and shared memory) its gradient form and a ladder's value form
  // then add their loss sums over the same tiles in the same order at one
  // point, as the ladder's test of f(new) against f(z) needs
  const TcKernel kq = p.glm ? tc_kernel(TC_NTMAX, big) : k;
  if (kq != k) {
    err = cudaFuncSetAttribute(
        kq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int ncl = tc_max_clusters(kq, p.glm ? TC_NTMAX : p.NT, smem, p.CS, s);
  if (ncl < 1) return (int)cudaErrorInvalidConfiguration;
  if (ncl > ncl_max) ncl = ncl_max;
  if (ncl > T) ncl = (int)T;
  p.ncl = ncl;
  if (big) {
    fista_tc_vsplit<<<264, 256, 0, s>>>(p.V, p.vg, p.J, p.Jc, p.D,
                                        p.CS * p.DS);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (p.CS == 1) {
    k<<<ncl, TC_THREADS, smem, s>>>(p);
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = p.CS;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(ncl * p.CS);
    cfg.blockDim = dim3(TC_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, k, p);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fista_tc_reduce<<<(unsigned)((p.R + 31) / 32), 256, 0, s>>>(
      p.partial, (float*)out, p.R, ncl);
  return (int)cudaGetLastError();
}

// the C launch interface the three sources export (C = 1 with an
// elementwise or GLM loss, or the softmax over C >= 2 classes): pointers,
// then N, then the plan's ints; vonly: a GLM's value form
static int fista_tc_launch(const void* X, const void* V, const void* muv,
                           const void* b, const void* W, const void* y,
                           const void* wsum, void* partial, void* accg,
                           void* vg, void* out, long long N, int D, int L,
                           int C,
                           int lane0, int G, int loss, int TR, int CS, int DS,
                           int S, int v_res, int acc_res, int ncl_max,
                           int smem, void* stream, int vonly = 0) {
  TcParams p = {};
  p.X = (const float*)X;
  p.V = (const float*)V;
  p.muv = (const float*)muv;
  p.b = (const float*)b;
  p.W = (const float*)W;
  p.y = y;
  p.wsum = (const float*)wsum;
  p.partial = (float*)partial;
  p.accg = (float*)accg;
  p.vg = (float*)vg;
  p.N = N;
  p.D = D;
  p.L = L;
  p.C = C;
  p.lane0 = lane0;
  p.G = G;
  p.loss = loss;
  p.TR = TR;
  p.CS = CS;
  p.DS = DS;
  p.S = S;
  p.v_res = v_res;
  p.acc_res = acc_res;
  p.vonly = vonly;
  return fista_tc_run(p, ncl_max, smem, out, stream);
}
