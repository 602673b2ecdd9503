// tree_hist_deep — the histograms of one deep tree level (more nodes than
// one block's shared memory holds), plus the per-node totals: the same
// output as tree_hist.cu, [K, P, D, NB, S] cells and [K, P, S] totals.
//
// Replaces (JAX): transmogrifai_tpu/models/trees.py:_fit_tree_unrolled's
// segment-sum branch (:520-531, one segment_sum per statistic over
// node*NB + bin ids) and its node_stats segment_sum (:463-466), which the
// unrolled fit takes once a level has more than 128 nodes.
//
// Design: rows partitioned by node group, each group's histogram in shared
// memory.  A deep level of 2,048 nodes does not fit a block (22 MB a lane
// at D = 28, NB = 32, S = 3), but a group of Pg of its nodes does — a
// forest node compacted to its 5-feature subset is 1,920 bytes, so ~55
// nodes share a 113 KB block (models/tree_kernels.hist_deep_plan sizes
// everything).  So each window of nodes runs:
//
// 1. deep_partition_kernel — a counting sort of each lane's live rows by
//    node group, per segment of SEG rows (grid: segments x lanes).  A row
//    is live when its node is in the level (window) and its statistics are
//    not all zero; the block reads each row's node id and statistics once
//    (several rows a thread at once), keeps each row's group and node in
//    shared memory, counts the groups (shared atomics, one a warp and
//    group: match_any), scans the counts, places the live rows (an inverse
//    permutation in shared memory) and writes each one's record — its
//    index (idx [K, N]), its node within the group (pl, int16) and a copy
//    of its statistics (ss [K, N, S]) — in place order, coalesced, into
//    the segment's own range: runs[k][g][segment] = (count, start).  So a
//    group's block reads its rows' records coalesced instead of gathering
//    them from rows that the other groups' rows sit between (a gather
//    re-reads, per group, nearly every sector of the lane: 5x at level 8,
//    35x at level 11).  Row order within a group is free: every cell sums
//    integers (below).
// 2. deep_group_rows_kernel — each lane's largest group and all live rows,
//    which the wrapper reads back (one wait for the card) to choose R, the
//    blocks that share a group's segments (see tree_hist_deep_partition).
// 3. tree_hist_deep_kernel — a block (384 threads, two an SM) owns (lane,
//    node group, feature chunk, statistic chunk) and a range of R
//    segments.  Its warps take the group's run of each segment in turn and
//    add each record (its bins gathered from B) into its node's slots in
//    shared memory (tree_hist.cuh: the slot layout, add_row and the
//    node-total rule of tree_hist.cu).  A slot's stride is odd (NB·S + 1
//    where that is even), so the same bin of different slots falls in
//    different banks (for 8-byte cells, different bank pairs).  Shared
//    float adds are compare-and-swap loops and integer adds are native,
//    and integer sums are exact in any order: a launch whose statistics
//    are all integers with sums below 2^24 (a forest's Poisson counts)
//    adds into int32 cells, any other into 64-bit fixed-point cells
//    (tree_hist.cuh: each row's value rounded once to v·2^e), so a GBT's
//    or a regression forest's level sums to the same bits on every
//    launch.  Where one block holds all of the group's rows (R = 1) it
//    writes every cell of its nodes in the chunk, kept cells and zeros,
//    converted to f32, with plain coalesced stores (a warp a node, 32
//    consecutive floats a store), so nothing zero-fills the histogram;
//    with R > 1 the launch zeroes the window's cells of the integer sums
//    (the f32 histogram itself for int32 cells, hist64 for fixed point),
//    the blocks add their non-zero cells with atomics, and fixed-point
//    sums are converted once after.  Cells outside a node's subset read
//    0 either way.  Chunk-0 blocks add the node totals (atomics into
//    zeroed totals: f32 of exact integer sums, or tot64, converted after
//    the last window).
//
// A level past HIST_DEEP_MAX_GROUPS groups (beyond 2,048 nodes) is
// launched in windows of nodes, a partition and a launch each (int16 group
// ids, and the partition's counters in shared memory).
//
// Bound: device-memory bytes.  Per lane and level it must read each row's
// node id and statistics (4N + 4SN), the bin bytes of the live rows' kept
// features, and write the histogram (4·P·D·NB·S: 22 MB a lane at P = 2048,
// D = 28, NB = 32, S = 3) and totals.  The records cost (6 + 4S) bytes a
// live row written and read again.
#include "tree_hist.cuh"

#define HIST_DEEP_MAX_GROUPS 2048   // (tree_kernels.HIST_DEEP_MAX_GROUPS)
#define PART_THREADS 512            // a partition block's threads
#define PART_UNROLL 4               // rows a partition thread loads at once

// ---------------------------------------------------------------------------
// 1. the partition
// ---------------------------------------------------------------------------

// exclusive scan of a[0..n) in place (block-wide, any n); writes each
// element's (count, start) to out[i * stride]
__device__ void scan_groups(int* __restrict__ a, int n, int* __restrict__ ws,
                            int2* __restrict__ out, long long stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, threadIdx.x * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    if (lane < nw) ws[lane] = w;          // inclusive, by warp
  }
  __syncthreads();
  int base = incl - sum + (warp > 0 ? ws[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    out[i * stride] = make_int2(c, base);
    a[i] = base;
    base += c;
  }
}

__global__ void __launch_bounds__(PART_THREADS) deep_partition_kernel(
    const int32_t* __restrict__ row_node, const float* __restrict__ stats,
    int32_t* __restrict__ idx, int16_t* __restrict__ pl,
    float* __restrict__ ss, int2* __restrict__ runs, long long N, int S, int first, int Pn, int Pg, int NG, int SEG,
    int nseg) {
  extern __shared__ int psm[];
  int* cnt = psm;                                   // [NG]
  int* ws = cnt + NG;                               // [32]
  int* code = ws + 32;                              // [SEG] g·2^15 + p
  int16_t* inv = (int16_t*)(code + SEG);            // [SEG] place -> row
  const long long k = blockIdx.y;
  const long long n0 = (long long)blockIdx.x * SEG;
  const int rows = (int)min((long long)SEG, N - n0);
  for (int i = threadIdx.x; i < NG; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int32_t* rn = row_node + k * N + n0;
  const float* sk = stats + (k * N + n0) * S;
  const int lane = threadIdx.x & 31;
  // PART_UNROLL rows a thread at once, their node ids and statistics
  // loaded together; a warp's rows of one group take one counter atomic
  // (match_any)
  for (int i0 = 0; i0 < rows; i0 += PART_UNROLL * blockDim.x) {
    int node[PART_UNROLL];
#pragma unroll
    for (int u = 0; u < PART_UNROLL; ++u) {
      const int i = i0 + u * blockDim.x + threadIdx.x;
      node[u] = i < rows ? __ldg(rn + i) - first : -1;
    }
    bool live[PART_UNROLL];
#pragma unroll
    for (int u = 0; u < PART_UNROLL; ++u) {
      const int i = i0 + u * blockDim.x + threadIdx.x;
      const float* s = sk + (long long)min(i, rows - 1) * S;
      const bool in = node[u] >= 0 && node[u] < Pn;
      live[u] = false;
      for (int j = 0; j < S; ++j) {
        const float raw = __ldg(s + j);            // not waiting on node[u]
        const float v = in ? raw : 0.f;
        live[u] |= v != 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < PART_UNROLL; ++u) {
      const int i = i0 + u * blockDim.x + threadIdx.x;
      const int g = live[u] ? node[u] / Pg : -1;
      if (i < rows) code[i] = live[u] ? g * 32768 + (node[u] - g * Pg) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, g);
      if (g >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(cnt + g, __popc(peers));
    }
  }
  __syncthreads();
  scan_groups(cnt, NG, ws, runs + k * NG * nseg + blockIdx.x, nseg);
  __syncthreads();
  // each live row's place in the segment's range (inv: place -> row) ...
  for (int i0 = 0; i0 < rows; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const int c = i < rows ? code[i] : -1;
    const int g = c >= 0 ? c >> 15 : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (g >= 0 && lane == leader) base = atomicAdd(cnt + g, __popc(peers));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (g >= 0) inv[base + __popc(peers & ((1u << lane) - 1u))] = (int16_t)i;
  }
  __syncthreads();
  // ... then the records written in place order, coalesced: the row's
  // index, its node within the group and a copy of its statistics (read
  // again, from L2: the block read them just before)
  const int live = cnt[NG - 1];
  const long long r0 = k * N + n0;
  for (int o = threadIdx.x; o < live; o += blockDim.x) {
    const int i = inv[o];
    idx[r0 + o] = (int32_t)(n0 + i);
    pl[r0 + o] = (int16_t)(code[i] & 32767);
  }
  for (int e0 = 0; e0 < live * S; e0 += PART_UNROLL * blockDim.x) {
    float v[PART_UNROLL];
#pragma unroll
    for (int u = 0; u < PART_UNROLL; ++u) {
      const int e = e0 + u * blockDim.x + threadIdx.x;
      const int o = e / S;
      v[u] = e < live * S
                 ? __ldg(sk + (long long)inv[o] * S + (e - o * S)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < PART_UNROLL; ++u) {
      const int e = e0 + u * blockDim.x + threadIdx.x;
      if (e < live * S) ss[r0 * S + e] = v[u];
    }
  }
}

// each lane's largest group (rows, summed over its segments' runs) and
// all lanes' live rows: stat[0] max, stat[1] sum (zeroed)
__global__ void __launch_bounds__(256) deep_group_rows_kernel(
    const int2* __restrict__ runs, int NG, int nseg,
    unsigned long long* __restrict__ stat) {
  const int2* rk = runs + (long long)blockIdx.x * NG * nseg;
  unsigned long long mx = 0, sum = 0;
  for (int g = threadIdx.x; g < NG; g += blockDim.x) {
    unsigned long long n = 0;
    for (int b = 0; b < nseg; ++b) n += rk[(long long)g * nseg + b].x;
    mx = max(mx, n);
    sum += n;
  }
  for (int o = 16; o > 0; o >>= 1) {
    mx = max(mx, __shfl_down_sync(0xffffffffu, mx, o));
    sum += __shfl_down_sync(0xffffffffu, sum, o);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(stat, mx);
    atomicAdd(stat + 1, sum);
  }
}

// ---------------------------------------------------------------------------
// 2. the group histograms
// ---------------------------------------------------------------------------

// one block's work with cells of type C: int (a launch whose statistics
// are all integers, sums below 2^24: their f32 atomics into G = float
// device memory are exact) or fixed_t (fixed point: G = fixed_t sums in
// hacc / tacc, converted after).  hist: the f32 histogram the owner block
// (R = 1) writes whole; hacc: the sums the R > 1 blocks add into; ex: the
// lane's statistics' exponents (fixed point)
template <int SR, typename C, typename G>
__device__ __forceinline__ void deep_block(
    C* __restrict__ hcell, const int8_t* __restrict__ B,
    const uint8_t* __restrict__ node_mask, const int32_t* __restrict__ idx,
    const int16_t* __restrict__ pl, const float* __restrict__ ss,
    const int2* __restrict__ runs, const int* __restrict__ ex,
    float* __restrict__ hist, G* __restrict__ hacc, G* __restrict__ tacc,
    long long N, int D, int NB, int S, int P, int wlo, int Pg, int pn,
    int p0, int g, int NG, int d0, int dc, int s_lo, int sc, int Wc, int SS,
    int SEG, int nseg, int R, long long k, bool masked, bool with_hist) {
  const int2* rk = runs + (k * NG + g) * nseg;
  const int b0 = (int)((long long)blockIdx.y * nseg / R);
  const int b1 = (int)((long long)(blockIdx.y + 1) * nseg / R);
  if (R > 1) {                 // a split block with no rows adds nothing
    int any = 0;
    for (int b = b0 + threadIdx.x; b < b1; b += blockDim.x) any |= rk[b].x;
    if (!__syncthreads_or(any)) return;
  }
  const bool do_tot = d0 == 0;
  const int hsize = with_hist ? Pg * Wc * SS : 0;
  C* tot = hcell + hsize;                        // [Pg][sc]
  int* cnt_s = (int*)(tot + Pg * sc);            // [Pg]
  int* exs = cnt_s + Pg;                         // [sc] exponents
  int16_t* flist = (int16_t*)(exs + sc);         // [Pg][Wc] features - d0
  for (int i = threadIdx.x; i < hsize + Pg * sc; i += blockDim.x)
    hcell[i] = (C)0;
  for (int i = threadIdx.x; i < sc; i += blockDim.x)
    exs[i] = ex != nullptr ? ex[k * S + s_lo + i] : 0;
  const long long node0 = k * P + wlo + p0;      // the group's first cell row
  if (masked)
    hist_build_slots(node_mask + node0 * D, Pg, pn, D, d0, dc, Wc, flist,
                     cnt_s);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const bool words = !masked && D % 4 == 0 && d0 % 4 == 0 &&
                     (uintptr_t)B % 4 == 0;
  // a warp takes the group's run of one segment at a time (every record
  // there a live row of the group), its records read coalesced
  for (int b = b0 + warp; b < b1; b += nw) {
    const int2 run = rk[b];
    const long long a0 = k * N + (long long)b * SEG + run.y;
    for (int t0 = 0; t0 < run.x; t0 += 32) {
      if (t0 + lane >= run.x) continue;
      const long long a = a0 + t0 + lane;
      const int n = __ldg(idx + a);
      const int p = __ldg(pl + a);
      const int cnt = !with_hist ? 0 : masked ? cnt_s[p] : dc;
      hist_row<SR, C, true>(hcell, tot, B + (long long)n * D,
                            ss + a * S + s_lo, sc, exs, flist, cnt, p, Wc,
                            SS, d0, dc, masked, words, with_hist, do_tot,
                            lane);
    }
  }
  __syncthreads();

  // the cells of the block's nodes in the chunk: stored whole, as f32
  // (kept cells and zeros), where the block holds all the group's rows,
  // else the non-zero kept cells added into the sums
  if (with_hist) {
    const bool owner = R == 1;
    const int NBS = NB * sc;
    for (int p = warp; p < pn; p += nw) {
      const long long cell = ((node0 + p) * D + d0) * NB * S + s_lo;
      const int cnt = masked ? cnt_s[p] : dc;
      int t = 0;
      for (int dl = 0; dl < dc; ++dl) {
        int slot = dl;
        if (masked) slot = t < cnt && flist[p * Wc + t] == dl ? t++ : -1;
        if (slot < 0 && !owner) continue;
        const C* src = hcell + (p * Wc + max(slot, 0)) * SS;
        const long long c0 = cell + (long long)dl * NB * S;
        for (int e = lane; e < NBS; e += 32) {
          const C v = slot >= 0 ? src[e] : (C)0;
          const int j = e % sc;
          const int o = sc == S ? e : (e / sc) * S + j;
          if (owner)
            hist[c0 + o] = Cell<C>::f32(v, exs[j]);
          else if (v != (C)0)
            atomicAdd(hacc + c0 + o, (G)v);
        }
      }
    }
  }
  if (do_tot)
    hist_flush_totals<C, G>(tacc + (k * P + wlo + p0) * S + s_lo, S, tot,
                            hcell, cnt_s, pn, Wc, SS, NB, sc, masked, dc,
                            with_hist);
}

template <int SR, typename C, typename G>
__global__ void __launch_bounds__(384, 2) tree_hist_deep_kernel(
    const int8_t* __restrict__ B, const uint8_t* __restrict__ node_mask,
    const int32_t* __restrict__ idx, const int16_t* __restrict__ pl,
    const float* __restrict__ ss, const int2* __restrict__ runs,
    const int* __restrict__ ex, float* __restrict__ hist,
    G* __restrict__ hacc, G* __restrict__ tacc, long long N, int D, int NB,
    int S, int P, int wlo, int Pn, int Pg, int NG, int Dc, int NC, int Wc,
    int SS, int Sc, int NSC, int SEG, int nseg, int R, int with_hist) {
  extern __shared__ __align__(16) unsigned char deep_sm[];
  int bx = blockIdx.x;
  const int g = bx % NG;
  bx /= NG;
  const int c = bx % NC;
  bx /= NC;
  const int q = bx % NSC;
  const long long k = bx / NSC;
  const int p0 = g * Pg;                         // the group's first node
  const int pn = min(Pg, Pn - p0);               // its nodes in the window
  if (pn <= 0) return;
  const int d0 = c * Dc;
  const int dc = with_hist ? min(Dc, D - d0) : 0;
  const int s_lo = q * Sc;
  const int sc = min(Sc, S - s_lo);
  const bool masked = node_mask != nullptr && with_hist;
  deep_block<SR, C, G>((C*)deep_sm, B, node_mask, idx, pl, ss, runs, ex,
                       hist, hacc, tacc, N, D, NB, S, P, wlo, Pg, pn, p0, g,
                       NG, d0, dc, s_lo, sc, Wc, SS, SEG, nseg, R, k, masked,
                       with_hist);
}

// the shared-memory bytes of one block of each kernel, cells of cb bytes
// (models/tree_kernels.hist_deep_plan adds the same terms)
static size_t deep_smem(int Pg, int Wc, int SS, int Sc, int with_hist,
                        int cb) {
  const size_t cells = (with_hist ? (size_t)Pg * Wc * SS : 0) +
                       (size_t)Pg * Sc;
  return cb * cells + 4 * ((size_t)Pg + Sc) +
         (with_hist ? 2 * (size_t)Pg * Wc : 0);
}

static size_t part_smem(int NG, int SEG) {
  return 4 * ((size_t)NG + 32 + (size_t)SEG) + 2 * (size_t)SEG;
}

template <int SR, typename C, typename G>
static int launch_sr(const void* B, const void* node_mask, const void* idx,
                     const void* pl, const void* ss, const void* runs,
                     const void* ex, void* hist, void* hacc, void* tacc,
                     long long N, int D, int NB, int S, int K, int P, int wlo,
                     int Pn, int Pg, int NG, int Dc, int NC, int Wc, int SS,
                     int Sc, int NSC, int SEG, int nseg, int R, int threads,
                     size_t smem, int with_hist, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      tree_hist_deep_kernel<SR, C, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((long long)K * NG * NC * NSC), R);
  tree_hist_deep_kernel<SR, C, G><<<grid, threads, smem, s>>>(
      (const int8_t*)B, (const uint8_t*)node_mask, (const int32_t*)idx,
      (const int16_t*)pl, (const float*)ss, (const int2*)runs,
      (const int*)ex, (float*)hist, (G*)hacc, (G*)tacc, N, D, NB, S, P, wlo,
      Pn, Pg, NG, Dc, NC, Wc, SS, Sc, NSC, SEG, nseg, R, with_hist);
  return (int)cudaGetLastError();
}

// The first stage of one window of nodes [wlo, wlo + Pn) of a level at
// heap offset `offset`: the partition into the wrapper's scratch — the
// records idx int32 [K, N], pl int16 [K, N] and ss f32 [K, N, S] and runs
// int2 [K, NG, nseg] — and stat uint64 [2] (zeroed here): the largest
// group's rows and all live rows.  The wrapper reads stat back (one wait
// for the card) and chooses R from it (models/tree_kernels.hist_deep_split):
// rows concentrate in a few nodes of a deep level of a real tree, and one
// block a group would leave those groups' blocks with nearly all the work.
extern "C" int tree_hist_deep_partition(
    const void* row_node, const void* stats, void* idx, void* pl, void* ss,
    void* runs, void* stat, long long N, int S, int K, int offset, int Pn,
    int Pg, int NG, int SEG, int nseg, int psmem, void* stream) {
  if (K < 1 || K > 65535 || N < 1 || N >= (1LL << 31) || S < 1 || Pg < 1 ||
      Pg > 32768 || NG < 1 || NG > HIST_DEEP_MAX_GROUPS ||
      (long long)Pg * NG < Pn || Pn < 1 || offset < 0 || SEG < 32 ||
      SEG > 32768 || (long long)SEG * nseg < N || nseg > 0x7fffffff ||
      (size_t)psmem != part_smem(NG, SEG))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      deep_partition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      psmem);
  if (err != cudaSuccess) return (int)err;
  deep_partition_kernel<<<dim3((unsigned)nseg, K), PART_THREADS, psmem,
                          s>>>(
      (const int32_t*)row_node, (const float*)stats, (int32_t*)idx,
      (int16_t*)pl, (float*)ss, (int2*)runs, N, S, offset, Pn, Pg, NG, SEG,
      nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  unsigned long long* st = (unsigned long long*)stat;
  err = cudaMemsetAsync(st, 0, 2 * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  deep_group_rows_kernel<<<K, 256, 0, s>>>((const int2*)runs, NG, nseg, st);
  return (int)cudaGetLastError();
}

// The histograms of the window [wlo, wlo + Pn) from its partition, R
// blocks sharing each group's segments.  ex null: every statistic an
// integer with sums below 2^24 — int32 cells, their sums added into hist
// (R > 1: its window's cells zeroed here) and totals (zeroed by the
// wrapper) as f32.  ex int32 [K, S] (the fixed-point exponents): 64-bit
// cells; with R > 1 the window's cells of hist64 are zeroed here, the
// blocks add into them and they are converted into hist after; the totals'
// sums go into tot64 (zeroed by the wrapper), converted into totals when
// `last` (the level's last window).  With R = 1 each block writes its
// nodes' cells of hist whole.
extern "C" int tree_hist_deep_launch(
    const void* B, const void* node_mask, const void* idx, const void* pl,
    const void* ss, const void* runs, const void* ex, void* hist,
    void* totals, void* hist64, void* tot64, long long N, int D, int NB,
    int S, int K, int P, int wlo, int Pn, int Pg, int NG, int Dc, int NC,
    int Wc, int SS, int Sc, int NSC, int SEG, int nseg, int R, int threads,
    int smem, int with_hist, int last, void* stream) {
  const bool fixed = ex != nullptr;
  if (K < 1 || K > 65535 || N < 1 || N >= (1LL << 31) || S < 1 || Pg < 1 ||
      Pg > 32768 || NG < 1 || NG > HIST_DEEP_MAX_GROUPS ||
      (long long)Pg * NG < Pn || Pn < 1 || wlo < 0 || wlo + Pn > P ||
      Sc < 1 || Sc > S || NSC < 1 || (long long)Sc * NSC < S || SEG < 32 ||
      SEG > 32768 || (long long)SEG * nseg < N || nseg > 0x7fffffff ||
      R < 1 || R > min(nseg, 65535) || threads % 32 || threads < 64 ||
      threads > 384 ||
      (with_hist && (Dc < 1 || Dc > 32767 || NC < 1 ||
                     (long long)Dc * NC < D || Wc < 1 || NB > 127 ||
                     SS < NB * Sc)) ||
      (size_t)smem != deep_smem(Pg, Wc, SS, Sc, with_hist, fixed ? 8 : 4) ||
      (long long)K * NG * NC * NSC > 0x7fffffffLL ||
      (fixed && (tot64 == nullptr ||
                 (R > 1 && with_hist && hist64 == nullptr))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t node_cells = (size_t)D * NB * S;
  void* hacc = fixed ? hist64 : hist;
  void* tacc = fixed ? tot64 : totals;
  if (R > 1 && with_hist) {
    const size_t cb = fixed ? 8 : 4;
    const cudaError_t err = cudaMemset2DAsync(
        (char*)hacc + cb * wlo * node_cells, cb * P * node_cells, 0,
        cb * Pn * node_cells, K, s);
    if (err != cudaSuccess) return (int)err;
  }
  const int nc = with_hist ? NC : 1;
  const size_t sz = (size_t)smem;
  int err;
#define DEEP(SR_, C_, G_)                                                    \
  err = launch_sr<SR_, C_, G_>(B, node_mask, idx, pl, ss, runs, ex, hist,     \
                               hacc, tacc, N, D, NB, S, K, P, wlo, Pn, Pg,    \
                               NG, Dc, nc, Wc, SS, Sc, NSC, SEG, nseg, R,     \
                               threads, sz, with_hist, s)
  if (!fixed) {
    if (Sc <= 3) DEEP(3, int, float);
    else if (Sc <= 5) DEEP(5, int, float);
    else DEEP(8, int, float);
    return err;
  }
  if (Sc <= 3) DEEP(3, fixed_t, fixed_t);
  else if (Sc <= 5) DEEP(5, fixed_t, fixed_t);
  else DEEP(8, fixed_t, fixed_t);
#undef DEEP
  if (err) return err;
  if (R > 1 && with_hist) {
    err = fixed_convert(hist64, hist, ex, K, (long long)(P * node_cells),
                        (long long)(wlo * node_cells),
                        (long long)(Pn * node_cells), S, s);
    if (err) return err;
  }
  return last ? fixed_convert(tot64, totals, ex, K, (long long)P * S, 0,
                              (long long)P * S, S, s)
              : 0;
}
