// tree_hist — per-(lane, node, feature, bin) histograms of per-row statistics
// for one level of a level-wise tree fit, plus the per-node totals.
//
// Replaces (JAX): transmogrifai_tpu/models/trees.py:_fit_tree_compact — the
// node_stats einsum "np,ns->ps" (:313-315) and the scan_chunk histogram
// einsum "cnb,nk->ckb" (:334-338).  The TPU program builds one-hot matrices
// so the MXU can do a scatter-add; on Hopper the scatter-add is native.
//
// Design.  A block owns one lane k, a group of Pg of the level's nodes, a
// chunk of the features and a range of rows, and holds that group's
// histogram in shared memory: for each node, its "slots" — the chunk's
// features, or with a node mask ([K, P, D] bytes, each node's drawn feature
// subset) only the features of the node's subset, compacted (a forest node
// keeps 5 of 28), so a forest level of 32 nodes fits one block whole.
// Grid: x = (node group, feature chunk, lane), group fastest, so the blocks
// of one row range run together and share its rows of B, node ids and
// statistics in L2; y = row ranges, sized by models/tree_kernels.hist_plan
// so that a level of any lane count fills the card.
//   Each warp scans its rows 64 at a time: a lane reads the node ids of two
//   rows (coalesced) and, for a row in the block's group, its statistics; a
//   row outside the level or the group, or with all-zero statistics, costs
//   that and nothing more.  The rows that pass are appended to the warp's
//   queue in shared memory (ballot and popcount); whenever 32 are queued,
//   each lane takes one and adds its statistics into the cells of the row's
//   slots: the row's bins are read as 32-bit words (4 features a load, the
//   first 32 features' words at once) or, through a node mask, gathered
//   byte by byte (reading a 28-byte row whole as words measured slower: 9.0
//   against 6.4 ms at 300 lanes); zero statistics add nothing
//   (exact: x + 0 == x).  Each lane walks its row's slots from its own
//   starting slot, so the warp's atomics spread over several features'
//   cells.  So every lane works on a live row, the node id and statistics
//   of a row are read once per (lane, node group, chunk) and there is no
//   division in the row loop.  At the end the block adds its non-zero cells
//   into the global histogram with atomics (cells of features outside a
//   node's subset stay at the zero the wrapper wrote), and the chunk-0
//   blocks add the node totals, which count every live row whatever the
//   mask: a node's total is the sum over the bins of its first slot (every
//   live row lands in one of them), so the rows add no atomics for it; only
//   a node with no slot in the block (and the totals-only bottom level)
//   adds its rows' statistics one by one.  The cells (tree_hist.cuh): f32
//   where every statistic is an integer and every lane's sums stay below
//   2^24 (a classification forest's counts: exact in any order); otherwise
//   fixed point — 64-bit integer cells in shared memory and in the global
//   sums (hist64 / tot64), converted to f32 once at the end — so a GBT's or
//   a regression forest's float statistics sum to the same bits on every
//   launch, whatever order the atomics take.
//
// A level whose nodes do not fit one block's shared memory (the wrapper's
// rule: 2·P·NB·S·(4 or 8 bytes a cell) above 99 KB) goes to
// tree_hist_deep.cu instead.
//
// Bound: device-memory bytes.  Per level it must read B once (N*D bytes),
// each lane's node ids (4N) and statistics (4SN) — at 1M x 28, S = 3: 28 MB
// plus 16 MB a lane — and write the histogram (fixed point: its 64-bit
// sums written, read and converted as well).
#include "tree_hist.cuh"

#define HIST_QUEUE 64                 // per warp: rows waiting for a warp

template <int SR, typename C>
__global__ void __launch_bounds__(512) tree_hist_kernel(
    const int8_t* __restrict__ B, const int32_t* __restrict__ row_node,
    const float* __restrict__ stats, const uint8_t* __restrict__ node_mask,
    const int* __restrict__ ex, C* __restrict__ hist, C* __restrict__ totals,
    long long N, int D, int NB, int S, int offset, int P, int Pg, int NG,
    int Dc, int NC, int Wc, long long RB, int with_hist) {
  extern __shared__ __align__(16) unsigned char hist_sm[];
  const int g = blockIdx.x % NG;
  const int c = (blockIdx.x / NG) % NC;
  const int k = blockIdx.x / (NG * NC);
  const int p0 = g * Pg;                         // the group's first node
  const int d0 = c * Dc;
  const int dc = with_hist ? min(Dc, D - d0) : 0;
  const bool masked = node_mask != nullptr && with_hist;
  const bool do_tot = c == 0;
  const int hsize = with_hist ? Pg * Wc * NB * S : 0;
  C* hcell = (C*)hist_sm;                        // [Pg][Wc][NB][S]
  C* tot = hcell + hsize;                        // [Pg][S]
  int* queue = (int*)(tot + Pg * S);             // per warp: n[64], p[64]
  int* cnt_s = queue + (blockDim.x >> 5) * 2 * HIST_QUEUE;   // [Pg]
  int* exs = cnt_s + Pg;                         // [S] exponents
  int16_t* flist = (int16_t*)(exs + S);          // [Pg][Wc] features - d0
  for (int i = threadIdx.x; i < hsize + Pg * S; i += blockDim.x)
    hcell[i] = (C)0;
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    exs[i] = ex != nullptr ? ex[(long long)k * S + i] : 0;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  // each node's slots in this chunk: the features of its subset, in order
  if (masked)
    hist_build_slots(node_mask + ((long long)k * P + p0) * D, Pg,
                     min(Pg, P - p0), D, d0, dc, Wc, flist, cnt_s);
  __syncthreads();

  int* qn = queue + warp * 2 * HIST_QUEUE;
  int* qp = qn + HIST_QUEUE;
  int qc = 0;
  const long long r0 = (long long)blockIdx.y * RB;
  const long long r1 = min(N, r0 + RB);
  const int32_t* rn = row_node + (long long)k * N;
  const float* sk = stats + (long long)k * N * S;
  const bool words = !masked && D % 4 == 0 && d0 % 4 == 0 &&
                     (uintptr_t)B % 4 == 0;
  const unsigned below = (1u << lane) - 1u;

  // lane: its queued row's statistics into the tot and hist cells
  auto drain = [&](int n, int p, bool on) {
    if (!on) return;
    const int cnt = !with_hist ? 0 : masked ? cnt_s[p] : dc;
    hist_row<SR, C>(hcell, tot, B + (long long)n * D, sk + (long long)n * S,
                    S, exs, flist, cnt, p, Wc, NB * S, d0, dc, masked, words,
                    with_hist, do_tot, lane);
  };

  for (long long base = r0 + 64LL * warp; base < r1; base += 64LL * nw) {
    int node[2];
    bool in[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long n = base + 32 * u + lane;
      node[u] = n < r1 ? __ldg(rn + n) - offset - p0 : -1;
      in[u] = node[u] >= 0 && node[u] < Pg && p0 + node[u] < P;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long n = base + 32 * u + lane;
      bool live = false;
      if (in[u]) {
        const float* s = sk + n * S;
        for (int j = 0; j < S; ++j) live |= __ldg(s + j) != 0.f;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int pos = qc + __popc(bal & below);
        qn[pos] = (int)n;
        qp[pos] = node[u];
      }
      qc += __popc(bal);
      if (qc >= 32) {
        __syncwarp();
        const int n_q = qn[lane], p_q = qp[lane];
        __syncwarp();
        if (lane < qc - 32) {
          qn[lane] = qn[lane + 32];
          qp[lane] = qp[lane + 32];
        }
        __syncwarp();
        qc -= 32;
        drain(n_q, p_q, true);
      }
    }
  }
  __syncwarp();
  if (qc > 0) drain(qn[lane < qc ? lane : 0], qp[lane < qc ? lane : 0],
                    lane < qc);
  __syncthreads();

  // global layouts: hist [K, P, D, NB, S], totals [K, P, S]
  if (with_hist) {
    const int per_node = Wc * NB * S;
    for (int i = threadIdx.x; i < hsize; i += blockDim.x) {
      const C v = hcell[i];
      if (v == (C)0) continue;
      const int p = i / per_node;
      const int rest = i - p * per_node;
      const int t = rest / (NB * S);
      const int bj = rest - t * NB * S;
      const int d = d0 + (masked ? flist[p * Wc + t] : t);
      atomicAdd(hist + (((long long)k * P + p0 + p) * D + d) * NB * S + bj,
                v);
    }
  }
  if (do_tot)
    hist_flush_totals<C, C>(totals + ((long long)k * P + p0) * S, S, tot,
                            hcell, cnt_s, Pg, Wc, NB * S, NB, S, masked, dc,
                            with_hist);
}

// the shared-memory bytes of one block with cells of cb bytes
// (models/tree_kernels.hist_plan adds the same terms)
static size_t hist_smem(int Pg, int Wc, int NB, int S, int threads,
                        int with_hist, int cb) {
  const size_t cells = (with_hist ? (size_t)Pg * Wc * NB * S : 0) +
                       (size_t)Pg * S;
  const size_t ints = (size_t)(threads / 32) * 2 * HIST_QUEUE + Pg + S;
  return cb * cells + 4 * ints + 2 * (size_t)Pg * Wc;
}

template <int SR, typename C>
static int launch_sr(const void* B, const void* row_node, const void* stats,
                     const void* node_mask, const void* ex, void* hist,
                     void* totals, long long N, int D, int NB, int S, int K,
                     int offset, int P, int Pg, int NG, int Dc, int NC,
                     int Wc, long long RB, int R, int threads, size_t smem,
                     int with_hist, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      tree_hist_kernel<SR, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)K * NG * NC, R);
  tree_hist_kernel<SR, C><<<grid, threads, smem, s>>>(
      (const int8_t*)B, (const int32_t*)row_node, (const float*)stats,
      (const uint8_t*)node_mask, (const int*)ex, (C*)hist, (C*)totals, N, D,
      NB, S, offset, P, Pg, NG, Dc, NC, Wc, RB, with_hist);
  return (int)cudaGetLastError();
}

template <typename C>
static int launch_c(const void* B, const void* row_node, const void* stats,
                    const void* node_mask, const void* ex, void* hist,
                    void* totals, long long N, int D, int NB, int S, int K,
                    int offset, int P, int Pg, int NG, int Dc, int NC, int Wc,
                    long long RB, int R, int threads, size_t smem,
                    int with_hist, cudaStream_t s) {
#define HIST(SR_)                                                            \
  return launch_sr<SR_, C>(B, row_node, stats, node_mask, ex, hist, totals,  \
                           N, D, NB, S, K, offset, P, Pg, NG, Dc, NC, Wc,    \
                           RB, R, threads, smem, with_hist, s)
  if (S <= 3) HIST(3);
  if (S <= 5) HIST(5);
  HIST(8);
#undef HIST
}

// One level.  ex null: every statistic an integer (sums below 2^24), f32
// cells added into hist [K, P, D, NB, S] and totals [K, P, S] (zeroed by
// the wrapper).  ex int32 [K, S] (the fixed-point exponents): 64-bit cells
// added into hist64 and tot64 (zeroed by the wrapper), then converted into
// hist and totals.
extern "C" int tree_hist_launch(const void* B, const void* row_node,
                                const void* stats, const void* node_mask,
                                const void* ex, void* hist, void* totals,
                                void* hist64, void* tot64, long long N,
                                int D, int NB, int S, int K, int offset,
                                int P, int Pg, int NG, int Dc, int NC, int Wc,
                                long long RB, int R, int threads, int smem,
                                int with_hist, void* stream) {
  const bool fixed = ex != nullptr;
  if (K < 1 || P < 1 || Pg < 1 || NG < 1 || NC < 1 || R < 1 || R > 65535 ||
      RB < 1 || threads % 32 || threads < 32 || threads > 512 ||
      N >= (1LL << 31) ||
      (with_hist && (Dc < 1 || Dc > 32767 || Wc < 1 || NB > 127)) ||
      (size_t)smem != hist_smem(Pg, Wc, NB, S, threads, with_hist,
                                fixed ? 8 : 4) ||
      (long long)K * NG * NC > 0x7fffffffLL ||
      (fixed && (tot64 == nullptr || (with_hist && hist64 == nullptr))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t sz = (size_t)smem;
  if (!fixed)
    return launch_c<float>(B, row_node, stats, node_mask, nullptr, hist,
                           totals, N, D, NB, S, K, offset, P, Pg, NG, Dc, NC,
                           Wc, RB, R, threads, sz, with_hist, s);
  int err = launch_c<fixed_t>(B, row_node, stats, node_mask, ex, hist64,
                              tot64, N, D, NB, S, K, offset, P, Pg, NG, Dc,
                              NC, Wc, RB, R, threads, sz, with_hist, s);
  if (err) return err;
  if (with_hist) {
    const long long cells = (long long)P * D * NB * S;
    err = fixed_convert(hist64, hist, ex, K, cells, 0, cells, S, s);
    if (err) return err;
  }
  return fixed_convert(tot64, totals, ex, K, (long long)P * S, 0,
                       (long long)P * S, S, s);
}
