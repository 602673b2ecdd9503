// tree_hist — per-(lane, node, feature, bin) histograms of per-row statistics
// for one level of a level-wise tree fit, plus the per-node totals.
//
// Replaces (JAX): transmogrifai_tpu/models/trees.py:_fit_tree_compact — the
// node_stats einsum "np,ns->ps" (:313-315) and the scan_chunk histogram
// einsum "cnb,nk->ckb" (:334-338).  The TPU program builds one-hot matrices
// so the MXU can do a scatter-add; on Hopper the scatter-add is native.
//
// Design: each block owns a shared-memory histogram for the nodes of one
// level (P nodes x Dc features x NB bins x S stats, f32) and walks a
// grid-stride range of the row-major int8 bin matrix B, so a warp reads 32
// consecutive bytes.  Each element adds its row's S statistics into shared
// memory with f32 atomics; at the end the block adds its non-zero partials
// into the global histogram with f32 atomics.  Grid: x = row ranges,
// y = lanes, z = feature chunks (a chunk's histogram has to fit the block's
// shared memory).  Atomics make the f32 sums order-dependent run to run.
// A row whose S statistics are all zero adds nothing: it is exact, since
// x + (+-0.0) == x for every x, and it spares the atomics of out-of-bag and
// held-out rows (a forest lane's weight is 0 on ~60% of its
// rows: Poisson(1) zeros times the fold's held-out third).  With a node mask
// ([K, P, D] bytes, each node's drawn feature subset), cells of features
// outside a node's subset are left at zero: the split search never reads
// them.  The node totals count every row whatever the mask.
//
// A level whose nodes do not fit one block's shared memory (more than ~130
// nodes at S = 3) goes to tree_hist_deep.cu instead, in one pass.
//
// Bound: device-memory bytes.  Per lane and level it must read B once
// (N*D bytes), the row's node id (4N) and statistics (4SN) — at 1M x 28,
// S=3: 28 + 4 + 12 MB — and write the small histogram.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void tree_hist_kernel(const int8_t* __restrict__ B,
                                 const int32_t* __restrict__ row_node,
                                 const float* __restrict__ stats,
                                 const uint8_t* __restrict__ node_mask,
                                 float* __restrict__ hist,
                                 float* __restrict__ totals,
                                 long long N, int D, int NB, int S,
                                 int offset, int P, int Dc, int with_hist) {
  extern __shared__ float sm[];
  const int k = blockIdx.y;
  const int d0 = blockIdx.z * Dc;
  const int dc = with_hist ? min(Dc, D - d0) : 0;
  const int hsize = P * Dc * NB * S;        // this chunk's histogram
  const int do_tot = (blockIdx.z == 0);
  float* sh = sm;
  float* st = sm + (with_hist ? hsize : 0);
  const int ssize = (with_hist ? hsize : 0) + P * S;
  for (int i = threadIdx.x; i < ssize; i += blockDim.x) sm[i] = 0.f;
  __syncthreads();

  const int32_t* rn = row_node + (long long)k * N;
  const float* sk = stats + (long long)k * N * S;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (with_hist) {
    const long long total = N * dc;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < total; e += stride) {
      const long long n = e / dc;
      const int dl = (int)(e - n * dc);
      const int p = rn[n] - offset;
      if (p < 0 || p >= P) continue;
      const float* s = sk + n * S;
      bool any = false;
      for (int j = 0; j < S; ++j) any |= s[j] != 0.f;
      if (!any) continue;
      if (do_tot && dl == 0)
        for (int j = 0; j < S; ++j) atomicAdd(st + p * S + j, s[j]);
      if (node_mask &&
          !node_mask[((long long)k * P + p) * D + d0 + dl]) continue;
      const int b = B[n * D + d0 + dl];
      float* h = sh + ((p * Dc + dl) * NB + b) * S;
      for (int j = 0; j < S; ++j) atomicAdd(h + j, s[j]);
    }
  } else {
    for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         n < N; n += stride) {
      const int p = rn[n] - offset;
      if (p < 0 || p >= P) continue;
      for (int j = 0; j < S; ++j)
        if (sk[n * S + j] != 0.f)
          atomicAdd(st + p * S + j, sk[n * S + j]);
    }
  }
  __syncthreads();

  if (with_hist) {
    // global layout [K, P, D, NB, S]; this block holds features d0..d0+dc
    float* gh = hist + (long long)k * P * D * NB * S;
    for (int i = threadIdx.x; i < P * dc * NB * S; i += blockDim.x) {
      const int j = i % (NB * S);
      const int pd = i / (NB * S);
      const int p = pd / dc, dl = pd % dc;
      const float v = sh[(p * Dc + dl) * NB * S + j];
      if (v != 0.f) atomicAdd(gh + ((long long)p * D + d0 + dl) * NB * S + j, v);
    }
  }
  if (do_tot) {
    float* gt = totals + (long long)k * P * S;
    for (int i = threadIdx.x; i < P * S; i += blockDim.x)
      if (st[i] != 0.f) atomicAdd(gt + i, st[i]);
  }
}

extern "C" int tree_hist_launch(const void* B, const void* row_node,
                                const void* stats, const void* node_mask,
                                void* hist, void* totals, long long N, int D,
                                int NB, int S, int K, int offset, int P,
                                int Dc, int with_hist, int grid_x,
                                void* stream) {
  const int n_chunks = with_hist ? (D + Dc - 1) / Dc : 1;
  const size_t smem =
      sizeof(float) * ((with_hist ? (size_t)P * Dc * NB * S : 0) + P * S);
  cudaError_t err = cudaFuncSetAttribute(
      tree_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(grid_x, K, n_chunks);
  tree_hist_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const int8_t*)B, (const int32_t*)row_node, (const float*)stats,
      (const uint8_t*)node_mask, (float*)hist, (float*)totals, N, D, NB, S,
      offset, P, Dc, with_hist);
  return (int)cudaGetLastError();
}
