// tree_walk — score rows through tree ensembles stored as perfect heaps and
// reduce over the trees of each member.
//
// Replaces (JAX): transmogrifai_tpu/models/trees.py:_predict_trees_block
// (:668-702) behind predict_trees_raw / predict_trees_sum_grouped /
// predict_trees_agg (:588-665).  The TPU form selects every node field with
// one-hot contractions because gathers are slow there; Hopper gathers.
//
// Rules kept from the reference walk: a leaf stops the walk; a child index
// >= T leaves the row at its node; the compare is x > threshold, so a +inf
// threshold is never taken.  Output [N, M, V]: the sum (or mean) over the
// member's trees, in tree order, of the reached leaf values.
//
// Leaf values pass in chunks of 4 (registers): for V > 4 each thread walks
// its member's trees once per chunk, so any V runs; V <= 4 is one pass.
//
// Design (sized by models/tree_kernels.walk_plan):
// - one 8-byte load a step: each node is packed once per call
//   (tree_walk_pack_kernel) into {int32 feature, or -1 at a leaf; f32
//   threshold bits}; leaf values are read only at the reached node, and a
//   tree's are loaded after its walk and added after the next tree's (the
//   sum keeps tree order);
// - one row a thread: measured on the card, more warps hide the dependent
//   loads better than several rows side by side in fewer warps;
// - a block stages the top sl levels of every tree of its member into
//   shared memory (15 nodes, levels 0-3, by the plan: staging whole
//   depth-6 or depth-12 trees, or levels 0-5, measured slower — a smaller
//   block keeps more of them on an SM): the first sl steps read shared
//   memory only, deeper ones the read-only path;
// - where 4·D is small, the block's rows of X are read once, coalesced,
//   into shared memory (odd row stride); wide X keeps the gather.
// Grid (row blocks, members); the sum runs over the member's trees in
// order in registers, so the result repeats bit for bit.
//
// Bound: device-memory bytes — X once (4*N*D) plus the output (4*N*M*V)
// and the trees.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void tree_walk_pack_kernel(const int32_t* __restrict__ feature,
                                      const float* __restrict__ threshold,
                                      const uint8_t* __restrict__ is_leaf,
                                      int2* __restrict__ packed,
                                      long long nodes) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nodes; i += (long long)gridDim.x * blockDim.x)
    packed[i] = make_int2(is_leaf[i] ? -1 : max(feature[i], 0),
                          __float_as_int(threshold[i]));
}

// one step of a row's walk from its node's packed fields nd: false where
// the walk stops (a leaf, or a child past the heap: the row stays at its
// node), else node moves to the child.  xr: the row of X (in shared memory
// where XS)
template <bool XS>
__device__ __forceinline__ bool walk_step(int2 nd,
                                          const float* __restrict__ xr,
                                          int T, int& node) {
  if (nd.x < 0) return false;
  const float x = XS ? xr[nd.x] : __ldg(xr + nd.x);
  const int nxt = 2 * node + 1 + (x > __int_as_float(nd.y));
  if (nxt >= T) return false;
  node = nxt;
  return true;
}

template <bool XS>
__global__ void __launch_bounds__(256) tree_walk_kernel(
    const float* __restrict__ X, const int2* __restrict__ packed,
    const float* __restrict__ leaf, float* __restrict__ out, long long N,
    int D, int Tm, int T, int V, int M, int steps, int mean, int top,
    int sl, int Dp) {
  extern __shared__ int2 wsm[];
  const int m = blockIdx.y;
  const int2* gm = packed + (long long)m * Tm * T;
  int2* sn = wsm;                                    // [Tm][top]
  float* xs = (float*)(sn + (size_t)Tm * top);       // [rows][Dp]
  const long long n0 = (long long)blockIdx.x * blockDim.x;
  const int rows = (int)min((long long)blockDim.x, N - n0);
  for (int i = threadIdx.x; i < Tm * top; i += blockDim.x) {
    const int t = i / top;
    sn[i] = gm[(long long)t * T + (i - t * top)];
  }
  if (XS) {
    const float* xb = X + n0 * D;
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D;
      xs[r * Dp + (i - r * D)] = __ldg(xb + i);
    }
  }
  __syncthreads();

  // a thread past the last row walks that row again and writes nothing
  const int r = min((int)threadIdx.x, rows - 1);
  const float* xr = XS ? xs + r * Dp : X + (n0 + r) * D;
  const float* lm = leaf + (long long)m * Tm * T * V;
  // the steps whose nodes all lie in the staged top levels
  const int s_st = top == T ? steps : min(sl, steps);
  for (int v0 = 0; v0 < V; v0 += 4) {
    const int vn = min(4, V - v0);
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, pend[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < Tm; ++t) {
      const int2* st = sn + t * top;
      const int2* gt = gm + (long long)t * T;
      int node = 0, s = 0;
      while (s < s_st && walk_step<XS>(st[node], xr, T, node)) ++s;
      if (s == s_st)                       // deeper: the read-only path
        while (s < steps && walk_step<XS>(__ldg(gt + node), xr, T, node))
          ++s;
      // this tree's leaf values are loaded now and added after the next
      // tree's walk, so their latency hides behind it
      const float* lv = lm + ((long long)t * T + node) * V + v0;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        acc[v] += pend[v];
        pend[v] = v < vn ? __ldg(lv + v) : 0.f;
      }
    }
    if (threadIdx.x < rows) {
      float* y = out + ((n0 + threadIdx.x) * M + m) * V + v0;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float a = acc[v] + pend[v];
        if (v < vn) y[v] = mean ? a / (float)Tm : a;
      }
    }
  }
}

template <bool XS>
static int launch_walk(const float* X, const int2* packed, const float* leaf,
                       float* out, long long N, int D, int Tm, int T, int V,
                       int M, int steps, int mean, int top, int sl, int Dp,
                       int threads, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      tree_walk_kernel<XS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + threads - 1) / threads), M);
  tree_walk_kernel<XS><<<grid, threads, smem, s>>>(
      X, packed, leaf, out, N, D, Tm, T, V, M, steps, mean, top, sl, Dp);
  return (int)cudaGetLastError();
}

// the shared-memory bytes of one walk block (models/tree_kernels.walk_plan
// adds the same terms)
static size_t walk_smem(int Tm, int top, int rows, int Dp, int xs) {
  return 8 * (size_t)Tm * top + (xs ? 4 * (size_t)rows * Dp : 0);
}

// packed: the wrapper's int2 [Tr * T] scratch
extern "C" int tree_walk_launch(const void* X, const void* feature,
                                const void* threshold, const void* is_leaf,
                                const void* leaf, void* packed, void* out,
                                long long N, int D, int Tm, int T, int V,
                                int M, int steps, int mean, int threads,
                                int top, int sl, int xs, int Dp, int smem,
                                void* stream) {
  // sl: the steps whose nodes are all staged (the top sl levels: top >=
  // 2^sl - 1, or every node)
  if (V < 1 || N < 1 || D < 1 || Tm < 1 || T < 1 || M < 1 || M > 65535 ||
      top < 0 || top > T || sl < 0 ||
      (top < T && (1LL << min(sl, 40)) - 1 > top) ||
      threads % 32 || threads < 32 || threads > 256 ||
      (xs && Dp < D) ||
      (size_t)smem != walk_smem(Tm, top, threads, Dp, xs) ||
      smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long nodes = (long long)Tm * M * T;
  const int pblocks = (int)min((nodes + 255) / 256, 132LL * 16);
  tree_walk_pack_kernel<<<pblocks, 256, 0, s>>>(
      (const int32_t*)feature, (const float*)threshold,
      (const uint8_t*)is_leaf, (int2*)packed, nodes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* x = (const float*)X;
  const int2* pk = (const int2*)packed;
  const float* lf = (const float*)leaf;
  float* o = (float*)out;
  const size_t sz = (size_t)smem;
  if (xs)
    return launch_walk<true>(x, pk, lf, o, N, D, Tm, T, V, M, steps, mean,
                             top, sl, Dp, threads, sz, s);
  return launch_walk<false>(x, pk, lf, o, N, D, Tm, T, V, M, steps, mean,
                            top, sl, Dp, threads, sz, s);
}
