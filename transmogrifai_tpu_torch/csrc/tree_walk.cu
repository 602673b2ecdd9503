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
// member's trees of the reached leaf values.
//
// Leaf values pass in chunks of 4 (registers): for V > 4 each thread walks
// its member's trees once per chunk, so any V runs; V <= 4 is one pass.
//
// Design: grid (row blocks, members); the member's tree arrays are staged
// into shared memory once per block (read from device memory instead when
// they exceed the 227 KB a block can hold); one thread per (row, member) walks the
// member's trees in order and accumulates in registers, so the reduction is
// fused and deterministic.  X is gathered from the row's own 4*D bytes.
//
// Bound: device-memory bytes — X once (4*N*D) plus the output (4*N*M*V).
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void tree_walk_kernel(const float* __restrict__ X,
                                 const int32_t* __restrict__ feature,
                                 const float* __restrict__ threshold,
                                 const uint8_t* __restrict__ is_leaf,
                                 const float* __restrict__ leaf,
                                 float* __restrict__ out, long long N, int D,
                                 int Tm, int T, int V, int M, int steps,
                                 int mean, int staged) {
  extern __shared__ unsigned char smem[];
  const int m = blockIdx.y;
  const int nodes = Tm * T;
  const long long base = (long long)m * nodes;
  // member's trees: staged in shared memory when they fit, else read from
  // device memory (deep trees)
  const float* s_thr = threshold + base;
  const float* s_leaf = leaf + base * V;
  const int32_t* s_feat = feature + base;
  const uint8_t* s_isleaf = is_leaf + base;
  if (staged) {
    float* thr_sm = (float*)smem;
    float* leaf_sm = thr_sm + nodes;
    int32_t* feat_sm = (int32_t*)(leaf_sm + nodes * V);
    uint8_t* isleaf_sm = (uint8_t*)(feat_sm + nodes);
    for (int i = threadIdx.x; i < nodes; i += blockDim.x) {
      thr_sm[i] = s_thr[i];
      feat_sm[i] = s_feat[i];
      isleaf_sm[i] = s_isleaf[i];
    }
    for (int i = threadIdx.x; i < nodes * V; i += blockDim.x)
      leaf_sm[i] = s_leaf[i];
    s_thr = thr_sm;
    s_leaf = leaf_sm;
    s_feat = feat_sm;
    s_isleaf = isleaf_sm;
  }
  __syncthreads();

  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* x = X + n * D;
  float* y = out + (n * M + m) * V;
  for (int v0 = 0; v0 < V; v0 += 4) {
    const int vn = min(4, V - v0);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < Tm; ++t) {
      const int o = t * T;
      int node = 0;
      for (int s = 0; s < steps; ++s) {
        if (s_isleaf[o + node]) break;
        const int nxt = 2 * node + 1 + (x[s_feat[o + node]] > s_thr[o + node]);
        if (nxt >= T) break;      // bottom level: the row stays put
        node = nxt;
      }
      for (int v = 0; v < vn; ++v) acc[v] += s_leaf[(o + node) * V + v0 + v];
    }
    for (int v = 0; v < vn; ++v)
      y[v0 + v] = mean ? acc[v] / (float)Tm : acc[v];
  }
}

extern "C" int tree_walk_launch(const void* X, const void* feature,
                                const void* threshold, const void* is_leaf,
                                const void* leaf, void* out, long long N,
                                int D, int Tm, int T, int V, int M, int steps,
                                int mean, void* stream) {
  if (V < 1) return (int)cudaErrorInvalidValue;
  const size_t nodes = (size_t)Tm * T;
  size_t smem = nodes * (sizeof(float) * (1 + V) + sizeof(int32_t) + 1);
  const int staged = smem <= 227 * 1024;
  if (!staged) smem = 0;
  cudaError_t err = cudaFuncSetAttribute(
      tree_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((N + 255) / 256), M);
  tree_walk_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const float*)X, (const int32_t*)feature, (const float*)threshold,
      (const uint8_t*)is_leaf, (const float*)leaf, (float*)out, N, D, Tm, T,
      V, M, steps, mean, staged);
  return (int)cudaGetLastError();
}
