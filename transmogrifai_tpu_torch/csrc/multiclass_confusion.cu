// multiclass_confusion — weighted [C, C] confusion matrices of K candidates'
// integer predictions, one per candidate, over fold row weights.
//
// Replaces (JAX): transmogrifai_tpu/metrics_device.py:
// masked_multiclass_confusion (:135-141), a one-hot x one-hot matmul on the
// MXU standing in for a (y, y_hat) histogram, vmapped over every (fold x
// candidate) by masked_multiclass_metric_grid / _fold_grid (:202-230).
//
// Computes conf[k, a, c] = sum_n [y[n] == a] [P[n, k] == c] Wm[(k) / G, n]
// for candidates k < K, classes a, c < C.
//
// Design: a histogram in shared memory, one private copy per warp, for a
// chunk of candidates and a chunk of true classes (grid y and z): the plan
// (metrics_kernels.confusion_plan) chunks candidates, then warps, then
// classes so that any C fits.  A warp takes 32 rows at a time; for each
// candidate each lane forms its row's cell (y * C + p), __match_any_sync
// groups the lanes of one cell, and the group's lowest lane adds the
// group's weights in lane order to the warp's histogram.  Rows of zero
// weight add nothing (+0 is exact on a non-negative sum) and are skipped.
// At the end the warps' copies are added in warp order into partial sums
// per block [K*C*C, n_blocks], and a second kernel adds those over the
// blocks in a fixed order.  No float atomics: the same inputs give the same
// bits for any weights.
//
// Bound: bytes.  P once (4*N*K), y (4*N) and the fold masks (4*N*F); at 1M
// rows x 24 candidates over 3 folds: 96 + 4 + 12 MB, ~0.033 ms at 3.35
// TB/s.  The operations (one compare and add a row and candidate) are far
// below that.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void confusion_partials_kernel(const int* __restrict__ y,
                                          const int* __restrict__ P,
                                          const float* __restrict__ Wm,
                                          float* __restrict__ partial,
                                          long long N, int K, int C, int G,
                                          int k_chunk, int c_chunk) {
  extern __shared__ float hist[];       // [warps][k_chunk][c_chunk * C]
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.y * k_chunk, kn = min(k_chunk, K - k0);
  const int c0 = blockIdx.z * c_chunk, cn = min(c_chunk, C - c0);
  const int cells = cn * C;             // this block's cells a candidate
  const int hsz = k_chunk * c_chunk * C;
  __shared__ float stage[32][32];       // [warp][lane] weights (<= 32 warps)
  float* h = hist + warp * hsz;
  for (int i = threadIdx.x; i < warps * hsz; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();

  const long long groups = (N + 31) / 32;
  const long long tw = (long long)gridDim.x * warps;
  for (long long g = (long long)blockIdx.x * warps + warp; g < groups;
       g += tw) {
    const long long n = g * 32 + lane;
    const bool valid = n < N;
    const int a = valid ? y[n] - c0 : -1;
    const bool in_rows = a >= 0 && a < cn;
    for (int k = 0; k < kn; ++k) {
      const int kk = k0 + k;
      float w = 0.f;
      int cell = -1;
      if (in_rows) {
        w = Wm[(long long)(kk / G) * N + n];
        const int c = P[n * K + kk];
        if (w != 0.f && c >= 0 && c < C) cell = a * C + c;
      }
      stage[warp][lane] = w;
      __syncwarp();
      const unsigned grp = __match_any_sync(0xffffffffu, cell);
      if (cell >= 0 && lane == __ffs(grp) - 1) {
        float s = 0.f;
        for (unsigned m = grp; m; m &= m - 1) s += stage[warp][__ffs(m) - 1];
        h[k * cells + cell] += s;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  const long long nb = gridDim.x;
  for (int i = threadIdx.x; i < kn * cells; i += blockDim.x) {
    float s = 0.f;
    for (int v = 0; v < warps; ++v) s += hist[v * hsz + i];
    const int k = i / cells, r = i - k * cells;     // r = a * C + c
    const long long out = ((long long)(k0 + k) * C + c0) * C + r;
    partial[out * nb + blockIdx.x] = s;
  }
}

// out[i] = sum over blocks of partial[i, :], in a fixed order
__global__ void confusion_reduce_kernel(const float* __restrict__ partial,
                                        float* __restrict__ out, int nb) {
  __shared__ float red[256];
  const long long i = blockIdx.x;
  const float* p = partial + i * nb;
  float s = 0.f;
  for (int j = threadIdx.x; j < nb; j += blockDim.x) s += p[j];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[i] = red[0];
}

// y int32 [N]; P int32 [N, K]; Wm f32 [F, N], candidate k reading row k / G;
// partial f32 [K*C*C, n_blocks]; out f32 [K, C, C].  The plan's chunks:
// k_chunk candidates and c_chunk true classes a block, `warps` warps, smem
// bytes of histograms.
extern "C" int multiclass_confusion_launch(const void* y, const void* P,
                                           const void* Wm, void* partial,
                                           void* out, long long N, int K,
                                           int C, int G, int k_chunk,
                                           int c_chunk, int warps,
                                           int n_blocks, int smem,
                                           void* stream) {
  if (N < 1 || K < 1 || C < 1 || G < 1 || k_chunk < 1 || c_chunk < 1 ||
      warps < 1 || warps > 32 || n_blocks < 1 ||
      (long long)K * C * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      confusion_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_blocks, (K + k_chunk - 1) / k_chunk,
                  (C + c_chunk - 1) / c_chunk);
  confusion_partials_kernel<<<grid, warps * 32, smem, s>>>(
      (const int*)y, (const int*)P, (const float*)Wm, (float*)partial, N, K,
      C, G, k_chunk, c_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  confusion_reduce_kernel<<<K * C * C, 256, 0, s>>>((const float*)partial,
                                                    (float*)out, n_blocks);
  return (int)cudaGetLastError();
}
