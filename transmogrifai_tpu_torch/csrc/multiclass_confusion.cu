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
// Two forms; metrics_kernels.confusion_plan picks one by C and sizes it.
//
// The thread form (C up to 14: 4 C^2 bytes of cells for each of 256
// threads within a block's shared memory).  The threads of a
// block cover a tile of rows x candidates in P's own row-major order: thread
// t takes candidate k0 + t % kc and row t / kc of each pass of `rb` rows, so
// a warp's loads of P are contiguous and each thread keeps one candidate for
// the whole launch.  A thread adds each of its rows (a grid-stride walk, in
// row order, in batches of CONF_UNROLL rows, the next batch's loads in
// flight while the current one is added) into its own C*C cells, a column
// of shared memory (one read-modify-write a row): no warp vote and no
// atomic in the loop.  (Cells in registers, each row added to every cell as
// its weight or +0 by an unrolled select, measured slower at every C <= 8
// on an H100: 0.092 against 0.056 ms at 1M x 24, C = 4.)  Rows of weight 0,
// and labels or predictions outside [0, C), add nothing (+0 leaves a sum
// that started at +0 unchanged).  Then the threads that share a candidate
// are added in a fixed tree in shared memory (halving from the next power
// of two of rb), into one partial per block.
//
// The shared form (larger C).  A histogram in shared memory, one private copy
// per warp, for a chunk of candidates and a chunk of true classes (grid y
// and z): the plan chunks candidates, then warps, then classes so that any C
// fits.  A warp takes 32 rows at a time; for each candidate each lane forms
// its row's cell (y * C + p), __match_any_sync groups the lanes of one cell,
// and the group's lowest lane adds the group's weights in lane order to the
// warp's histogram.  At the end the warps' copies are added in warp order
// into one partial per block.
//
// Both forms write partial sums [K*C*C, n_blocks]; a second kernel adds those
// over the blocks in a fixed order (a strided sum a thread, then a tree).  No
// float atomics: the same inputs give the same bits for any weights, and
// metrics_kernels.confusion_emulate gives them in numpy.
//
// Bound: bytes.  P once (4*N*K), y (4*N) and the fold masks (4*N*F); at 1M
// rows x 24 candidates over 3 folds: 96 + 4 + 12 MB, ~0.033 ms at 3.35
// TB/s.  The operations (a compare and add a row, candidate and cell) stay
// below that for C <= 14.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int CONF_UNROLL = 8;          // the thread form's rows a batch

// the next batch of a thread's rows: label, prediction and weight of rows
// n0, n0 + step, ... (a label of -1 past the last row)
__device__ __forceinline__ void conf_fetch(const int* __restrict__ y,
                                           const int* __restrict__ P,
                                           const float* __restrict__ w,
                                           long long n0, long long step,
                                           long long N, int K, int k,
                                           int (&a)[CONF_UNROLL],
                                           int (&p)[CONF_UNROLL],
                                           float (&v)[CONF_UNROLL]) {
#pragma unroll
  for (int u = 0; u < CONF_UNROLL; ++u) {
    const long long n = n0 + u * step;
    a[u] = -1;
    p[u] = -1;
    v[u] = 0.f;
    if (n < N) {
      a[u] = __ldg(y + n);
      p[u] = __ldg(P + n * K + k);
      v[u] = __ldg(w + n);
    }
  }
}

// A thread's C*C cells are its own column of the block's shared memory,
// cell i of thread t at red[i * blockDim.x + t] (conflict-free), each row
// one read-modify-write of its own cell, added in row order from +0.  The
// loads of a thread's next batch of rows are issued before its current
// batch is added, so they fly while it computes.
// CT > 0 fixes C at compile time (C = 2 .. 4, where it measured 11%
// faster on an H100 at 1M x 24, C = 4: 0.0557 against 0.0619 ms); CT = 0
// reads it from `c` (C = 1 and 5 .. 14: the same time as the fixed C at
// C = 8).  These take 64 registers a thread (a fixed C = 1 took 73), so
// the plan's blocks an SM hold for every C.
template <int CT>
__global__ void __launch_bounds__(256) confusion_thread_kernel(
    const int* __restrict__ y, const int* __restrict__ P,
    const float* __restrict__ Wm, float* __restrict__ partial, long long N,
    int K, int c, int G, int kc, int rb) {
  extern __shared__ float red[];        // [C*C][blockDim.x]
  const int C = CT > 0 ? CT : c, CC = C * C;
  const int T = blockDim.x, t = threadIdx.x;
  const int kl = t % kc, rl = t / kc;
  const int k = blockIdx.y * kc + kl;
  const bool live = rl < rb && k < K;
#pragma unroll
  for (int i = 0; i < CC; ++i) red[i * T + t] = 0.f;
  if (live) {
    const float* w = Wm + (long long)(k / G) * N;
    const long long step = (long long)gridDim.x * rb;
    long long n0 = (long long)blockIdx.x * rb + rl;
    int a[CONF_UNROLL], p[CONF_UNROLL];
    float v[CONF_UNROLL];
    conf_fetch(y, P, w, n0, step, N, K, k, a, p, v);
    for (; n0 < N; n0 += CONF_UNROLL * step) {
      int cell[CONF_UNROLL];
      float cv[CONF_UNROLL];
#pragma unroll
      for (int u = 0; u < CONF_UNROLL; ++u) {
        const bool ok = a[u] >= 0 && a[u] < C && p[u] >= 0 && p[u] < C;
        cell[u] = ok ? a[u] * C + p[u] : -1;
        cv[u] = v[u];
      }
      conf_fetch(y, P, w, n0 + CONF_UNROLL * step, step, N, K, k, a, p, v);
#pragma unroll
      for (int u = 0; u < CONF_UNROLL; ++u)
        if (cell[u] >= 0) red[cell[u] * T + t] += cv[u];
    }
  }
  __syncthreads();
  int h = 1;
  while (h < rb) h <<= 1;
  for (h >>= 1; h >= 1; h >>= 1) {      // the fixed tree over rows rl
    if (live && rl < h && rl + h < rb) {
#pragma unroll
      for (int i = 0; i < CC; ++i)
        red[i * T + t] += red[i * T + t + h * kc];
    }
    __syncthreads();
  }
  if (live && rl == 0) {
    const long long nb = gridDim.x;
#pragma unroll
    for (int i = 0; i < CC; ++i)
      partial[((long long)k * CC + i) * nb + blockIdx.x] = red[i * T + t];
  }
}

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
// partial f32 [K*C*C, n_blocks]; out f32 [K, C, C].  form 0 (the thread
// form): k_chunk candidates a block, `rows` rows a pass, k_chunk *
// rows <= threads <= 256, smem = 4 C^2 threads; form 1 (the shared form):
// k_chunk candidates and c_chunk true classes a block, threads / 32 warps,
// smem bytes of histograms.
extern "C" int multiclass_confusion_launch(const void* y, const void* P,
                                           const void* Wm, void* partial,
                                           void* out, long long N, int K,
                                           int C, int G, int form,
                                           int k_chunk, int c_chunk,
                                           int threads, int rows,
                                           int n_blocks, int smem,
                                           void* stream) {
  if (N < 1 || K < 1 || C < 1 || G < 1 || k_chunk < 1 || c_chunk < 1 ||
      n_blocks < 1 || threads < 1 || (long long)K * C * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int *yi = (const int*)y, *Pi = (const int*)P;
  const float* W = (const float*)Wm;
  float* part = (float*)partial;
  cudaError_t err;
  if (form == 0) {
    if (rows < 1 || k_chunk * rows > threads || threads > 256 ||
        smem != 4 * C * C * threads)
      return (int)cudaErrorInvalidValue;
    static void (*const by_c[4])(const int*, const int*, const float*,
                                 float*, long long, int, int, int, int,
                                 int) = {
        confusion_thread_kernel<0>, confusion_thread_kernel<2>,
        confusion_thread_kernel<3>, confusion_thread_kernel<4>};
    const auto kernel = by_c[C >= 2 && C <= 4 ? C - 1 : 0];
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_blocks, (K + k_chunk - 1) / k_chunk);
    kernel<<<grid, threads, smem, s>>>(yi, Pi, W, part, N, K, C, G, k_chunk,
                                       rows);
    err = cudaGetLastError();
  } else if (form == 1) {
    if (threads % 32 || threads > 1024) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(confusion_partials_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_blocks, (K + k_chunk - 1) / k_chunk,
                    (C + c_chunk - 1) / c_chunk);
    confusion_partials_kernel<<<grid, threads, smem, s>>>(
        yi, Pi, W, part, N, K, C, G, k_chunk, c_chunk);
    err = cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  confusion_reduce_kernel<<<K * C * C, 256, 0, s>>>(part, (float*)out,
                                                    n_blocks);
  return (int)cudaGetLastError();
}
