// fista_step — one gradient evaluation of the FISTA grid solver for L lanes
// (fold x penalty grid points) on the implicitly standardised matrix.
//
// Replaces (JAX): transmogrifai_tpu/models/solvers.py:_fista_loop's
// smooth_grad (:160-166) with the dense closures xs_mv / xs_tmv (:270-286),
// vmapped over the (fold x grid) lanes by linear_grid_fit (:334-376), and the
// power iteration's product of _spectral_norm_sq_weighted (:112-131).  XLA
// runs that as two matmuls per iteration that each read X from memory, with
// the loss gradient between them.
//
// Computes, for lanes l < L (fold f(l) = (lane0 + l) / G) and rows n < N:
//   m[n,l] = (sum_d X[n,d] * V[l,d] - muv[l]) + b[l]
//   g[n,l] = logistic:       W[f,n] * (sigmoid(m) - y[n]) / wsum[l]
//            squared hinge:  W[f,n] * (-2 * max(0, 1 - y[n]*m) * y[n]) / wsum[l]
//            gram:           (W[f,n] / wsum[l]) * m
//   out[d, l] = sum_n X[n,d] * g[n,l]   (d < D),   out[D, l] = sum_n g[n,l]
// (V = coef / scale, muv = mean . V: the caller un-standardises.)
//
// Design: pass 1 reads each row tile of X ONCE for all lanes.  A block keeps
// its tile (TR rows x D) in shared memory with an odd row stride, computes
// every (row, lane) margin and gradient (a thread per row and group of 4
// lanes, V read as float4 from shared memory), writes the tile's gradients
// to shared memory, then adds the tile's X^T g into the block's own
// accumulators (a thread per (feature, group of 4 lanes)).  Blocks stride
// over tiles in a fixed order and write their partial sums to a scratch
// buffer [(D+1)*L, n_blocks].  Pass 2 adds each output's partials over the
// blocks in a fixed order (a fixed split over threads, then a fixed tree),
// so the result is the same bit for bit on every run: no atomics, so the
// solver's tolerance stop (n_iter) does not wander from run to run.
//
// Bound: the larger of two times.  Bytes: X once (4*N*D), the fold weights
// of the lanes' folds (4*N per fold) and y (4*N); at 1M x 28, 24 lanes over
// 3 folds: 112 + 12 + 4 MB, ~38 us.  Operations: 4*N*D*L f32 (a multiply
// and an add in each of the two products) plus ~8*N*L for the margins'
// offsets and the loss; at 24 lanes 2.7 + 0.2 GFLOP, ~43 us at
// 67 TFLOP/s, so the 24-lane logistic shape is bound by operations.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

enum { LOSS_LOGISTIC = 0, LOSS_SQUARED_HINGE = 1, LOSS_GRAM = 2 };

__global__ void fista_partials_kernel(const float* __restrict__ X,
                                      const float* __restrict__ V,
                                      const float* __restrict__ muv,
                                      const float* __restrict__ b,
                                      const float* __restrict__ W,
                                      const float* __restrict__ y,
                                      const float* __restrict__ wsum,
                                      float* __restrict__ partial,
                                      long long N, int D, int L, int Lp,
                                      int lane0, int G, int loss, int TR) {
  extern __shared__ float sm[];
  const int Dp = D | 1;                 // odd stride: conflict-free rows
  const int LG = Lp / 4;                // lane groups of 4
  float* xt = sm;                       // [TR][Dp]  X tile
  float* gt = xt + TR * Dp;             // [TR][Lp]  gradients (16-B aligned)
  float* vs = gt + TR * Lp;             // [D][Lp]   V transposed
  float* acc = vs + D * Lp;             // [(D+1)][Lp] this block's sums
  float* lp = acc + (D + 1) * Lp;       // [3][Lp]   muv, b, wsum
  const int tid = threadIdx.x, bs = blockDim.x;
  for (int i = tid; i < D * Lp; i += bs) {
    const int d = i / Lp, l = i - d * Lp;
    vs[i] = l < L ? V[(long long)l * D + d] : 0.f;
  }
  for (int i = tid; i < (D + 1) * Lp; i += bs) acc[i] = 0.f;
  for (int l = tid; l < Lp; l += bs) {
    lp[l] = l < L ? muv[l] : 0.f;
    lp[Lp + l] = l < L ? b[l] : 0.f;
    lp[2 * Lp + l] = l < L ? wsum[l] : 1.f;
  }
  __syncthreads();

  const long long n_tiles = (N + TR - 1) / TR;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * TR;
    const int rows = (int)min((long long)TR, N - r0);
    const float* xsrc = X + r0 * D;
    for (int e = tid; e < rows * D; e += bs) {
      const int r = e / D;
      xt[r * Dp + (e - r * D)] = xsrc[e];
    }
    __syncthreads();

    // margins and gradients: item = (row r, lane group q)
    for (int it = tid; it < TR * LG; it += bs) {
      const int r = it % TR, q = it / TR;
      float4 g4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows) {
        float m[4] = {0.f, 0.f, 0.f, 0.f};
        const float* xr = xt + r * Dp;
        for (int d = 0; d < D; ++d) {
          const float x = xr[d];
          const float4 v = *(const float4*)(vs + d * Lp + 4 * q);
          m[0] = fmaf(x, v.x, m[0]);
          m[1] = fmaf(x, v.y, m[1]);
          m[2] = fmaf(x, v.z, m[2]);
          m[3] = fmaf(x, v.w, m[3]);
        }
        const long long n = r0 + r;
        const float yn = loss == LOSS_GRAM ? 0.f : y[n];
        float g[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int l = 4 * q + j;
          g[j] = 0.f;
          if (l >= L) continue;
          const float mm = (m[j] - lp[l]) + lp[Lp + l];
          const float w = W[(long long)((lane0 + l) / G) * N + n];
          const float ws = lp[2 * Lp + l];
          if (loss == LOSS_LOGISTIC) {
            const float p = 1.f / (1.f + expf(-mm));
            g[j] = w * (p - yn) / ws;
          } else if (loss == LOSS_SQUARED_HINGE) {
            const float viol = fmaxf(0.f, 1.f - yn * mm);
            g[j] = w * (-2.f * viol * yn) / ws;
          } else {
            g[j] = (w / ws) * mm;
          }
        }
        g4 = make_float4(g[0], g[1], g[2], g[3]);
      }
      *(float4*)(gt + r * Lp + 4 * q) = g4;
    }
    __syncthreads();

    // this tile's X^T g: item = (feature d or the ones column D, group q)
    for (int it = tid; it < (D + 1) * LG; it += bs) {
      const int q = it % LG, d = it / LG;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float x = d < D ? xt[r * Dp + d] : 1.f;
        const float4 g = *(const float4*)(gt + r * Lp + 4 * q);
        s0 = fmaf(x, g.x, s0);
        s1 = fmaf(x, g.y, s1);
        s2 = fmaf(x, g.z, s2);
        s3 = fmaf(x, g.w, s3);
      }
      float* a = acc + d * Lp + 4 * q;
      a[0] += s0;
      a[1] += s1;
      a[2] += s2;
      a[3] += s3;
    }
    __syncthreads();
  }

  const long long nb = gridDim.x;
  for (int i = tid; i < (D + 1) * L; i += bs) {
    const int d = i / L, l = i - d * L;
    partial[(long long)i * nb + blockIdx.x] = acc[d * Lp + l];
  }
}

// out[i] = sum over blocks of partial[i, :], in a fixed order
__global__ void fista_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int nb) {
  __shared__ float red[256];
  const int i = blockIdx.x;
  const float* p = partial + (long long)i * nb;
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

extern "C" int fista_step_launch(const void* X, const void* V,
                                 const void* muv, const void* b,
                                 const void* W, const void* y,
                                 const void* wsum, void* partial, void* out,
                                 long long N, int D, int L, int lane0, int G,
                                 int loss, int TR, int n_blocks,
                                 void* stream) {
  if (L < 1 || D < 1 || TR < 1 || n_blocks < 1 || loss < 0 || loss > 2)
    return (int)cudaErrorInvalidValue;
  const int Lp = (L + 3) / 4 * 4;
  const size_t smem = sizeof(float) * ((size_t)TR * (D | 1) + (size_t)TR * Lp
                                       + (size_t)D * Lp
                                       + (size_t)(D + 1) * Lp + 3 * Lp);
  cudaError_t err = cudaFuncSetAttribute(
      fista_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  fista_partials_kernel<<<n_blocks, 256, smem, s>>>(
      (const float*)X, (const float*)V, (const float*)muv, (const float*)b,
      (const float*)W, (const float*)y, (const float*)wsum, (float*)partial,
      N, D, L, Lp, lane0, G, loss, TR);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fista_reduce_kernel<<<(D + 1) * L, 256, 0, s>>>((const float*)partial,
                                                  (float*)out, n_blocks);
  return (int)cudaGetLastError();
}
