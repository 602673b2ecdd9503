// fista_glm — one evaluation of the FISTA grid solver's smooth part for the
// exp-link GLM losses (poisson, gamma), for L lanes at once: the loss value
// of every lane and, in the gradient form, X^T g and sum g as well.
//
// Replaces (JAX): transmogrifai_tpu/models/solvers.py:_fista_loop's
// smooth_grad and smooth_val (:160-170) with the dense closures xs_mv /
// xs_tmv (:270-286) for the losses _poisson_loss_grad / _gamma_loss_grad
// (:66-80), vmapped over the (fold x grid) lanes by linear_grid_fit
// (:334-376).  The gradient form serves each iteration's smooth_grad at the
// extrapolated point z; the value-only form serves the Beck-Teboulle
// backtracking tests (:189-215), one lane per (lane, trial step) of a ladder
// of trial steps (the wrapper lays them out; models/solvers.py).
//
// Computes, for lanes l < L (fold f(l) = (lane0 + l) / G) and rows n < N:
//   m[n,l] = (sum_d X[n,d] * V[l,d] - muv[l]) + b[l]
//   poisson: mu = exp(clip(m, -30, 30))
//            lw[n,l] = W[f,n] * (mu - y[n] * m)
//            g[n,l]  = W[f,n] * (mu - y[n]) / wsum[l]
//   gamma:   iv = exp(clip(-m, -30, 30))
//            lw[n,l] = W[f,n] * (y[n] * iv + m)
//            g[n,l]  = W[f,n] * (1 - y[n] * iv) / wsum[l]
//   loss[l] = sum_n lw[n,l]                       (both forms)
//   out[d, l] = sum_n X[n,d] * g[n,l] (d < D), out[D, l] = sum_n g[n,l]
//                                                 (gradient form only)
// As in the JAX package, y * m is not clipped: only the exponent is.  The
// wrapper divides loss[l] by wsum[l].
//
// Design (fista_step.cu's one-tile form): a block keeps a row tile of X
// (TR rows x D, odd row stride) and every lane's coefficients (V transposed,
// read as float4) in shared memory, a thread per (row slot, group of 4
// lanes) forms the margins, the row's loss terms and gradients; the loss
// term adds to that (row slot, lane)'s own running sum in shared memory,
// which only that thread ever touches.  In the gradient form the tile's g
// goes to shared memory and a thread per (feature or the ones column, group
// of 4 lanes) adds the tile's X^T g to the block's accumulators.  Blocks
// stride over tiles in a fixed order; at the end a block sums its row slots'
// losses in slot order and writes every output's partial sum to
// partial[rows, n_blocks]; a second kernel adds each output's partials over
// the blocks in a fixed order.  No float atomics anywhere: the same inputs
// give the same bits on every run, so the backtracking test (a loss sum over
// a million rows compared with 1e-12 of slack) and the tolerance stop decide
// the same way on every run.
//
// Bound: the larger of two times.  Bytes: X once (4 N D), the fold weights
// of the lanes' folds (4 N a fold) and y (4 N); at 1M x 16 over 3 folds
// 64 + 12 + 4 MB, ~24 us.  Operations: 2 N D L for the margins, 2 N D L for
// X^T g in the gradient form, ~10 N L for the loss; at 12 lanes 0.5 GFLOP
// (~7 us at 67 TFLOP/s), at the 96 trial lanes of a value pass 3.2 GFLOP
// (~48 us): the gradient form is bound by bytes, a full ladder by
// operations.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fista_loss.cuh"

// loss: 0 poisson, 1 gamma (the wrapper's GLM_LOSSES)
__global__ void fista_glm_kernel(const float* __restrict__ X,
                                 const float* __restrict__ V,
                                 const float* __restrict__ muv,
                                 const float* __restrict__ b,
                                 const float* __restrict__ W,
                                 const float* __restrict__ y,
                                 const float* __restrict__ wsum,
                                 float* __restrict__ partial, long long N,
                                 int D, int L, int Lp, int lane0, int G,
                                 int loss, int grad, int TR) {
  extern __shared__ float sm[];
  const int Dp = D | 1;                 // odd stride: conflict-free rows
  const int LG = Lp / 4;                // lane groups of 4
  float* xt = sm;                       // [TR][Dp]  X tile (TR % 4 == 0)
  float* lt = xt + TR * Dp;             // [TR][Lp]  loss sums per row slot
  float* gt = lt + TR * Lp;             // [TR][Lp]  gradients (grad form)
  float* vs = gt + (grad ? TR * Lp : 0);          // [D][Lp] V transposed
  float* acc = vs + D * Lp;             // [D+1][Lp] X^T g sums (grad form)
  float* lp = acc + (grad ? (D + 1) * Lp : 0);    // [3][Lp] muv, b, 1 / wsum
  const int tid = threadIdx.x, bs = blockDim.x;
  for (int i = tid; i < D * Lp; i += bs) {
    const int d = i / Lp, l = i - d * Lp;
    vs[i] = l < L ? V[(long long)l * D + d] : 0.f;
  }
  for (int i = tid; i < TR * Lp; i += bs) lt[i] = 0.f;
  if (grad)
    for (int i = tid; i < (D + 1) * Lp; i += bs) acc[i] = 0.f;
  for (int l = tid; l < Lp; l += bs) {
    lp[l] = l < L ? muv[l] : 0.f;
    lp[Lp + l] = l < L ? b[l] : 0.f;
    lp[2 * Lp + l] = l < L ? 1.f / wsum[l] : 1.f;   // 1 / wsum
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

    // margins, loss terms and gradients: item = (row slot r, lane group q)
    for (int it = tid; it < TR * LG; it += bs) {
      const int r = it % TR, q = it / TR;
      float g[4] = {0.f, 0.f, 0.f, 0.f};
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
        const float yn = y[n];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int l = 4 * q + j;
          if (l >= L) continue;
          const float mm = (m[j] - lp[l]) + lp[Lp + l];
          const float w = W[(long long)((lane0 + l) / G) * N + n];
          float lw;
          fl_glm(loss == 0, mm, yn, w, lp[2 * Lp + l], lw, g[j]);
          lt[r * Lp + l] += lw;
        }
      }
      if (grad) *(float4*)(gt + r * Lp + 4 * q) =
          make_float4(g[0], g[1], g[2], g[3]);
    }
    __syncthreads();

    if (grad) {
      // this tile's X^T g: item = (feature d or the ones column D, group q)
      for (int it = tid; it < (D + 1) * LG; it += bs) {
        const int q = it % LG, d = it / LG;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float x = d < D ? xt[r * Dp + d] : 1.f;
          const float4 gv = *(const float4*)(gt + r * Lp + 4 * q);
          s0 = fmaf(x, gv.x, s0);
          s1 = fmaf(x, gv.y, s1);
          s2 = fmaf(x, gv.z, s2);
          s3 = fmaf(x, gv.w, s3);
        }
        float* a = acc + d * Lp + 4 * q;
        a[0] += s0;
        a[1] += s1;
        a[2] += s2;
        a[3] += s3;
      }
      __syncthreads();
    }
  }

  // partial rows: the gradient form's (D+1)*L X^T g sums (row d*L + l),
  // then the L losses; the value form's L losses alone
  const long long nb = gridDim.x;
  const int base = grad ? (D + 1) * L : 0;
  if (grad)
    for (int i = tid; i < (D + 1) * L; i += bs) {
      const int d = i / L, l = i - d * L;
      partial[(long long)i * nb + blockIdx.x] = acc[d * Lp + l];
    }
  for (int l = tid; l < L; l += bs) {
    float s = 0.f;
    for (int r = 0; r < TR; ++r) s += lt[r * Lp + l];
    partial[(long long)(base + l) * nb + blockIdx.x] = s;
  }
}

// out[i] = sum over blocks of partial[i, :], in a fixed order
__global__ void glm_reduce_kernel(const float* __restrict__ partial,
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

// grad != 0: the gradient form, out [(D+1)*L + L]; else the value form,
// out [L].  TR rows a tile (a multiple of 4), n_blocks blocks, smem bytes of
// dynamic shared memory (models/linear_kernels.py:glm_launch_plan).
extern "C" int fista_glm_launch(const void* X, const void* V,
                                const void* muv, const void* b,
                                const void* W, const void* y,
                                const void* wsum, void* partial, void* out,
                                long long N, int D, int L, int lane0, int G,
                                int loss, int grad, int TR, int n_blocks,
                                int smem, void* stream) {
  if (L < 1 || D < 1 || G < 1 || TR < 4 || TR % 4 || n_blocks < 1 ||
      loss < 0 || loss > 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const int Lp = (L + 3) / 4 * 4;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      fista_glm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fista_glm_kernel<<<n_blocks, 256, smem, s>>>(
      (const float*)X, (const float*)V, (const float*)muv, (const float*)b,
      (const float*)W, (const float*)y, (const float*)wsum, (float*)partial,
      N, D, L, Lp, lane0, G, loss, grad, TR);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = grad ? (D + 1) * L + L : L;
  glm_reduce_kernel<<<rows, 256, 0, s>>>((const float*)partial, (float*)out,
                                         n_blocks);
  return (int)cudaGetLastError();
}
