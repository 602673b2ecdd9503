// fista_step — one gradient evaluation of the FISTA grid solver for L lanes
// (fold x penalty grid points) on the implicitly standardised matrix.
//
// Replaces (JAX): transmogrifai_tpu/models/solvers.py:_fista_loop's
// smooth_grad (:160-166) with the dense closures xs_mv / xs_tmv (:270-286),
// vmapped over the (fold x grid) lanes by linear_grid_fit (:334-376), and the
// power iteration's product of _spectral_norm_sq_weighted (:112-131); the
// squared loss's row gradient is _squared_loss_grad (:53-56).  XLA
// runs that as two matmuls per iteration that each read X from memory, with
// the loss gradient between them.
//
// Computes, for lanes l < L (fold f(l) = (lane0 + l) / G) and rows n < N:
//   m[n,l] = (sum_d X[n,d] * V[l,d] - muv[l]) + b[l]
//   g[n,l] = logistic:       W[f,n] * (sigmoid(m) - y[n]) / wsum[l]
//            squared hinge:  W[f,n] * (-2 * max(0, 1 - y[n]*m) * y[n]) / wsum[l]
//            gram:           (W[f,n] / wsum[l]) * m
//            squared:        W[f,n] * (m - y[n]) / wsum[l]
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
// The wide form, for a matrix whose row tile and coefficient block do not fit
// one block's shared memory (a transmogrified vector of 1,596 columns, up to
// the 16,384 hashed columns the JAX package allows), makes two passes, both
// tiled over rows and over chunks of features:
//   fista_margin_kernel: a block owns a tile of TRm rows and walks the
//     features in chunks of DCm, X chunk and V chunk in shared memory, a
//     thread per (row, group of 4 lanes) keeping its margins in registers;
//     then it forms g for its rows and writes g [N, Lp] to device memory.
//   fista_xtg_kernel: block (b, c) owns feature chunk c (DCx features; an
//     extra last c the ones column, i.e. g's sums) and strides over row
//     tiles b, b+nb, ..., adding X_tile^T g_tile into registers (a thread
//     per (feature, lane group)), and writes its partial sums to
//     partial[(D+1)*L, nb].
// Both passes load X as float4 (four in flight per thread) where its rows
// are 16-byte aligned.
// The same fixed-order reduction finishes both forms.  X is read twice
// (once per pass) instead of once; g makes one round trip.  Lanes go 32 to
// a launch.
//
// Bound: the larger of two times.  Bytes: X once (4*N*D), the fold weights
// of the lanes' folds (4*N per fold) and y (4*N); at 1M x 28, 24 lanes over
// 3 folds: 112 + 12 + 4 MB, ~38 us.  Operations: 4*N*D*L f32 (a multiply
// and an add in each of the two products) plus ~8*N*L for the margins'
// offsets and the loss; at 24 lanes 2.7 + 0.2 GFLOP, ~43 us at
// 67 TFLOP/s, so the 24-lane logistic shape is bound by operations.  At
// 1M x 1,596 with 6 lanes (3 folds x 2): X is 6.4 GB, ~1.9 ms, against
// 38 GFLOP, ~0.57 ms: bound by bytes (the wide form reads X twice).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

enum { LOSS_LOGISTIC = 0, LOSS_SQUARED_HINGE = 1, LOSS_GRAM = 2,
       LOSS_SQUARED = 3 };

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
          } else if (loss == LOSS_SQUARED) {
            g[j] = w * (mm - yn) / ws;
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

// rows x dc floats of X (row stride D, from column d0) into xs (row stride
// DCp).  With vec (rows 16-byte aligned: D % 4 == 0, X aligned) as float4
// loads, several in flight per thread; else one float at a time.
__device__ __forceinline__ void load_x_chunk(const float* __restrict__ X,
                                             float* __restrict__ xs,
                                             long long r0, int rows, int D,
                                             int d0, int dc, int DCp,
                                             bool vec) {
  const int tid = threadIdx.x, bs = blockDim.x;
  if (vec) {
    const int c4n = dc >> 2;              // dc % 4 == 0 when D % 4 == 0
#pragma unroll 4
    for (int e = tid; e < rows * c4n; e += bs) {
      const int r = e / c4n, c = (e - r * c4n) << 2;
      const float4 v = *(const float4*)(X + (r0 + r) * D + d0 + c);
      float* dst = xs + r * DCp + c;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else {
    for (int e = tid; e < rows * dc; e += bs) {
      const int r = e / dc, c = e - r * dc;
      xs[r * DCp + c] = X[(r0 + r) * D + d0 + c];
    }
  }
}

// wide form, pass 1: margins over feature chunks, then g [N, Lp]
__global__ void fista_margin_kernel(const float* __restrict__ X,
                                    const float* __restrict__ V,
                                    const float* __restrict__ muv,
                                    const float* __restrict__ b,
                                    const float* __restrict__ W,
                                    const float* __restrict__ y,
                                    const float* __restrict__ wsum,
                                    float* __restrict__ gbuf, long long N,
                                    int D, int L, int Lp, int lane0, int G,
                                    int loss, int TR, int DC, int vec) {
  extern __shared__ float sm[];
  const int LG = Lp / 4;
  const int DCp = DC + 1;                 // odd stride: conflict-free rows
  float* xs = sm;                         // [TR][DCp]
  float* vs = xs + TR * DCp;              // [DC][Lp] (16-B aligned: TR % 32 == 0)
  const int tid = threadIdx.x, bs = blockDim.x;
  const long long r0 = (long long)blockIdx.x * TR;
  const int rows = (int)min((long long)TR, N - r0);
  const int n_items = TR * LG;            // <= 2 * blockDim.x
  float m[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int d0 = 0; d0 < D; d0 += DC) {
    const int dc = min(DC, D - d0);
    load_x_chunk(X, xs, r0, rows, D, d0, dc, DCp, vec);
    for (int i = tid; i < dc * Lp; i += bs) {
      const int d = i / Lp, l = i - d * Lp;
      vs[i] = l < L ? V[(long long)l * D + d0 + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int it = tid + k * bs;
      if (it >= n_items) continue;
      const int r = it % TR, q = it / TR;
      if (r >= rows) continue;
      const float* xr = xs + r * DCp;
      for (int d = 0; d < dc; ++d) {
        const float x = xr[d];
        const float4 v = *(const float4*)(vs + d * Lp + 4 * q);
        m[k][0] = fmaf(x, v.x, m[k][0]);
        m[k][1] = fmaf(x, v.y, m[k][1]);
        m[k][2] = fmaf(x, v.z, m[k][2]);
        m[k][3] = fmaf(x, v.w, m[k][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int it = tid + k * bs;
    if (it >= n_items) continue;
    const int r = it % TR, q = it / TR;
    if (r >= rows) continue;
    const long long n = r0 + r;
    const float yn = loss == LOSS_GRAM ? 0.f : y[n];
    float g[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = 4 * q + j;
      g[j] = 0.f;
      if (l >= L) continue;
      const float mm = (m[k][j] - muv[l]) + b[l];
      const float w = W[(long long)((lane0 + l) / G) * N + n];
      const float ws = wsum[l];
      if (loss == LOSS_LOGISTIC) {
        const float p = 1.f / (1.f + expf(-mm));
        g[j] = w * (p - yn) / ws;
      } else if (loss == LOSS_SQUARED_HINGE) {
        const float viol = fmaxf(0.f, 1.f - yn * mm);
        g[j] = w * (-2.f * viol * yn) / ws;
      } else if (loss == LOSS_SQUARED) {
        g[j] = w * (mm - yn) / ws;
      } else {
        g[j] = (w / ws) * mm;
      }
    }
    *(float4*)(gbuf + n * Lp + 4 * q) = make_float4(g[0], g[1], g[2], g[3]);
  }
}

// wide form, pass 2: X^T g per feature chunk, partial sums per block; the
// blocks of the last grid row (blockIdx.y == number of chunks) sum g alone,
// the ones column
#define XTG_ITEMS 4                       // items per thread: DCx*8 <= 4*256
__global__ void fista_xtg_kernel(const float* __restrict__ X,
                                 const float* __restrict__ gbuf,
                                 float* __restrict__ partial, long long N,
                                 int D, int L, int Lp, int TR, int DC,
                                 int vec) {
  extern __shared__ float sm[];
  const int LG = Lp / 4;
  const int DCp = DC + 1;
  float* xs = sm;                         // [TR][DCp]
  float* gs = xs + TR * DCp;              // [TR][Lp] (16-B aligned: TR % 32 == 0)
  const int tid = threadIdx.x, bs = blockDim.x;
  const bool ones = blockIdx.y == gridDim.y - 1;
  const int d0 = ones ? D : blockIdx.y * DC;
  const int dc = ones ? 0 : min(DC, D - d0);
  const int n_items = (ones ? 1 : dc) * LG;
  const long long n_tiles = (N + TR - 1) / TR;
  float acc[XTG_ITEMS][4];
#pragma unroll
  for (int k = 0; k < XTG_ITEMS; ++k)
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * TR;
    const int rows = (int)min((long long)TR, N - r0);
    if (!ones) load_x_chunk(X, xs, r0, rows, D, d0, dc, DCp, vec);
    for (int e = tid; e < rows * LG; e += bs)
      ((float4*)gs)[e] = ((const float4*)(gbuf + r0 * Lp))[e];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < XTG_ITEMS; ++k) {
      const int it = tid + k * bs;
      if (it >= n_items) continue;
      const int q = it % LG, d = it / LG;
      float s0 = acc[k][0], s1 = acc[k][1], s2 = acc[k][2], s3 = acc[k][3];
      for (int r = 0; r < rows; ++r) {
        const float x = ones ? 1.f : xs[r * DCp + d];
        const float4 g = *(const float4*)(gs + r * Lp + 4 * q);
        s0 = fmaf(x, g.x, s0);
        s1 = fmaf(x, g.y, s1);
        s2 = fmaf(x, g.z, s2);
        s3 = fmaf(x, g.w, s3);
      }
      acc[k][0] = s0;
      acc[k][1] = s1;
      acc[k][2] = s2;
      acc[k][3] = s3;
    }
    __syncthreads();
  }

  const long long nb = gridDim.x;
#pragma unroll
  for (int k = 0; k < XTG_ITEMS; ++k) {
    const int it = tid + k * bs;
    if (it >= n_items) continue;
    const int q = it % LG, d = it / LG;
    const long long dg = d0 + d;          // == D for the ones column
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = 4 * q + j;
      if (l < L) partial[(dg * L + l) * nb + blockIdx.x] = acc[k][j];
    }
  }
}

// wide != 0: the two-pass form (TR, DCm: margin pass tile; TRx, DCx, n_blocks:
// X^T g pass tile and row-tile blocks; smem_a / smem_b their shared memory);
// else the one-tile form (TR rows, n_blocks blocks, smem_a bytes).
extern "C" int fista_step_launch(const void* X, const void* V,
                                 const void* muv, const void* b,
                                 const void* W, const void* y,
                                 const void* wsum, void* gbuf, void* partial,
                                 void* out, long long N, int D, int L,
                                 int lane0, int G, int loss, int wide, int TR,
                                 int n_blocks, int DCm, int TRx, int DCx,
                                 int smem_a, int smem_b, void* stream) {
  if (L < 1 || D < 1 || TR < 1 || n_blocks < 1 || loss < 0 || loss > 3)
    return (int)cudaErrorInvalidValue;
  const int Lp = (L + 3) / 4 * 4;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (!wide) {
    err = cudaFuncSetAttribute(fista_partials_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_a);
    if (err != cudaSuccess) return (int)err;
    fista_partials_kernel<<<n_blocks, 256, smem_a, s>>>(
        (const float*)X, (const float*)V, (const float*)muv, (const float*)b,
        (const float*)W, (const float*)y, (const float*)wsum,
        (float*)partial, N, D, L, Lp, lane0, G, loss, TR);
  } else {
    if (L > 32 || TR % 32 || TRx % 32 || TR * (Lp / 4) > 512 ||
        DCx * (Lp / 4) > XTG_ITEMS * 256 || DCm < 1 || DCx < 1)
      return (int)cudaErrorInvalidValue;
    const int vec = (D % 4 == 0) && ((uintptr_t)X % 16 == 0);
    err = cudaFuncSetAttribute(fista_margin_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_a);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(fista_xtg_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_b);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = (N + TR - 1) / TR;
    fista_margin_kernel<<<(unsigned)tiles, 256, smem_a, s>>>(
        (const float*)X, (const float*)V, (const float*)muv, (const float*)b,
        (const float*)W, (const float*)y, (const float*)wsum, (float*)gbuf,
        N, D, L, Lp, lane0, G, loss, TR, DCm, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_blocks, (D + DCx - 1) / DCx + 1);
    fista_xtg_kernel<<<grid, 256, smem_b, s>>>(
        (const float*)X, (const float*)gbuf, (float*)partial, N, D, L, Lp,
        TRx, DCx, vec);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fista_reduce_kernel<<<(D + 1) * L, 256, 0, s>>>((const float*)partial,
                                                  (float*)out, n_blocks);
  return (int)cudaGetLastError();
}
