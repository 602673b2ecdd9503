// fista_softmax_step — one gradient evaluation of the FISTA grid solver for
// L lanes (fold x penalty grid points) of the multinomial (softmax) loss on
// the implicitly standardised matrix.
//
// Replaces (JAX): transmogrifai_tpu/models/solvers.py:_softmax_loss_grad
// (:44-50) inside _fista_loop's smooth_grad (:160-166), with the dense
// closures xs_mv / xs_tmv on [D, C] coefficients (:270-286), vmapped over
// the (fold x grid) lanes by linear_grid_fit (:334-376).  XLA runs that as
// an [N, D] x [D, C] matmul per lane, a log-softmax over the C classes and
// an [N, D]^T x [N, C] matmul, each product reading X from memory.
//
// Computes, for lanes l < L (fold f(l) = (lane0 + l) / G), classes c < C and
// rows n < N, with the column j = l * C + c:
//   m[n,j] = (sum_d X[n,d] * V[j,d] - muv[j]) + b[j]
//   p[n,j] = exp(m[n,j] - max_c' m[n,l*C+c']) / sum_c' exp(...)
//   g[n,j] = W[f,n] * (p[n,j] - [y[n] == c]) / wsum[l]
//   out[d, j] = sum_n X[n,d] * g[n,j]   (d < D),   out[D, j] = sum_n g[n,j]
// (V = coef / scale per class, muv = mean . V: the caller un-standardises.)
//
// Design: the structure of fista_step (csrc/fista_step.cu) with the L*C
// (lane, class) columns in place of its lanes.  One-tile form: a block
// keeps a row tile of X (TR rows x D) in shared memory, forms every (row,
// column) margin (a thread per row and group of 4 columns), then a thread
// per (row, lane) reads that lane's C margins, takes their max, the sum of
// exponentials and writes the C gradients back in place: one thread forms a
// lane's softmax, nothing crosses threads.  Then the tile's X^T g goes into
// the block's accumulators (a thread per (feature, group of 4 columns)).
// Blocks stride over tiles in a fixed order and write partial sums
// [(D+1)*J, n_blocks]; a second kernel adds them over the blocks in a fixed
// order, so the result is the same bit for bit on every run (no atomics:
// the solver's tolerance stop does not wander).  Padding columns (j >= J)
// carry gradient exactly 0.
//
// Wide form (the row tile and coefficient block do not fit one block's
// shared memory): as fista_step's, a margin pass over feature chunks (a
// thread per (row, group of 4 columns), margins in registers) that then
// forms the softmax gradients of its rows in shared memory and writes g
// [N, Jp] to device memory, and fista_step's X^T g pass over feature
// chunks.  At most 32 columns a launch, so a lane's C <= 32 classes are
// always in one launch; the wrapper splits the lanes.
//
// Bound: the larger of two times.  Bytes: X once (4*N*D), the fold weights
// of the lanes' folds (4*N per fold) and y (4*N); at 1M x 16, 8 lanes of one
// fold: 64 + 4 + 4 MB, ~0.021 ms.  Operations: 4*N*D*J f32 (a multiply and
// an add in each of the two products); at 8 lanes x 4 classes 2.05 GFLOP,
// ~0.031 ms at 67 TFLOP/s: bound by operations (24 lanes: ~0.09 ms).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the softmax gradient of lane l's C margins at mt[0..C) (one row), in place
__device__ __forceinline__ void softmax_grad(float* mt, int C, int yn,
                                             float w, float ws) {
  float mx = -INFINITY;
  for (int c = 0; c < C; ++c) mx = fmaxf(mx, mt[c]);
  float s = 0.f;
  for (int c = 0; c < C; ++c) s += expf(mt[c] - mx);
  for (int c = 0; c < C; ++c) {
    const float p = expf(mt[c] - mx) / s;
    mt[c] = w * (p - (c == yn ? 1.f : 0.f)) / ws;
  }
}

__global__ void softmax_partials_kernel(const float* __restrict__ X,
                                        const float* __restrict__ V,
                                        const float* __restrict__ muv,
                                        const float* __restrict__ b,
                                        const float* __restrict__ W,
                                        const int* __restrict__ y,
                                        const float* __restrict__ wsum,
                                        float* __restrict__ partial,
                                        long long N, int D, int L, int C,
                                        int Jp, int lane0, int G, int TR) {
  extern __shared__ float sm[];
  const int J = L * C;
  const int Dp = D | 1;                 // odd stride: conflict-free rows
  const int JG = Jp / 4;                // column groups of 4
  float* xt = sm;                       // [TR][Dp]  X tile
  float* gt = xt + TR * Dp;             // [TR][Jp]  margins, then gradients
  float* vs = gt + TR * Jp;             // [D][Jp]   V transposed
  float* acc = vs + D * Jp;             // [(D+1)][Jp] this block's sums
  float* lp = acc + (D + 1) * Jp;       // [2][Jp] muv, b; then [L] wsum
  const int tid = threadIdx.x, bs = blockDim.x;
  for (int i = tid; i < D * Jp; i += bs) {
    const int d = i / Jp, j = i - d * Jp;
    vs[i] = j < J ? V[(long long)j * D + d] : 0.f;
  }
  for (int i = tid; i < (D + 1) * Jp; i += bs) acc[i] = 0.f;
  for (int j = tid; j < Jp; j += bs) {
    lp[j] = j < J ? muv[j] : 0.f;
    lp[Jp + j] = j < J ? b[j] : 0.f;
  }
  for (int l = tid; l < L; l += bs) lp[2 * Jp + l] = wsum[l];
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

    // margins: item = (row r, column group q); padding rows and columns 0
    for (int it = tid; it < TR * JG; it += bs) {
      const int r = it % TR, q = it / TR;
      float m[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < rows) {
        const float* xr = xt + r * Dp;
        for (int d = 0; d < D; ++d) {
          const float x = xr[d];
          const float4 v = *(const float4*)(vs + d * Jp + 4 * q);
          m[0] = fmaf(x, v.x, m[0]);
          m[1] = fmaf(x, v.y, m[1]);
          m[2] = fmaf(x, v.z, m[2]);
          m[3] = fmaf(x, v.w, m[3]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * q + k;
          m[k] = j < J ? (m[k] - lp[j]) + lp[Jp + j] : 0.f;
        }
      }
      *(float4*)(gt + r * Jp + 4 * q) = make_float4(m[0], m[1], m[2], m[3]);
    }
    __syncthreads();

    // softmax gradients: item = (row r, lane l), the lane's C classes
    for (int it = tid; it < rows * L; it += bs) {
      const int r = it % rows, l = it / rows;
      const long long n = r0 + r;
      softmax_grad(gt + r * Jp + l * C, C, y[n],
                   W[(long long)((lane0 + l) / G) * N + n], lp[2 * Jp + l]);
    }
    __syncthreads();

    // this tile's X^T g: item = (feature d or the ones column D, group q)
    for (int it = tid; it < (D + 1) * JG; it += bs) {
      const int q = it % JG, d = it / JG;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float x = d < D ? xt[r * Dp + d] : 1.f;
        const float4 g = *(const float4*)(gt + r * Jp + 4 * q);
        s0 = fmaf(x, g.x, s0);
        s1 = fmaf(x, g.y, s1);
        s2 = fmaf(x, g.z, s2);
        s3 = fmaf(x, g.w, s3);
      }
      float* a = acc + d * Jp + 4 * q;
      a[0] += s0;
      a[1] += s1;
      a[2] += s2;
      a[3] += s3;
    }
    __syncthreads();
  }

  const long long nb = gridDim.x;
  for (int i = tid; i < (D + 1) * J; i += bs) {
    const int d = i / J, j = i - d * J;
    partial[(long long)i * nb + blockIdx.x] = acc[d * Jp + j];
  }
}

// out[i] = sum over blocks of partial[i, :], in a fixed order
__global__ void softmax_reduce_kernel(const float* __restrict__ partial,
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
// DCp); as float4 loads where rows are 16-byte aligned (vec)
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

// wide form, pass 1: margins over feature chunks, softmax gradients of the
// block's rows in shared memory, then g [N, Jp]
__global__ void softmax_margin_kernel(const float* __restrict__ X,
                                      const float* __restrict__ V,
                                      const float* __restrict__ muv,
                                      const float* __restrict__ b,
                                      const float* __restrict__ W,
                                      const int* __restrict__ y,
                                      const float* __restrict__ wsum,
                                      float* __restrict__ gbuf, long long N,
                                      int D, int L, int C, int Jp, int lane0,
                                      int G, int TR, int DC, int vec) {
  extern __shared__ float sm[];
  const int J = L * C;
  const int JG = Jp / 4;
  const int DCp = DC + 1;                 // odd stride: conflict-free rows
  float* xs = sm;                         // [TR][DCp]; then margins [TR][Jp]
  float* vs = xs + TR * DCp;              // [DC][Jp] (16-B aligned: TR % 32 == 0)
  const int tid = threadIdx.x, bs = blockDim.x;
  const long long r0 = (long long)blockIdx.x * TR;
  const int rows = (int)min((long long)TR, N - r0);
  const int n_items = TR * JG;            // <= 2 * blockDim.x
  float m[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int d0 = 0; d0 < D; d0 += DC) {
    const int dc = min(DC, D - d0);
    load_x_chunk(X, xs, r0, rows, D, d0, dc, DCp, vec);
    for (int i = tid; i < dc * Jp; i += bs) {
      const int d = i / Jp, j = i - d * Jp;
      vs[i] = j < J ? V[(long long)j * D + d0 + d] : 0.f;
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
        const float4 v = *(const float4*)(vs + d * Jp + 4 * q);
        m[k][0] = fmaf(x, v.x, m[k][0]);
        m[k][1] = fmaf(x, v.y, m[k][1]);
        m[k][2] = fmaf(x, v.z, m[k][2]);
        m[k][3] = fmaf(x, v.w, m[k][3]);
      }
    }
    __syncthreads();
  }

  float* mt = xs;                         // TR * Jp <= TR * DCp (Jp <= 32)
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int it = tid + k * bs;
    if (it >= n_items) continue;
    const int r = it % TR, q = it / TR;
    float g[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = 4 * q + t;
      g[t] = (j < J && r < rows) ? (m[k][t] - muv[j]) + b[j] : 0.f;
    }
    *(float4*)(mt + r * Jp + 4 * q) = make_float4(g[0], g[1], g[2], g[3]);
  }
  __syncthreads();
  for (int it = tid; it < rows * L; it += bs) {
    const int r = it % rows, l = it / rows;
    const long long n = r0 + r;
    softmax_grad(mt + r * Jp + l * C, C, y[n],
                 W[(long long)((lane0 + l) / G) * N + n], wsum[l]);
  }
  __syncthreads();
  for (int e = tid; e < rows * JG; e += bs)
    ((float4*)(gbuf + r0 * Jp))[e] = ((const float4*)mt)[e];
}

// wide form, pass 2: X^T g per feature chunk, partial sums per block; the
// blocks of the last grid row (blockIdx.y == number of chunks) sum g alone,
// the ones column
#define XTG_ITEMS 4                       // items per thread: DCx*8 <= 4*256
__global__ void softmax_xtg_kernel(const float* __restrict__ X,
                                   const float* __restrict__ gbuf,
                                   float* __restrict__ partial, long long N,
                                   int D, int J, int Jp, int TR, int DC,
                                   int vec) {
  extern __shared__ float sm[];
  const int JG = Jp / 4;
  const int DCp = DC + 1;
  float* xs = sm;                         // [TR][DCp]
  float* gs = xs + TR * DCp;              // [TR][Jp] (16-B aligned: TR % 32 == 0)
  const int tid = threadIdx.x, bs = blockDim.x;
  const bool ones = blockIdx.y == gridDim.y - 1;
  const int d0 = ones ? D : blockIdx.y * DC;
  const int dc = ones ? 0 : min(DC, D - d0);
  const int n_items = (ones ? 1 : dc) * JG;
  const long long n_tiles = (N + TR - 1) / TR;
  float acc[XTG_ITEMS][4];
#pragma unroll
  for (int k = 0; k < XTG_ITEMS; ++k)
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * TR;
    const int rows = (int)min((long long)TR, N - r0);
    if (!ones) load_x_chunk(X, xs, r0, rows, D, d0, dc, DCp, vec);
    for (int e = tid; e < rows * JG; e += bs)
      ((float4*)gs)[e] = ((const float4*)(gbuf + r0 * Jp))[e];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < XTG_ITEMS; ++k) {
      const int it = tid + k * bs;
      if (it >= n_items) continue;
      const int q = it % JG, d = it / JG;
      float s0 = acc[k][0], s1 = acc[k][1], s2 = acc[k][2], s3 = acc[k][3];
      for (int r = 0; r < rows; ++r) {
        const float x = ones ? 1.f : xs[r * DCp + d];
        const float4 g = *(const float4*)(gs + r * Jp + 4 * q);
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
    const int q = it % JG, d = it / JG;
    const long long dg = d0 + d;          // == D for the ones column
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = 4 * q + t;
      if (j < J) partial[(dg * J + j) * nb + blockIdx.x] = acc[k][t];
    }
  }
}

// wide != 0: the two-pass form (TR, DCm: margin pass tile; TRx, DCx, n_blocks:
// X^T g pass tile and row-tile blocks; smem_a / smem_b their shared memory);
// else the one-tile form (TR rows, n_blocks blocks, smem_a bytes).  L lanes
// of C classes each; out [(D+1) * L*C].
extern "C" int fista_softmax_launch(const void* X, const void* V,
                                    const void* muv, const void* b,
                                    const void* W, const void* y,
                                    const void* wsum, void* gbuf,
                                    void* partial, void* out, long long N,
                                    int D, int L, int C, int lane0, int G,
                                    int wide, int TR, int n_blocks, int DCm,
                                    int TRx, int DCx, int smem_a, int smem_b,
                                    void* stream) {
  if (L < 1 || C < 2 || D < 1 || TR < 1 || n_blocks < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  const int J = L * C;
  const int Jp = (J + 3) / 4 * 4;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (!wide) {
    err = cudaFuncSetAttribute(softmax_partials_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_a);
    if (err != cudaSuccess) return (int)err;
    softmax_partials_kernel<<<n_blocks, 256, smem_a, s>>>(
        (const float*)X, (const float*)V, (const float*)muv, (const float*)b,
        (const float*)W, (const int*)y, (const float*)wsum, (float*)partial,
        N, D, L, C, Jp, lane0, G, TR);
  } else {
    if (J > 32 || TR % 32 || TRx % 32 || TR * (Jp / 4) > 512 ||
        DCx * (Jp / 4) > XTG_ITEMS * 256 || DCm < 1 || DCx < 1 ||
        DCm + 1 < Jp)
      return (int)cudaErrorInvalidValue;
    const int vec = (D % 4 == 0) && ((uintptr_t)X % 16 == 0);
    err = cudaFuncSetAttribute(softmax_margin_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_a);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(softmax_xtg_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_b);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = (N + TR - 1) / TR;
    softmax_margin_kernel<<<(unsigned)tiles, 256, smem_a, s>>>(
        (const float*)X, (const float*)V, (const float*)muv, (const float*)b,
        (const float*)W, (const int*)y, (const float*)wsum, (float*)gbuf, N,
        D, L, C, Jp, lane0, G, TR, DCm, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_blocks, (D + DCx - 1) / DCx + 1);
    softmax_xtg_kernel<<<grid, 256, smem_b, s>>>(
        (const float*)X, (const float*)gbuf, (float*)partial, N, D, J, Jp,
        TRx, DCx, vec);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  softmax_reduce_kernel<<<(D + 1) * J, 256, 0, s>>>((const float*)partial,
                                                    (float*)out, n_blocks);
  return (int)cudaGetLastError();
}
