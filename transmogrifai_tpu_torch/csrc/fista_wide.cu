// fista_wide — the feature-chunked two-pass form of one FISTA gradient
// evaluation, for every loss of fista_step, fista_softmax and fista_glm:
// the shapes whose tensor-core launch (fista_tc.cuh) or one-tile launch
// (fista_glm.cu) does not fit one block's shared memory — a dense X wider
// than ~27,000 columns, more than 64 classes, an exp-link GLM wider than
// ~4,800 features.
//
// Replaces (JAX): transmogrifai_tpu/models/solvers.py:_fista_loop's
// smooth_grad / smooth_val (:160-170, :189-215) with the dense xs_mv /
// xs_tmv closures (:270-286), vmapped over the (fold x grid) lanes by
// linear_grid_fit (:334-376), for the losses _logistic / _squared_hinge /
// _squared_loss_grad (:53-56), the power iteration's product
// (_spectral_norm_sq_weighted, :112-131), _softmax_loss_grad (:44-50) and
// _poisson_loss_grad / _gamma_loss_grad (:66-80).
//
// Computes, for J = L*C columns (lane l = j / C, fold f(l) = l / G)
// and rows n < N:
//   m[n, j] = (sum_d X[n,d] * V[j,d] - muv[j]) + b[j]
//   g[n, j] = the loss derivative at m weighted by W[f,n] / wsum[l] (the
//             softmax over a lane's C margins for the multinomial loss), and
//             for poisson / gamma the loss term lw[n, l] = W[f,n] * loss(m)
//   out[d*J + j] = sum_n X[n,d] g[n,j]  (grad; d < D), then
//   out[off + j] = sum_n g[n,j] (j < J) and, for poisson / gamma,
//   out[off + J + l] = sum_n lw[n,l], with off = D*J (grad) or 0.
//
// Design: three kernels and a reduction, each over the whole card.
//   margins: a block owns TRM rows, a chunk of 32 columns and a split of
//     the features (KS splits where the row tiles alone would not fill the
//     card: few rows, many features), walks its features in chunks of DCM
//     (X's chunk and V's in shared memory, V read from VT = V transposed
//     so that its chunk loads coalesced and stores without bank conflicts;
//     each thread a row and two groups of 4 columns, one read of x for
//     both, groups past the last column skipped) and writes its dot
//     products to mpart[z] [N, Jp] in device memory (mbuf itself when KS
//     = 1);
//   loss: a thread per (row, lane) adds the splits' dot products in split
//     order into the lane's margins, turns them into g in place in mbuf
//     (the softmax over its C classes: max, sum of exponentials, then each
//     class) and, for poisson / gamma, writes lw into columns J.. of mbuf;
//   X^T g: block (b, c, z) owns feature chunk c (DCX features; the last c
//     the ones column, i.e. the sums of g and lw) and column chunk z, and
//     strides over row tiles b, b+nb, ... with X's chunk and g's tile in
//     shared memory (a thread a group of 4 columns and four features, one
//     read of a row's g for all of them); each tile's
//     sums start from zero and join the block's sums by a compensated
//     (Kahan) add, so the error does not grow with the rows a block walks;
//     it writes its partial sums to partial[out, nb];
//   reduce: each output's nb partials summed in a fixed order (a fixed split
//     over threads, then a fixed tree).
// No atomics: the same inputs give the same bits on every run, so the
// solver's tolerance stop (n_iter) and backtracking do not wander.  X is
// read once per 32 columns in the margin pass and once in the X^T g pass,
// as float4 (four loads in flight a thread) where its rows are 16-byte
// aligned (D % 4 == 0); g makes one round trip through device memory.
//
// Bound: device-memory bytes for a wide X — X once (4 N D), the fold
// weights and y — at 1M x 1,596 with 24 lanes 6.4 GB, ~1.9 ms; or the f32
// operations, 4 N D J (two products), ~2.3 ms there at 67 TFLOP/s.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fista_loss.cuh"

#define WIDE_THREADS 256
#define TRM 64          // margin pass: rows a block
#define DCM 64          // margin pass: features a chunk
#define TRX 64          // X^T g pass: rows a tile
#define DCX 128         // X^T g pass: features a chunk
#define XTG_ITEMS 4     // X^T g pass: items a thread (DCX * 8 / 256)
#define COLS 32         // columns a block (8 groups of 4)

// rows x dc floats of X (row stride D, from column d0) into xs (row stride
// DCp).  With vec (D % 4 == 0 and X 16-byte aligned, so dc % 4 == 0) as
// float4 loads, several in flight a thread, stored as float4 where DCp %
// 4 == 0 (the X^T g pass; the margin pass's odd stride keeps its reads
// free of bank conflicts and stores the four floats one by one); else one
// float at a time.
__device__ __forceinline__ void load_x_chunk(const float* __restrict__ X,
                                             float* __restrict__ xs,
                                             long long r0, int rows, int D,
                                             int d0, int dc, int DCp,
                                             bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int c4n = dc >> 2;
#pragma unroll 4
    for (int e = tid; e < rows * c4n; e += WIDE_THREADS) {
      const int r = e / c4n, c = (e - r * c4n) << 2;
      const float4 v = *(const float4*)(X + (r0 + r) * D + d0 + c);
      float* dst = xs + r * DCp + c;
      if (DCp % 4 == 0) {
        *(float4*)dst = v;
      } else {
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    }
  } else {
    for (int e = tid; e < rows * dc; e += WIDE_THREADS) {
      const int r = e / dc, c = e - r * dc;
      xs[r * DCp + c] = X[(r0 + r) * D + d0 + c];
    }
  }
}

// block (row tile, column chunk, feature split z): the dot products of its
// rows and columns over features [z*Dk, (z+1)*Dk) into mpart[z] [N, Jp];
// VT is V transposed, [D, J], so a chunk of it loads coalesced and lands
// in shared memory without bank conflicts
__global__ void __launch_bounds__(WIDE_THREADS) wide_margin_kernel(
    const float* __restrict__ X, const float* __restrict__ VT,
    float* __restrict__ mpart, long long N, int D, int J, int Jp, int Dk,
    int vec) {
  __shared__ __align__(16) float xs[TRM * (DCM + 1)];
  __shared__ __align__(16) float vs[DCM * COLS];
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * TRM;
  const int rows = (int)min((long long)TRM, N - r0);
  const int c0 = blockIdx.y * COLS;
  const int cols = min(COLS, J - c0);
  const int k0 = blockIdx.z * Dk, k1 = min(D, k0 + Dk);
  float* out = mpart + (long long)blockIdx.z * N * Jp;
  float m[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  // this thread's items: row r, column groups q0 and q0 + 4 (a warp's
  // threads share q0, so the skips below are uniform across a warp)
  const int r = tid % TRM, q0 = tid / TRM;
  const bool a0 = r < rows && 4 * q0 < cols;
  const bool a1 = a0 && 4 * (q0 + 4) < cols;
  const float* xr = xs + r * (DCM + 1);
  for (int d0 = k0; d0 < k1; d0 += DCM) {
    const int dc = min(DCM, k1 - d0);
    load_x_chunk(X, xs, r0, rows, D, d0, dc, DCM + 1, vec);
    for (int e = tid; e < dc * COLS; e += WIDE_THREADS) {
      const int d = e / COLS, j = e - d * COLS;
      vs[e] = j < cols ? VT[(long long)(d0 + d) * J + c0 + j] : 0.f;
    }
    __syncthreads();
    // items (row r, groups q0 and q0 + 4): one read of x serves both
    if (a1) {
      for (int d = 0; d < dc; ++d) {
        const float x = xr[d];
        const float4 v = *(const float4*)(vs + d * COLS + 4 * q0);
        const float4 w = *(const float4*)(vs + d * COLS + 4 * q0 + 16);
        m[0][0] = fmaf(x, v.x, m[0][0]);
        m[0][1] = fmaf(x, v.y, m[0][1]);
        m[0][2] = fmaf(x, v.z, m[0][2]);
        m[0][3] = fmaf(x, v.w, m[0][3]);
        m[1][0] = fmaf(x, w.x, m[1][0]);
        m[1][1] = fmaf(x, w.y, m[1][1]);
        m[1][2] = fmaf(x, w.z, m[1][2]);
        m[1][3] = fmaf(x, w.w, m[1][3]);
      }
    } else if (a0) {
      for (int d = 0; d < dc; ++d) {
        const float x = xr[d];
        const float4 v = *(const float4*)(vs + d * COLS + 4 * q0);
        m[0][0] = fmaf(x, v.x, m[0][0]);
        m[0][1] = fmaf(x, v.y, m[0][1]);
        m[0][2] = fmaf(x, v.z, m[0][2]);
        m[0][3] = fmaf(x, v.w, m[0][3]);
      }
    }
    __syncthreads();
  }
  if (r >= rows) return;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = c0 + 4 * (q0 + 4 * k) + u;
      if (j < J) out[(r0 + r) * Jp + j] = m[k][u];
    }
  }
}

// a thread per (row, lane): the lane's margins (the KS feature splits'
// dot products added in split order, then - muv + b) into its g, in place
// in mbuf (= mpart[0] when KS == 1)
__global__ void __launch_bounds__(WIDE_THREADS) wide_loss_kernel(
    const float* mpart, float* mbuf, const float* __restrict__ muv,
    const float* __restrict__ b,
    const float* __restrict__ W, const void* __restrict__ y,
    const float* __restrict__ wsum, long long N, int L, int C, int J,
    int Jp, int KS, int G, int loss) {
  const long long items = N * L;
  for (long long it = (long long)blockIdx.x * WIDE_THREADS + threadIdx.x;
       it < items; it += (long long)gridDim.x * WIDE_THREADS) {
    const long long n = it / L;
    const int l = (int)(it - n * L);
    const float w = W[(long long)(l / G) * N + n];
    const float ws = wsum[l];
    float* m = mbuf + n * Jp + (long long)l * C;
    for (int c = 0; c < C; ++c) {
      const long long o = n * Jp + (long long)l * C + c;
      float dot = mpart[o];
      for (int z = 1; z < KS; ++z) dot += mpart[(long long)z * N * Jp + o];
      m[c] = (dot - muv[l * C + c]) + b[l * C + c];
    }
    if (loss == FL_SOFTMAX) {
      const int yc = ((const int32_t*)y)[n];
      float mx = -INFINITY;
      for (int c = 0; c < C; ++c) mx = fmaxf(mx, m[c]);
      float se = 0.f;
      for (int c = 0; c < C; ++c) se += expf(m[c] - mx);
      const float rs = __frcp_rn(se), wr = w / ws;
      for (int c = 0; c < C; ++c)
        m[c] = wr * (expf(m[c] - mx) * rs - (c == yc ? 1.f : 0.f));
      continue;
    }
    const float yn = loss == FL_GRAM ? 0.f : ((const float*)y)[n];
    const float rws = __frcp_rn(ws);
    if (loss == FL_POISSON || loss == FL_GAMMA) {
      float lw, g;
      fl_glm(loss == FL_POISSON, m[0], yn, w, rws, lw, g);
      m[0] = g;
      mbuf[n * Jp + J + l] = lw;
    } else {
      m[0] = fl_grad(loss, m[0], yn, w, rws);
    }
  }
}

// grid (nb, ND + 1, column chunks): feature chunks of DCX over the J
// gradient columns, then the ones column over all Jt columns
__global__ void __launch_bounds__(WIDE_THREADS) wide_xtg_kernel(
    const float* __restrict__ X, const float* __restrict__ mbuf,
    float* __restrict__ partial, long long N, int D, int J, int Jt, int Jp,
    int ND, long long ones_off, int vec) {
  __shared__ __align__(16) float xs[TRX * (DCX + 4)];
  __shared__ __align__(16) float gs[TRX * COLS];
  const int tid = threadIdx.x;
  const bool ones = blockIdx.y == ND;
  const int d0 = ones ? 0 : blockIdx.y * DCX;
  const int dc = ones ? 1 : min(DCX, D - d0);
  const int c0 = blockIdx.z * COLS;
  const int cols = min(COLS, (ones ? Jt : J) - c0);
  if (cols <= 0) return;
  const long long n_tiles = (N + TRX - 1) / TRX;
  const int nb = gridDim.x;
  // this thread's items: column group q and features dq + 32 k (k <
  // XTG_ITEMS); one read of a row's g serves all of them
  const int q = tid % (COLS / 4), dq = tid / (COLS / 4);
  const bool live = 4 * q < cols;
  float acc[XTG_ITEMS][4], cmp[XTG_ITEMS][4];
#pragma unroll
  for (int k = 0; k < XTG_ITEMS; ++k)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[k][u] = cmp[k][u] = 0.f;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += nb) {
    const long long r0 = tile * TRX;
    const int rows = (int)min((long long)TRX, N - r0);
    if (!ones) load_x_chunk(X, xs, r0, rows, D, d0, dc, DCX + 4, vec);
    for (int e = tid; e < rows * COLS; e += WIDE_THREADS) {
      const int r = e / COLS, j = e - r * COLS;
      gs[e] = j < cols ? mbuf[(r0 + r) * Jp + c0 + j] : 0.f;
    }
    __syncthreads();
    if (live && dq < dc) {
      float s[XTG_ITEMS][4];
#pragma unroll
      for (int k = 0; k < XTG_ITEMS; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[k][u] = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float4 g = *(const float4*)(gs + r * COLS + 4 * q);
        const float* xr = xs + r * (DCX + 4) + dq;
#pragma unroll
        for (int k = 0; k < XTG_ITEMS; ++k) {
          // past dc the chunk's stale floats are read, and never stored
          const float x = ones ? 1.f : xr[32 * k];
          s[k][0] = fmaf(x, g.x, s[k][0]);
          s[k][1] = fmaf(x, g.y, s[k][1]);
          s[k][2] = fmaf(x, g.z, s[k][2]);
          s[k][3] = fmaf(x, g.w, s[k][3]);
        }
      }
#pragma unroll
      for (int k = 0; k < XTG_ITEMS; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u) {     // acc += s, compensated
          const float v = s[k][u] - cmp[k][u];
          const float t = acc[k][u] + v;
          cmp[k][u] = (t - acc[k][u]) - v;
          acc[k][u] = t;
        }
    }
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < XTG_ITEMS; ++k) {
    const int d = dq + 32 * k;
    if (d >= dc) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * q + u;
      if (j >= cols) continue;
      const long long o = ones ? ones_off + c0 + j
                               : (long long)(d0 + d) * J + c0 + j;
      partial[o * nb + blockIdx.x] = acc[k][u];
    }
  }
}

// out[i] = sum over blocks of partial[i, :], in a fixed order
__global__ void wide_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int nb) {
  __shared__ float red[WIDE_THREADS];
  const long long i = blockIdx.x;
  const float* p = partial + i * nb;
  float s = 0.f;
  for (int j = threadIdx.x; j < nb; j += WIDE_THREADS) s += p[j];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = WIDE_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[i] = red[0];
}

// VT: the lanes' coefficients transposed, [D, J]; mbuf [N, Jp] and
// partial [n_out, nb] are the wrapper's scratch; out
// [n_out] with n_out = (grad ? D*J : 0) + Jt, Jt = J (+ L for poisson and
// gamma), Jp >= Jt a multiple of 4
extern "C" int fista_wide_launch(const void* X, const void* VT,
                                 const void* muv, const void* b,
                                 const void* W, const void* y,
                                 const void* wsum, void* mbuf, void* mpart,
                                 void* partial, void* out, long long N, int D,
                                 int L, int C, int G, int loss,
                                 int grad, int Jp, int KS, int Dk, int nb,
                                 int loss_blocks, void* stream) {
  const int glm = loss == FL_POISSON || loss == FL_GAMMA;
  const long long J = (long long)L * C;
  const long long Jt = J + (glm ? L : 0);
  if (N < 1 || D < 1 || L < 1 || C < 1 || loss < 0 || loss > FL_GAMMA ||
      (loss == FL_SOFTMAX) != (C > 1) || Jp < Jt || Jp % 4 || nb < 1 ||
      nb > 65535 || loss_blocks < 1 || (!grad && !glm) || J > 0x7fffffff ||
      KS < 1 || KS > 65535 || Dk < 1 || (long long)KS * Dk < D ||
      (KS > 1 && mpart == nullptr) ||
      (grad && (long long)D * J + Jt > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned col_chunks = (unsigned)((J + COLS - 1) / COLS);
  float* mp = KS > 1 ? (float*)mpart : (float*)mbuf;
  const int vec = D % 4 == 0 && Dk % 4 == 0 && (uintptr_t)X % 16 == 0;
  wide_margin_kernel<<<dim3((unsigned)((N + TRM - 1) / TRM), col_chunks, KS),
                       WIDE_THREADS, 0, s>>>(
      (const float*)X, (const float*)VT, mp, N, D, (int)J, Jp, Dk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wide_loss_kernel<<<loss_blocks, WIDE_THREADS, 0, s>>>(
      mp, (float*)mbuf, (const float*)muv, (const float*)b, (const float*)W,
      y, (const float*)wsum, N, L, C, (int)J, Jp, KS, G, loss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ND = grad ? (D + DCX - 1) / DCX : 0;
  const long long ones_off = grad ? (long long)D * J : 0;
  wide_xtg_kernel<<<dim3(nb, ND + 1, (unsigned)((Jt + COLS - 1) / COLS)),
                    WIDE_THREADS, 0, s>>>(
      (const float*)X, (const float*)mbuf, (float*)partial, N, D, (int)J,
      (int)Jt, Jp, ND, ones_off, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wide_reduce_kernel<<<(unsigned)(ones_off + Jt), WIDE_THREADS, 0, s>>>(
      (const float*)partial, (float*)out, nb);
  return (int)cudaGetLastError();
}
