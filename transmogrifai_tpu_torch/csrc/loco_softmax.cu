// loco_softmax — leave-one-covariate-out explanations of a model whose score
// is the softmax probability of its last class over a first layer that is
// linear in the features (multinomial logistic regression, naive Bayes, the
// multilayer perceptron), with each row's top-K groups.
//
// Replaces (JAX): transmogrifai_tpu/record_insights.py:_device_topk's `loco`
// program (:140-160) on those models, whose score is probability[:, -1]
// (:82-112): the base forward, a lax.map of G masked forwards
// score(X * m_g) over the [G, D] group masks, the [N, G] diffs and
// lax.top_k.  The TPU form re-reads X once per group so that [G, N, D] is
// never formed in HBM.
//
// The first layer is a = phi(x) . W1 + b1 (H wide): phi the identity and
// W1 = coef [D, C] for logistic regression; phi = max(x, 0), W1 = log_prob^T
// and b1 = log_prior for naive Bayes (masks are 0/1, so masking commutes with
// phi); phi the identity and W1 the first weight matrix for the MLP, whose
// tail (ReLU, then each further layer, ReLU between them) turns a into the C
// logits.  Zeroing group g's columns removes exactly
//   P_g = sum_{j in g} phi(x_j) W1[j, :]
// from a's dot product, so each row needs one read of its columns:
//   score_g = softmax(tail((dot - P_g) + b1))[C-1],
//   diff_g = softmax(tail(dot + b1))[C-1] - score_g,
// the softmax taken after subtracting the largest logit.  The kernel never
// forms X * m_g.
//
// Two forms; insights_kernels.loco_softmax_plan picks one and sizes it.
//
// The row form (every layer at most 16 wide, where the block's state fits
// shared memory): a row a thread, up to 128 rows a block, as loco_tree.cu
// takes its rows.  The block's rows of X are staged once, coalesced, at an
// odd stride; W1, b1 and the tail's weights are staged and read by
// broadcast; the row's dot product, each group's activations and the tail's
// layers live in registers (HM = 4, 8 or 16 wide, a template parameter); the
// thread keeps its row's top-K in a list of its own (loco_push) in an
// interleaved slab, and the block writes its rows' lists out coalesced, the
// indices already in the wrapper's index type (int16 up to 0x7FFF groups).
// The sums keep the warp form's order exactly — the base as 32 lane partials
// (columns j = l, l + 32, ... a fused chain each) added in lane order, a
// group's columns in perm order, the tail and the softmax as tail_prob takes
// them — and the list keeps the warp's insertion rule, so both forms give
// the same bits.
//
// The warp form (wider or deeper models): one warp per row (grid-stride over
// rows).  Each lane of the warp owns a slot of shared memory: SA floats for
// the activations of the first layer and of every second tail layer, and,
// with a tail, SB more for the layers between (ping-pong buffers; the plan
// sizes both from the model's widths).  The base: lane i sums
// phi(x_j) W1[j, :] over the columns j = i, i + 32, ... into its slot, and
// lane k then adds the 32 slots' entry k in lane order (dot[k]).  The
// groups: lane i takes group g0 + i of each 32 (columns sorted by group,
// `perm`, group g at perm[goff[g] .. goff[g+1]); null when the groups are
// already contiguous), sums its columns into its slot, forms (dot - P_g) +
// b1, runs the tail and the softmax on its own slot, and offers its diff to
// the warp's top-K (loco_topk.cuh).  Every sum runs in a fixed order: the
// same bits on every launch.  The tail's weights are staged in shared
// memory where they fit beside the warps' slots (tw_smem), else read from
// device memory through the cache (a wide or deep MLP: 256 x 256 alone is
// 256 KB); W1 is read through the cache.  Per-lane state lives in shared
// memory, not registers, so a wide C or H costs no spills.  Where one
// warp's slots do not fit shared memory (a layer of ~1,800 units or more,
// or as many classes), they live in a device-memory scratch that the
// wrapper allocates, one region a warp in flight, each element k of the 32
// lanes' slots side by side (element k of lane l at 32 k + l), so the warp's
// accesses to one element coalesce; the arithmetic and its order are those
// of the shared-memory form.
//
// Bound: device-memory bytes — X read once (4 N D) and the [N, K] output
// written once (8 N K with int32 indices, 6 N K with int16) — or the
// operations, ~2 N (D H + G (H + tail) + tail) plus a softmax a group; at
// 1M x 16 with G = 16, C = 4 the bytes (~64 + 128 MB, ~57 us).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "loco_topk.cuh"

// the tail (ReLU, then each layer; ReLU between layers) of a lane's first
// layer activations a[0..H), then the softmax's last class; `b` is the
// lane's second buffer (a tail of one layer or more), dims[0..n_tail] the
// widths from H to C, tw each layer's W [in][out] then b [out] (shared or
// device memory); ES the stride of a slot's elements (1 in shared memory,
// 32 in the lane-interleaved scratch)
template <int ES>
__device__ __forceinline__ float tail_prob(float* a, float* b,
                                           const float* tw,
                                           const int32_t* dims, int n_tail,
                                           int H, int C) {
  float* in = a;
  float* out = b;
  int din = H;
  for (int i = 0; i < n_tail; ++i) {
    const int dout = __ldg(dims + i + 1);
    for (int k = 0; k < din; ++k) in[k * ES] = fmaxf(in[k * ES], 0.f);
    for (int c = 0; c < dout; ++c) {
      float s = 0.f;
      for (int k = 0; k < din; ++k)
        s = fmaf(in[k * ES], tw[k * dout + c], s);
      out[c * ES] = s + tw[din * dout + c];
    }
    tw += din * dout + dout;
    float* t = in;
    in = out;
    out = t;
    din = dout;
  }
  float mx = in[0];
  for (int c = 1; c < C; ++c) mx = fmaxf(mx, in[c * ES]);
  float sum = 0.f;
  for (int c = 0; c < C; ++c) sum += expf(in[c * ES] - mx);
  return expf(in[(C - 1) * ES] - mx) / sum;
}

// ---- the row form: a row a thread, its state in registers ----

// relu(in) . W + b for one tail layer (W [din][dout] then b [dout] at tw),
// each output a fused multiply-add chain over k from 0, as tail_prob sums
template <int HM>
__device__ __forceinline__ void row_layer(const float (&in)[HM],
                                          float (&out)[HM], const float* tw,
                                          int din, int dout) {
  float r[HM];
#pragma unroll
  for (int k = 0; k < HM; ++k) r[k] = fmaxf(in[k], 0.f);
#pragma unroll
  for (int c = 0; c < HM; ++c) {
    if (c < dout) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < HM; ++k)
        if (k < din) s = fmaf(r[k], tw[k * dout + c], s);
      out[c] = s + tw[din * dout + c];
    }
  }
}

// the softmax's last class of the C logits in a, as tail_prob takes it
template <int HM>
__device__ __forceinline__ float row_softmax_last(const float (&a)[HM],
                                                  int C) {
  float mx = a[0], last = a[0];
#pragma unroll
  for (int c = 1; c < HM; ++c) {
    if (c < C) mx = fmaxf(mx, a[c]);
    if (c == C - 1) last = a[c];
  }
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < HM; ++c)
    if (c < C) sum += expf(a[c] - mx);
  return expf(last - mx) / sum;
}

// the tail of the first layer's activations a (a, then b, then a ... hold
// the layers; a is overwritten), then the softmax's last class
template <int HM>
__device__ __forceinline__ float row_prob(float (&a)[HM], const float* tw,
                                          const int32_t* dims, int n_tail,
                                          int H, int C) {
  float b[HM];
#pragma unroll
  for (int k = 0; k < HM; ++k) b[k] = 0.f;
  int din = H;
  for (int i = 0; i < n_tail; i += 2) {
    const int d1 = __ldg(dims + i + 1);
    row_layer<HM>(a, b, tw, din, d1);
    tw += din * d1 + d1;
    din = d1;
    if (i + 1 < n_tail) {
      const int d2 = __ldg(dims + i + 2);
      row_layer<HM>(b, a, tw, din, d2);
      tw += din * d2 + d2;
      din = d2;
    }
  }
  return (n_tail & 1) ? row_softmax_last<HM>(b, C)
                      : row_softmax_last<HM>(a, C);
}

// HM: the widest layer, rounded up (4, 8 or 16); one row a thread, R =
// blockDim.x rows a block.  Shared memory: W1 [D][H], b1 [H], the tail's
// weights [TW], the block's rows of X [R][Dp] (Dp odd), then the rows' top-K
// lists [K][R + 1] of values and of group indices (thread r's entry i at
// i (R + 1) + r).  Every sum runs in the warp form's order (the base's 32
// lane partials, each a fused chain over columns j = l, l + 32, ..., added
// in lane order; a group's columns in perm order), so the diffs are its
// bits; the list keeps its insertion rule, so the indices are too.
template <int HM>
__global__ void __launch_bounds__(128) loco_softmax_rows_kernel(
    const float* __restrict__ X, const float* __restrict__ W1,
    const float* __restrict__ b1, const float* __restrict__ tw_g,
    const int32_t* __restrict__ dims, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ goff, float* __restrict__ out_val,
    void* __restrict__ out_idx, long long N, int D, int G, int K,
    int strategy, int H, int C, int n_tail, int relu_in, int TW, int Dp,
    int idx16) {
  extern __shared__ float sm[];
  const int R = blockDim.x, RS = R + 1, t = threadIdx.x;
  float* w1 = sm;                               // [D][H]
  float* bs = w1 + D * H;                       // [H]
  float* tw = bs + H;                           // [TW]
  float* xs = tw + TW;                          // [R][Dp]
  float* lv = xs + R * Dp;                      // [K][RS]
  int32_t* li = (int32_t*)(lv + K * RS);        // [K][RS]
  const long long n0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, N - n0);
  if (rows <= 0) return;
  for (int i = t; i < D * H; i += R) w1[i] = __ldg(W1 + i);
  for (int i = t; i < H; i += R) bs[i] = __ldg(b1 + i);
  for (int i = t; i < TW; i += R) tw[i] = __ldg(tw_g + i);
  const float* xb = X + n0 * D;
  for (int i = t; i < rows * D; i += R) {
    const int r = i / D;
    xs[r * Dp + (i - r * D)] = __ldg(xb + i);
  }
  __syncthreads();

  if (t < rows) {
    const float* xr = xs + t * Dp;
    float dot[HM];
#pragma unroll
    for (int k = 0; k < HM; ++k) dot[k] = 0.f;
    for (int l = 0; l < 32 && l < D; ++l) {     // the base's lane partials
      float p[HM];
#pragma unroll
      for (int k = 0; k < HM; ++k) p[k] = 0.f;
      for (int j = l; j < D; j += 32) {
        const float v = relu_in ? fmaxf(xr[j], 0.f) : xr[j];
        const float* w = w1 + j * H;
#pragma unroll
        for (int k = 0; k < HM; ++k)
          if (k < H) p[k] = fmaf(v, w[k], p[k]);
      }
#pragma unroll
      for (int k = 0; k < HM; ++k) dot[k] += p[k];
    }
    float a[HM];
#pragma unroll
    for (int k = 0; k < HM; ++k) a[k] = k < H ? dot[k] + bs[k] : 0.f;
    const float base = row_prob<HM>(a, tw, dims, n_tail, H, C);

    int cnt = 0;
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < HM; ++k) a[k] = 0.f;
      const int c1 = __ldg(goff + g + 1);
      for (int c = __ldg(goff + g); c < c1; ++c) {
        const int col = perm ? __ldg(perm + c) : c;
        const float v = relu_in ? fmaxf(xr[col], 0.f) : xr[col];
        const float* w = w1 + col * H;
#pragma unroll
        for (int k = 0; k < HM; ++k)
          if (k < H) a[k] = fmaf(v, w[k], a[k]);
      }
#pragma unroll
      for (int k = 0; k < HM; ++k)
        if (k < H) a[k] = (dot[k] - a[k]) + bs[k];
      const float d = base - row_prob<HM>(a, tw, dims, n_tail, H, C);
      loco_push(lv + t, li + t, K, cnt, strategy, g, d, RS);
    }
  }
  __syncthreads();
  // the block's lists, written out coalesced (rows n0 .. n0 + rows)
  for (int e = t; e < rows * K; e += R) {
    const int r = e / K, i = e - r * K;
    out_val[n0 * K + e] = lv[i * RS + r];
    if (idx16)
      ((int16_t*)out_idx)[n0 * K + e] = (int16_t)li[i * RS + r];
    else
      ((int32_t*)out_idx)[n0 * K + e] = li[i * RS + r];
  }
}

// GS: the warps' slots in the device-memory scratch (one region of
// 32 SP + H floats a warp in flight), else in shared memory
template <bool GS>
__global__ void loco_softmax_kernel(const float* __restrict__ X,
                                    const float* __restrict__ W1,
                                    const float* __restrict__ b1,
                                    const float* __restrict__ tw_g,
                                    const int32_t* __restrict__ dims,
                                    const int32_t* __restrict__ perm,
                                    const int32_t* __restrict__ goff,
                                    float* __restrict__ out_val,
                                    int32_t* __restrict__ out_idx,
                                    float* __restrict__ scratch,
                                    long long N, int D, int G, int K,
                                    int strategy, int H, int C, int n_tail,
                                    int relu_in, int SA, int SB, int TW,
                                    int tw_smem) {
  extern __shared__ float sm[];
  constexpr int ES = GS ? 32 : 1;                    // a slot's element stride
  const int staged = tw_smem ? TW : 0;               // tail weights in sm
  const float* tw = tw_smem ? sm : tw_g;
  const int SP = (SA + SB) | 1;                      // a lane's slot stride
  const int LS = GS ? 1 : SP;                        // a lane's slot offset
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* region = GS ? scratch + ((long long)blockIdx.x * (blockDim.x >> 5)
                                  + warp) * (32 * SP + H)
                     : sm + staged + warp * (32 * SP + H);
  float* slot = region + lane * LS;                  // this lane's slot
  float* dot = region + 32 * SP;                     // [H] the warp's dot
  for (int i = threadIdx.x; i < staged; i += blockDim.x) sm[i] = tw_g[i];
  __syncthreads();

  const long long first = ((long long)blockIdx.x * blockDim.x
                           + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long n = first; n < N; n += n_warps) {
    const float* x = X + n * D;
    // the base: lane partials of phi(x) . W1 over columns lane, lane + 32
    for (int k = 0; k < H; ++k) slot[k * ES] = 0.f;
    for (int j = lane; j < D; j += 32) {
      const float v = relu_in ? fmaxf(x[j], 0.f) : x[j];
      const float* w = W1 + (long long)j * H;
      for (int k = 0; k < H; ++k)
        slot[k * ES] = fmaf(v, __ldg(w + k), slot[k * ES]);
    }
    __syncwarp();
    for (int k = lane; k < H; k += 32) {
      float s = 0.f;
      for (int l = 0; l < 32; ++l) s += region[l * LS + k * ES];
      dot[k] = s;
    }
    __syncwarp();
    for (int k = 0; k < H; ++k) slot[k * ES] = dot[k] + __ldg(b1 + k);
    const float base = tail_prob<ES>(slot, slot + SA * ES, tw, dims, n_tail,
                                     H, C);

    WarpTopK t = loco_topk_init(K, strategy, out_val + n * K,
                                out_idx + n * K);
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      const bool valid = g < G;
      float d = 0.f;
      if (valid) {
        for (int k = 0; k < H; ++k) slot[k * ES] = 0.f;
        const int c1 = goff[g + 1];
        for (int c = goff[g]; c < c1; ++c) {
          const int col = perm ? perm[c] : c;
          const float v = relu_in ? fmaxf(x[col], 0.f) : x[col];
          const float* w = W1 + (long long)col * H;
          for (int k = 0; k < H; ++k)
            slot[k * ES] = fmaf(v, __ldg(w + k), slot[k * ES]);
        }
        for (int k = 0; k < H; ++k)
          slot[k * ES] = (dot[k] - slot[k * ES]) + __ldg(b1 + k);
        d = base - tail_prob<ES>(slot, slot + SA * ES, tw, dims, n_tail, H,
                                 C);
      }
      loco_topk_offer(t, valid, g, d);
    }
    loco_topk_write(t);
    __syncwarp();
  }
}

// form 0 (warps): scratch null (the slots in shared memory) or the
// wrapper's f32 [blocks x threads/32 x (32 ((SA + SB) | 1) + H)]
// device-memory slots; out_idx int32.  form 1 (rows): `threads` rows a
// block (32 to 128), every layer at most hm (4, 8 or 16) wide, the tail's
// weights staged, X's rows at stride Dp (odd, >= D), out_idx int16 where
// idx16 else int32; smem 4 (D H + H + TW + threads Dp + 2 K (threads + 1)).
extern "C" int loco_softmax_launch(const void* X, const void* W1,
                                   const void* b1, const void* tw,
                                   const void* dims, const void* perm,
                                   const void* goff, void* out_val,
                                   void* out_idx, void* scratch, long long N,
                                   int D, int G, int K, int strategy, int H,
                                   int C, int n_tail, int relu_in, int SA,
                                   int SB, int TW, int tw_smem, int blocks,
                                   int threads, int smem, int form, int Dp,
                                   int idx16, int hm, void* stream) {
  if (K < 1 || K > G || D < 1 || H < 1 || C < 2 || n_tail < 0 ||
      (n_tail == 0 && H != C) || strategy < 0 || strategy > 2 ||
      blocks < 1 || TW < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (form == 1) {
    const long long want =
        4LL * ((long long)D * H + H + TW + (long long)threads * Dp +
               2LL * K * (threads + 1));
    if (threads < 32 || threads > 128 || threads % 32 || Dp < D ||
        !(Dp & 1) || H > hm || C > hm || smem != want ||
        smem > 227 * 1024 || (hm != 4 && hm != 8 && hm != 16) ||
        (long long)blocks * threads < N)
      return (int)cudaErrorInvalidValue;
    decltype(&loco_softmax_rows_kernel<4>) kern =
        hm == 4 ? &loco_softmax_rows_kernel<4>
                : (hm == 8 ? &loco_softmax_rows_kernel<8>
                           : &loco_softmax_rows_kernel<16>);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<blocks, threads, smem, s>>>(
        (const float*)X, (const float*)W1, (const float*)b1,
        (const float*)tw, (const int32_t*)dims, (const int32_t*)perm,
        (const int32_t*)goff, (float*)out_val, out_idx, N, D, G, K,
        strategy, H, C, n_tail, relu_in, TW, Dp, idx16);
    return (int)cudaGetLastError();
  }
  if (form != 0 || SA < H || (n_tail == 0 ? SB != 0 : SB < 1) ||
      threads % 32 || threads < 32)
    return (int)cudaErrorInvalidValue;
  decltype(&loco_softmax_kernel<true>) kern =
      scratch ? &loco_softmax_kernel<true> : &loco_softmax_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<blocks, threads, smem, s>>>(
      (const float*)X, (const float*)W1, (const float*)b1, (const float*)tw,
      (const int32_t*)dims, (const int32_t*)perm, (const int32_t*)goff,
      (float*)out_val, (int32_t*)out_idx, (float*)scratch, N, D, G, K,
      strategy, H, C, n_tail, relu_in, SA, SB, TW, tw_smem);
  return (int)cudaGetLastError();
}
