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
// Design: one warp per row (grid-stride over rows).  Each lane of the warp
// owns a slot of shared memory: SA floats for the activations of the first
// layer and of every second tail layer, and, with a tail, SB more for the
// layers between (ping-pong buffers; the plan sizes both from the model's
// widths).  The base: lane i sums
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
// written once (8 N K) — or the operations, ~2 N (D H + G (H + tail) +
// tail) plus a softmax a group; at 1M x 16 with G = 16, C = 4 the bytes
// (~64 + 128 MB, ~57 us).
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

// scratch: null (the slots in shared memory) or the wrapper's f32 [blocks
// x threads/32 x (32 ((SA + SB) | 1) + H)] device-memory slots
extern "C" int loco_softmax_launch(const void* X, const void* W1,
                                   const void* b1, const void* tw,
                                   const void* dims, const void* perm,
                                   const void* goff, void* out_val,
                                   void* out_idx, void* scratch, long long N,
                                   int D, int G, int K, int strategy, int H,
                                   int C, int n_tail, int relu_in, int SA,
                                   int SB, int TW, int tw_smem, int blocks,
                                   int threads, int smem, void* stream) {
  if (K < 1 || K > G || D < 1 || H < 1 || C < 2 || SA < H ||
      (n_tail == 0 ? SB != 0 : SB < 1) || n_tail < 0 ||
      (n_tail == 0 && H != C) || threads % 32 || threads < 32 ||
      strategy < 0 || strategy > 2 || blocks < 1 || TW < 0)
    return (int)cudaErrorInvalidValue;
  decltype(&loco_softmax_kernel<true>) kern =
      scratch ? &loco_softmax_kernel<true> : &loco_softmax_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)W1, (const float*)b1, (const float*)tw,
      (const int32_t*)dims, (const int32_t*)perm, (const int32_t*)goff,
      (float*)out_val, (int32_t*)out_idx, (float*)scratch, N, D, G, K,
      strategy, H, C, n_tail, relu_in, SA, SB, TW, tw_smem);
  return (int)cudaGetLastError();
}
