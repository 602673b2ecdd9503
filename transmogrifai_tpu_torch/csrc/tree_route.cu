// tree_route — move each row of each lane to its child after a level split,
// in place.
//
// Replaces (JAX): transmogrifai_tpu/models/trees.py:_fit_tree_compact's
// routing block (:373-391): the one-hot contractions oh @ best_feat,
// oh @ best_bin, oh @ node_is_leaf, the take_along_axis of the split
// feature's bin, and child = 2*node + 1 + go_right.  The TPU form avoids
// gathers; on Hopper the per-row gather of B[n, feat] is a load from a row
// tile staged in shared memory.
//
// Design: two kernels in one call.  The first packs each node's split
// into one int32 code, -1 at a leaf, else feature << 8 | (bin + 1) with the
// bin clamped to [-1, 127] (B's bins lie in [0, 127], so the comparison is
// unchanged): a row then reads one 4-byte code, not three arrays.  The
// second runs a 2-D grid, row tiles on x (``threads`` x RPT rows a block)
// and chunks of ``kc`` lanes on y.  With STAGE a block first copies its
// tile's rows of B [N, D] (contiguous, tile x D bytes) into shared memory
// with 16-byte loads, then routes every lane of its chunk from there:
// thread t takes rows t, t + threads, ... of the tile, so each lane's node
// ids are read (and the moved ones written) 128 bytes a warp instruction,
// past L1 (ld.global.cg: the ids pass once and leave L1 to the codes),
// and the next two lanes' ids are loaded before the current lane's are
// routed.
// B thus leaves device memory once a lane chunk, not once a lane; tiles
// are kept small (``route_plan``: 16 KB) so that L1 holds the resident
// blocks' lanes' codes (8 KB a lane at 2,048 nodes).  A row moves only when
// its node sits at this level (node - offset in [0, P)) and did not become
// a leaf, and only a moved row's id is written: rows below a leaf or off
// the level are read and left as they are.  Where a tile of rows of B does
// not fit the budget (wide D), the block gathers the one byte each row
// needs from device memory instead (no STAGE).
//
// Bound: device-memory bytes — 4 bytes of node id read per (lane, row),
// 4 written per moved row, and B's bytes once (28 MB at 1M x 28).
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void tree_route_pack_kernel(const int32_t* __restrict__ feat,
                                       const int32_t* __restrict__ bin,
                                       const uint8_t* __restrict__ leaf,
                                       int32_t* __restrict__ code,
                                       long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    code[i] = leaf[i] ? -1
                      : (feat[i] << 8) | (min(max(bin[i], -1), 127) + 1);
}

template <int RPT, bool STAGE>
__global__ void __launch_bounds__(256) tree_route_kernel(
    const int8_t* __restrict__ B, int32_t* __restrict__ row_node,
    const int32_t* __restrict__ code, int N, int D, int K, int offset, int P,
    int kc) {
  extern __shared__ int4 tile4[];  // [rows, D] bytes of B (STAGE)
  const int8_t* tile = (const int8_t*)tile4;
  const int T = blockDim.x;
  const int n0 = blockIdx.x * (T * RPT);
  const int nr = min(T * RPT, N - n0);
  const int k0 = blockIdx.y * kc, k1 = min(K, k0 + kc);
  if (STAGE) {
    int8_t* dst = (int8_t*)tile4;
    const int8_t* src = B + (long long)n0 * D;
    const int bytes = nr * D;
    int done = 0;
    if ((((uintptr_t)src) & 15) == 0) {
      const int4* s4 = (const int4*)src;
      for (int i = threadIdx.x; i < bytes / 16; i += T)
        tile4[i] = __ldg(s4 + i);
      done = bytes / 16 * 16;
    }
    for (int i = done + threadIdx.x; i < bytes; i += T) dst[i] = __ldg(src + i);
    __syncthreads();
  }
  // lanes k + 1 and k + 2's ids are in flight while lane k is routed
  int cur[RPT], nx1[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = threadIdx.x + j * T;
    const int32_t* rn = row_node + (long long)k0 * N + n0 + r;
    cur[j] = r < nr ? __ldcg(rn) : -1;
    nx1[j] = r < nr && k0 + 1 < k1 ? __ldcg(rn + N) : -1;
  }
  for (int k = k0; k < k1; ++k) {
    int nx2[RPT];
    int32_t* rn = row_node + (long long)k * N + n0;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = threadIdx.x + j * T;
      nx2[j] = (k + 2 < k1 && r < nr) ? __ldcg(rn + 2LL * N + r) : -1;
    }
    const int32_t* ck = code + (long long)k * P;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int node = cur[j];
      const unsigned p = (unsigned)(node - offset);
      if (p < (unsigned)P) {
        const int cd = __ldg(ck + p);
        if (cd >= 0) {
          const int r = threadIdx.x + j * T;
          const int f = cd >> 8;
          const int b = STAGE ? tile[r * D + f]
                              : __ldg(B + (long long)(n0 + r) * D + f);
          rn[r] = 2 * node + 1 + (b > (cd & 255) - 1 ? 1 : 0);
        }
      }
      cur[j] = nx1[j];
      nx1[j] = nx2[j];
    }
  }
}

// Routes rows [0, N) of lanes [0, K) in place; returns a cudaError_t.
// ``code``: [K, P] int32 scratch for the packed splits.  rpt (rows a
// thread) is 1, 2 or 4; stage 1 stages row tiles of B in smem (``smem``
// bytes: threads * rpt * D); kc lanes a block.
extern "C" int tree_route_launch(const void* B, void* row_node,
                                 const void* feat, const void* bin,
                                 const void* leaf, void* code, long long N,
                                 int D, int K, int offset, int P, int threads,
                                 int rpt, int stage, int kc, int smem,
                                 void* stream) {
  if (N < 1 || N >= (1LL << 31) || D < 1 || D >= (1 << 23) || K < 1 ||
      P < 1 || kc < 1 || threads < 32 || threads > 256 || threads % 32 ||
      (rpt != 1 && rpt != 2 && rpt != 4) || smem > 48 * 1024 ||
      (stage && (long long)threads * rpt * D > smem))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)threads * rpt;
  const long long ny = (K + kc - 1) / kc;
  if (ny > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)K * P;
  tree_route_pack_kernel<<<(unsigned)min((n + 255) / 256, 132LL * 8), 256, 0,
                           s>>>((const int32_t*)feat, (const int32_t*)bin,
                                (const uint8_t*)leaf, (int32_t*)code, n);
  dim3 grid((unsigned)((N + rows - 1) / rows), (unsigned)ny);
  const size_t sm = stage ? (size_t)smem : 0;
#define ROUTE_ARGS                                                        \
  (const int8_t*)B, (int32_t*)row_node, (const int32_t*)code, (int)N, D, \
      K, offset, P, kc
#define ROUTE(R)                                                          \
  (stage ? tree_route_kernel<R, true><<<grid, threads, sm, s>>>(ROUTE_ARGS) \
         : tree_route_kernel<R, false><<<grid, threads, sm, s>>>(ROUTE_ARGS))
  switch (rpt) {
    case 1: ROUTE(1); break;
    case 2: ROUTE(2); break;
    default: ROUTE(4);
  }
#undef ROUTE
#undef ROUTE_ARGS
  return (int)cudaGetLastError();
}
