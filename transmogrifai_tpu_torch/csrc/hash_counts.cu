// hash_counts — the hashing trick's count matrix: scatter-add each row's
// hashed token ids into its row of an [N, H] f32 block, with the row's null
// indicator as column H, written at a column offset of a wider matrix.
//
// Replaces (JAX): transmogrifai_tpu/ops/text.py:_scatter_counts_packed
// (:148-160) and _scatter_counts_device (:135-146), and the staged body's
// scatter (:470-484): XLA builds a padded [N+1, H+1] zero matrix, repeats
// the row ids over the flat id stream, scatter-adds ones, slices off the
// sentinel row and bin, and concatenates the null column — several passes
// over the 2 GB block.
//
// Inputs: ids — below 1,024 hashes the packed wire (three 10-bit ids per
// int32 word, token order kept, the last word padded with the sentinel bin
// H), else plain int32 ids; off int64 [N+1] — row n's tokens are
// positions off[n] .. off[n+1]-1 of the id stream (an exclusive prefix sum
// of the per-row counts); null uint8 [N] or NULL (no indicator column).
// Output: out[n, col0 + c] for c < H (+1), every cell written, zeros
// included, so the caller allocates without a fill.  Ids >= H (the
// sentinel) are dropped; positions at or past off[N] are never read.
//
// Design: a block owns a tile of R rows and builds their counts in shared
// memory (R x H f32; R = 32 at H = 512, 64 KB): a warp per row walks the
// row's ~10 tokens and adds with shared-memory atomics; then the block
// writes the tile row by row, consecutive threads on consecutive columns.
// Counts are small integers (exact in f32 below 2^24), so the order of the
// atomics cannot change a bit of the result.
//
// Past what one row's counts take in shared memory (58,112 hashes:
// ops/text_kernels.py:hash_plan), the H columns go in windows of WH: a
// second grid dimension takes window w, each block counts only the ids in
// [w*WH, w*WH + WH) (its rows' tokens read once a window) and writes those
// columns; the last window also writes the null column beside it.  (Counts
// added with device-memory atomics into zeroed rows measured 2.1-2.4x
// slower at 60,000 and 100,003 hashes on an H100.)
//
// Bound: bytes.  The output write (4 * N * (H+1): 2.05 GB at 1M x 513)
// dominates the id stream (4 bytes per 3 tokens), the offsets (8 * N) and
// the null bytes; ~0.62 ms at 3.35 TB/s.  Operations are one atomic add
// per token.
#include <cuda_runtime.h>
#include <stdint.h>

// the token at stream position t: packed (three 10-bit ids a word) or not
__device__ __forceinline__ int hash_id(const int32_t* __restrict__ ids,
                                       long long t, int packed) {
  if (!packed) return ids[t];
  const int w = ids[t / 3];
  return (w >> (10 * (int)(t % 3))) & 0x3FF;
}

// R rows x WH columns of window blockIdx.y (WH = H: one window, the whole
// row)
__global__ void hash_counts_kernel(const int32_t* __restrict__ ids,
                                   const long long* __restrict__ off,
                                   const uint8_t* __restrict__ null,
                                   float* __restrict__ out, long long N,
                                   int H, long long ld, long long col0,
                                   int packed, int R, int WH) {
  extern __shared__ float cnt[];          // [R][wn]
  const long long r0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, N - r0);
  const int w0 = blockIdx.y * WH, wn = min(WH, H - w0);
  const int tid = threadIdx.x, bs = blockDim.x;
  for (int i = tid; i < R * wn; i += bs) cnt[i] = 0.f;
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, n_warps = bs >> 5;
  for (int r = warp; r < rows; r += n_warps) {
    const long long a = off[r0 + r], b = off[r0 + r + 1];
    for (long long t = a + lane; t < b; t += 32) {
      const int id = hash_id(ids, t, packed) - w0;
      if (id >= 0 && id < wn) atomicAdd(&cnt[r * wn + id], 1.f);
    }
  }
  __syncthreads();

  // the last window writes the null column after its own
  const int W = wn + (null != nullptr && w0 + wn == H ? 1 : 0);
  for (int r = 0; r < rows; ++r) {
    float* dst = out + (r0 + r) * ld + col0 + w0;
    const float* src = cnt + r * wn;
    for (int c = tid; c < W; c += bs) {
      dst[c] = c < wn ? src[c] : (null[r0 + r] ? 1.f : 0.f);
    }
  }
}

// R rows x WH columns a tile (WH = H: one window, the launch up to 58,112
// hashes; past that ops/text_kernels.py:hash_plan's windows)
extern "C" int hash_counts_launch(const void* ids, const void* off,
                                  const void* null, void* out, long long N,
                                  int H, long long ld, long long col0,
                                  int packed, int R, int WH, void* stream) {
  if (N < 1) return 0;
  if (H < 1 || R < 1 || (packed && H > 1023) || WH < 1 || WH > H)
    return (int)cudaErrorInvalidValue;
  const long long grid = (N + R - 1) / R;
  const size_t smem = sizeof(float) * (size_t)R * (size_t)WH;
  cudaError_t err = cudaFuncSetAttribute(
      hash_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 g((unsigned)grid, (unsigned)((H + WH - 1) / WH));
  hash_counts_kernel<<<g, 256, smem, (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const long long*)off, (const uint8_t*)null,
      (float*)out, N, H, ld, col0, packed, R, WH);
  return (int)cudaGetLastError();
}
