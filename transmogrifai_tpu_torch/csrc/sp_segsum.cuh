// sp_segsum.cuh — the shared body of sp_matmat.cu and sp_rmatmat.cu: a
// segmented gather-sum over a segment-sorted flat sparse entry stream,
//
//     out[s, :] = sum over entries e of segment s of  val[e] * dense[gix[e], :]
//
// with k <= 32 columns.  For X @ M the segments are X's rows (the row-sorted
// order: gix = column ids, dense = M [n_cols, k]); for X^T @ G they are X's
// columns (the column-sorted order: gix = row ids, dense = G [n_rows, k]).
//
// Skew is the hazard: a hashed-text matrix has ~9 entries a row and ~80 a
// hash column, but one dense column (a numeric feature) holds every row.  A
// warp per segment would leave that one warp walking 10^6 gathers alone.  So
// work is cut by entries, never by segments:
//
//   pass 1 (chunk_kernel): warp w owns the CHUNK = 256 entries
//     [w * CHUNK, (w + 1) * CHUNK) and walks them in 8 steps of 32 (one entry
//     a lane, coalesced loads of the stream, one gather of k floats from the
//     dense operand).  An inclusive segmented scan over the 32 lanes (shuffles
//     in a fixed tree order) plus a running carry across steps gives each
//     segment's sum over the chunk.  A segment that starts and ends inside
//     the chunk is written to `out` directly; the chunk's first segment, if
//     it began in an earlier chunk, goes to head[w]; its last, if it runs on
//     into a later chunk, goes to tail[w].
//   pass 2 (carry_kernel): warp c finishes the segment that starts in chunk
//     c and runs past its end: out[s] = tail[c] + (head[c+1] + ... +
//     head[ce]), the head partials summed lane-strided and then by a fixed
//     xor-shuffle tree, so even the 3,900 partials of a million-entry column
//     take a warp a few microseconds.
//
// No float atomics anywhere and every sum runs in an order fixed by the
// stream's layout, so the same inputs give the same bits on every launch
// (FISTA's tolerance stop is sensitive to f32 summation order).  Segments
// with no entries are never written: the wrapper zeroes `out`.
//
// Bound: bytes.  The stream (val, gix, seg: 12 bytes an entry) is read once,
// `out` written once, and the gathered rows of the dense operand (at k = 6
// a [100,003, 6] M of 2.4 MB, or a [10^6, 6] G of 24 MB) mostly come from
// the 50 MB L2.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace spseg {

constexpr int WARP = 32;
constexpr int STEPS = 8;
constexpr int CHUNK = WARP * STEPS;       // entries per warp in pass 1
constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL = 0xffffffffu;

template <int KB>
__global__ void chunk_kernel(const float* __restrict__ val,
                             const int32_t* __restrict__ gix,
                             const int32_t* __restrict__ seg,
                             const float* __restrict__ dense, long long nnz,
                             int k, float* __restrict__ out,
                             float* __restrict__ head,
                             float* __restrict__ tail, long long n_chunks) {
  const long long w =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  if (w >= n_chunks) return;               // the whole warp leaves together
  const long long e0 = w * CHUNK;
  const long long e1 = min(e0 + (long long)CHUNK, nnz);
  // the segment open at the chunk's start, if it began in an earlier chunk
  const int before = e0 > 0 ? seg[e0 - 1] : -1;
  float carry[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) carry[j] = 0.f;
  int carry_seg = -1;
  for (long long base = e0; base < e1; base += WARP) {
    const long long e = base + lane;
    const bool valid = e < e1;
    const int s = valid ? seg[e] : -2;     // -2: past the chunk, its own run
    const int s_next = (valid && e + 1 < nnz) ? seg[e + 1] : -3;
    float p[KB];
    if (valid) {
      const float v = val[e];
      const float* row = dense + (long long)gix[e] * k;
#pragma unroll
      for (int j = 0; j < KB; ++j) p[j] = j < k ? v * row[j] : 0.f;
    } else {
#pragma unroll
      for (int j = 0; j < KB; ++j) p[j] = 0.f;
    }
    // inclusive segmented scan: lane i ends with the sum of its segment's
    // entries from the step's first lane (or the segment's start) to i
#pragma unroll
    for (int off = 1; off < WARP; off <<= 1) {
      const int so = __shfl_up_sync(FULL, s, off);
      const bool take = lane >= off && so == s;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (j < k) {                        // k is the same on every lane
          const float q = __shfl_up_sync(FULL, p[j], off);
          if (take) p[j] += q;
        }
      }
    }
    if (s == carry_seg) {
#pragma unroll
      for (int j = 0; j < KB; ++j) p[j] = carry[j] + p[j];
    }
    if (valid) {
      const bool ends = s_next != s;        // e is its segment's last entry
      if (ends || e + 1 == e1) {
        float* dst = s == before ? head + w * k
                     : !ends     ? tail + w * k
                                 : out + (long long)s * k;
#pragma unroll
        for (int j = 0; j < KB; ++j)
          if (j < k) dst[j] = p[j];
      }
    }
    carry_seg = __shfl_sync(FULL, s, WARP - 1);
#pragma unroll
    for (int j = 0; j < KB; ++j) carry[j] = __shfl_sync(FULL, p[j], WARP - 1);
  }
}

template <int KB>
__global__ void carry_kernel(const int32_t* __restrict__ seg,
                             const long long* __restrict__ ptr,
                             long long nnz, int k,
                             const float* __restrict__ head,
                             const float* __restrict__ tail,
                             float* __restrict__ out, long long n_chunks) {
  const long long c =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  if (c >= n_chunks) return;
  const long long e1 = (c + 1) * CHUNK;
  if (e1 >= nnz) return;
  const int s = seg[e1 - 1];
  if (seg[e1] != s) return;                // the last segment ends inside
  if (ptr[s] < c * CHUNK) return;          // it began earlier: not ours
  const long long ce = (ptr[s + 1] - 1) / CHUNK;
  float acc[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) acc[j] = 0.f;
  for (long long cc = c + 1 + lane; cc <= ce; cc += WARP) {
    const float* h = head + cc * k;
#pragma unroll
    for (int j = 0; j < KB; ++j)
      if (j < k) acc[j] += h[j];
  }
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < KB; ++j)
      if (j < k) acc[j] += __shfl_xor_sync(FULL, acc[j], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < KB; ++j)
      if (j < k) out[(long long)s * k + j] = tail[c * k + j] + acc[j];
  }
}

template <int KB>
int launch_kb(const float* val, const int32_t* gix, const int32_t* seg,
              const long long* ptr, const float* dense, float* out,
              float* head, float* tail, long long nnz, int k,
              cudaStream_t stream) {
  const long long n_chunks = (nnz + CHUNK - 1) / CHUNK;
  const int threads = WARP * WARPS_PER_BLOCK;
  const long long blocks = (n_chunks + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  chunk_kernel<KB><<<(unsigned)blocks, threads, 0, stream>>>(
      val, gix, seg, dense, nnz, k, out, head, tail, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_kernel<KB><<<(unsigned)blocks, threads, 0, stream>>>(
      seg, ptr, nnz, k, head, tail, out, n_chunks);
  return (int)cudaGetLastError();
}

// val/gix/seg [nnz] in segment order, ptr int64 [n_seg + 1] (segment s owns
// entries ptr[s] .. ptr[s+1]-1), dense f32 [*, k], out f32 [n_seg, k] zeroed,
// head/tail f32 [ceil(nnz / chunk), k] scratch; `chunk` must be CHUNK.
inline int launch(const void* val, const void* gix, const void* seg,
                  const void* ptr, const void* dense, void* out, void* head,
                  void* tail, long long nnz, int k, int chunk, void* stream) {
  if (nnz < 1) return 0;
  if (k < 1 || k > 32 || chunk != CHUNK) return (int)cudaErrorInvalidValue;
  const float* v = (const float*)val;
  const int32_t* g = (const int32_t*)gix;
  const int32_t* s = (const int32_t*)seg;
  const long long* p = (const long long*)ptr;
  const float* d = (const float*)dense;
  float* o = (float*)out;
  float* h = (float*)head;
  float* t = (float*)tail;
  cudaStream_t st = (cudaStream_t)stream;
  if (k == 1) return launch_kb<1>(v, g, s, p, d, o, h, t, nnz, k, st);
  if (k <= 2) return launch_kb<2>(v, g, s, p, d, o, h, t, nnz, k, st);
  if (k <= 4) return launch_kb<4>(v, g, s, p, d, o, h, t, nnz, k, st);
  if (k <= 8) return launch_kb<8>(v, g, s, p, d, o, h, t, nnz, k, st);
  if (k <= 16) return launch_kb<16>(v, g, s, p, d, o, h, t, nnz, k, st);
  return launch_kb<32>(v, g, s, p, d, o, h, t, nnz, k, st);
}

}  // namespace spseg
