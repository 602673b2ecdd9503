// sp_segsum.cuh — the shared body of sp_matmat.cu and sp_rmatmat.cu: a
// segmented gather-sum over a segment-sorted flat sparse entry stream,
//
//     out[s, :] = sum over entries e of segment s of  val[e] * dense[gix[e], :]
//
// with k <= 32 columns.  For X @ M the segments are X's rows (the row-sorted
// order: gix = column ids, dense = M [n_cols, k]); for X^T @ G they are X's
// columns (the column-sorted order: gix = row ids, dense = G [n_rows, k]).
//
// Work follows a plan built once per order from its pointers alone
// (sparse_kernels.segment_plan): a segment of at most T entries is light, a
// longer one heavy; `team` entry slots (a power of two) a light segment.
//
//   light: a tile is a run of contiguous light segments whose entries fit a
//     shared-memory stage.  A block stages a tile's values, gather ids and
//     pointers with cp.async (16-byte copies, evict-first in L2) into one
//     slot of a two-slot ring while it reduces the tile in the other.  A
//     team owns a segment: team slots x cgl lanes, the row's VEC-wide column
//     groups dealt over the cgl lanes (so a row's gather is one access of
//     neighbouring lanes where the team is narrow: rows; all of it on one
//     lane where the team is a warp: hash columns).  Slot l adds entries
//     l, l + team, ... in order, then one xor-shuffle tree over the slots.
//     Empty segments are written as zeros: `out` comes unset.
//   heavy: cut into pieces of PIECE entries, a warp a piece (32 / cgl
//     slots, the entries streamed from device memory).  A segment of one
//     piece is written directly; the others leave a partial a piece, and a
//     second launch (finish_kernel, a warp a segment) adds each segment's
//     partials in piece order.
//
// Blocks are persistent and walk the piece groups, then the tiles, in a
// fixed assignment.  No float atomics, products rounded before they are
// added (__fmul_rn / __fadd_rn: no contraction), and every sum runs in an
// order fixed by the order and its plan, so the same inputs give the same
// bits on every launch (FISTA's tolerance stop reads these sums) and the
// numpy emulation sparse_kernels.segsum_emulate gives them too.
//
// Bound: bytes.  Values and gather ids (8 bytes an entry) are read once,
// `out` written once; the dense rows (at k = 6 a [100,003, 6] M of 2.4 MB,
// or a [10^6, 6] G of 24 MB) come from L1 and the 50 MB L2, which the
// evict-first stream leaves to them — their random sectors, not the bytes,
// set the pace.  The including source names the namespace (SPSEG_NS:
// sp_matmat or sp_rmatmat), so a profile tells the two kernels apart.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace SPSEG_NS {

constexpr int WARP = 32, THREADS = 256, WARPS = THREADS / WARP;
constexpr int PIECE = 512;                 // entries of a heavy segment's piece
constexpr unsigned FULL = 0xffffffffu;

struct Args {        // the plan's int32 tables: sparse_kernels.SegmentPlan
  const float* val;  // [nnz] in segment order
  const int32_t* gix;
  const int32_t* ptr;     // [n_seg + 1]
  const int32_t* tiles;   // [n_tiles, 2]: first segment, end segment
  const int32_t* pieces;  // [n_pieces, 2]: segment, first entry
  const int32_t* finish;  // [n_finish, 2]: segment, first piece
  const float* dense;     // [*, k]
  float* out;             // [n_seg, k]
  float* partial;         // [n_pieces, k]
  int n_tiles, n_pieces, n_finish, k;
  int team;           // entry slots a light segment
  int cgl;            // lanes a row of the dense operand (VEC columns each)
  int vec;            // 1: the dense operand is aligned to VEC floats
  int stage;          // entries a ring slot holds
  int pstage;         // pointers a ring slot holds (a tile's segments + 1)
};

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes,
                                         uint64_t pol) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
                 ::"r"(s), "l"(src), "l"(pol) : "memory");
  else
    asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;"
                 ::"r"(s), "l"(src), "l"(pol) : "memory");
}

// Stage tile t into the ring slot at sv: its entries [a, b) (values at sv,
// gather ids stage floats on; entry e at e - (a & ~3), so 16-byte copies of
// aligned groups land aligned, and the ragged ends, or a stream not 16-byte
// aligned, go by 4 bytes) and its segments' pointers (2 * stage floats on).
__device__ __forceinline__ void stage(float* sv, const Args& p, int t,
                                      bool vec16, uint64_t pol) {
  const int s0 = p.tiles[2 * t], s1 = p.tiles[2 * t + 1];
  const int a = p.ptr[s0], b = p.ptr[s1];
  int32_t* sg = reinterpret_cast<int32_t*>(sv + p.stage);
  int32_t* sp = sg + p.stage;
  for (int s = s0 + threadIdx.x; s <= s1; s += THREADS)
    cp_async(sp + s - s0, p.ptr + s, 4, pol);
  const int a0 = a & ~3;
  int lo = (a + 3) & ~3, hi = b & ~3;
  if (!vec16 || lo >= hi) lo = hi = b;
  for (int e = a + threadIdx.x; e < lo; e += THREADS) {
    cp_async(sv + e - a0, p.val + e, 4, pol);
    cp_async(sg + e - a0, p.gix + e, 4, pol);
  }
  for (int e = hi + threadIdx.x; e < b; e += THREADS) {
    cp_async(sv + e - a0, p.val + e, 4, pol);
    cp_async(sg + e - a0, p.gix + e, 4, pol);
  }
  for (int e = lo + 4 * threadIdx.x; e < hi; e += 4 * THREADS) {
    cp_async(sv + e - a0, p.val + e, 16, pol);
    cp_async(sg + e - a0, p.gix + e, 16, pol);
  }
}

// A lane's columns: the VEC-wide groups col, col + cstep, ... below k (at
// most KB columns; acc[j] is column col + (j / VEC) * cstep + j % VEC).
//
// acc += v[i] * dense[g[i], the lane's columns] for i = i, i + step, ... <
// end, in that order; U entries' loads are issued before their adds.  STREAM
// reads the entries from device memory (evict-first), else from the staged
// tile.  A group is one vector load where `vec` (the operand is aligned to
// VEC floats), else VEC scalar loads.
template <int KB, int VEC, bool STREAM>
__device__ __forceinline__ void lane_sum(float (&acc)[KB], const float* v,
                                         const int32_t* g, int i, int end,
                                         int step, const float* dense, int k,
                                         int col, int cstep, bool vec) {
  constexpr int U = KB <= 2 ? 16 : 32 / KB;    // entries in flight a lane
  for (; i < end; i += U * step) {
    float x[U], r[U][KB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = i + u * step;
      if (e >= end) break;
      int gi;
      if constexpr (STREAM) {
        x[u] = __ldcs(v + e);
        gi = __ldcs(g + e);
      } else {
        x[u] = v[e];
        gi = g[e];
      }
      const float* row = dense + (long long)gi * k + col;
#pragma unroll
      for (int j = 0; j < KB; j += VEC) {
        if (col + (j / VEC) * cstep >= k) break;
        const float* q = row + (j / VEC) * cstep;
        if constexpr (VEC == 4) {
          if (vec) {
            const float4 w = __ldg(reinterpret_cast<const float4*>(q));
            r[u][j] = w.x; r[u][j + 1] = w.y; r[u][j + 2] = w.z;
            r[u][j + 3] = w.w;
            continue;
          }
        } else if constexpr (VEC == 2) {
          if (vec) {
            const float2 w = __ldg(reinterpret_cast<const float2*>(q));
            r[u][j] = w.x; r[u][j + 1] = w.y;
            continue;
          }
        }
#pragma unroll
        for (int c = 0; c < VEC; ++c) r[u][j + c] = __ldg(q + c);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i + u * step >= end) break;
#pragma unroll
      for (int j = 0; j < KB; ++j)
        if (col + (j / VEC) * cstep < k)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(x[u], r[u][j]));
    }
  }
}

// The xor-shuffle tree over a team's entry slots (lanes cgl apart; every slot
// ends with the team's sum: a + b == b + a), then slot 0's lanes write their
// columns to dst (when `live`).
template <int KB, int VEC>
__device__ __forceinline__ void team_finish(float (&acc)[KB], int lanes,
                                            int cgl, float* dst, int col,
                                            int cstep, int k, bool live) {
  for (int off = lanes >> 1; off >= cgl; off >>= 1) {
#pragma unroll
    for (int j = 0; j < KB; ++j)
      acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(FULL, acc[j], off));
  }
  if (!live || (threadIdx.x & (lanes - 1)) >= cgl) return;
#pragma unroll
  for (int j = 0; j < KB; j += VEC) {
    float* q = dst + col + (j / VEC) * cstep;
    if (col + (j / VEC) * cstep >= k) break;
    if constexpr (VEC == 4)
      *reinterpret_cast<float4*>(q) =
          make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
    else if constexpr (VEC == 2)
      *reinterpret_cast<float2*>(q) = make_float2(acc[j], acc[j + 1]);
    else
      *q = acc[j];
  }
}

template <int KB, int VEC>
__global__ void __launch_bounds__(THREADS) segsum_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];   // two ring slots
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(pol));
  const bool vec16 = ((reinterpret_cast<uintptr_t>(p.val) |
                       reinterpret_cast<uintptr_t>(p.gix)) & 15) == 0;
  // items: the piece groups (the longest segments start first), then tiles
  const int n_groups = (p.n_pieces + WARPS - 1) / WARPS;
  const int n_items = n_groups + p.n_tiles;
  // a light segment's team: team entry slots x cgl lanes a row; lane
  // (slot, c) takes the column groups c, c + cgl, ... of entries slot, slot
  // + team, ...  A piece's warp: WARP / cgl slots.
  const int lanes = p.team * p.cgl, n_teams = THREADS / lanes;
  const int tm = threadIdx.x / lanes;
  const int col = (threadIdx.x & (p.cgl - 1)) * VEC, cstep = p.cgl * VEC;
  const int slot_e = (threadIdx.x & (lanes - 1)) / p.cgl;
  const int wslot = (threadIdx.x & (WARP - 1)) / p.cgl;
  const bool has = col < p.k;
  int it = blockIdx.x, slot = 0;
  if (it >= n_groups && it < n_items)
    stage(smem, p, it - n_groups, vec16, pol);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (; it < n_items; it += gridDim.x, slot ^= 1) {
    const int nx = it + gridDim.x;          // the next tile's copy is in
    if (nx >= n_groups && nx < n_items)     // flight while this item runs
      stage(smem + (slot ^ 1) * (2 * p.stage + p.pstage), p, nx - n_groups,
            vec16, pol);
    asm volatile("cp.async.commit_group;" ::: "memory");
    float acc[KB];
    if (it >= n_groups) {
      asm volatile("cp.async.wait_group 1;" ::: "memory");
      __syncthreads();
      const float* sv = smem + slot * (2 * p.stage + p.pstage);
      const int32_t* sg = reinterpret_cast<const int32_t*>(sv + p.stage);
      const int32_t* sp = sg + p.stage;
      const int s0 = p.tiles[2 * (it - n_groups)];
      const int s1 = p.tiles[2 * (it - n_groups) + 1];
      const int a0 = sp[0] & ~3;
      for (int s = s0 + tm; s - tm < s1; s += n_teams) {  // same count: lanes
#pragma unroll
        for (int j = 0; j < KB; ++j) acc[j] = 0.f;
        if (s < s1 && has)
          lane_sum<KB, VEC, false>(acc, sv, sg, sp[s - s0] - a0 + slot_e,
                                   sp[s - s0 + 1] - a0, p.team, p.dense, p.k,
                                   col, cstep, p.vec);
        team_finish<KB, VEC>(acc, lanes, p.cgl, p.out + (long long)s * p.k,
                             col, cstep, p.k, s < s1 && has);
      }
      __syncthreads();                      // the slot is free to refill
    } else {
      const int q = it * WARPS + threadIdx.x / WARP;
      if (q >= p.n_pieces) continue;        // the whole warp, or none of it
      const int s = p.pieces[2 * q], e0 = p.pieces[2 * q + 1];
      const int end = p.ptr[s + 1];
#pragma unroll
      for (int j = 0; j < KB; ++j) acc[j] = 0.f;
      if (has)
        lane_sum<KB, VEC, true>(acc, p.val, p.gix, e0 + wslot,
                                min(e0 + PIECE, end), WARP / p.cgl, p.dense,
                                p.k, col, cstep, p.vec);
      team_finish<KB, VEC>(
          acc, WARP, p.cgl,
          end - p.ptr[s] <= PIECE ? p.out + (long long)s * p.k
                                  : p.partial + (long long)q * p.k,
          col, cstep, p.k, has);
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// a warp a multi-piece segment, in the pieces' lane layout: slot l adds the
// partials of pieces l, l + WARP / cgl, ... in order, then the tree
template <int KB, int VEC>
__global__ void finish_kernel(const Args p) {
  const int f = (blockIdx.x * blockDim.x + threadIdx.x) / WARP;
  if (f >= p.n_finish) return;
  const int s = p.finish[2 * f], p0 = p.finish[2 * f + 1];
  const int np = (p.ptr[s + 1] - p.ptr[s] + PIECE - 1) / PIECE;
  const int col = (threadIdx.x & (p.cgl - 1)) * VEC, cstep = p.cgl * VEC;
  float acc[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) acc[j] = 0.f;
  const int step = WARP / p.cgl;
  constexpr int U = KB <= 8 ? 4 : 2;       // partials in flight a lane
  for (int q = (threadIdx.x & (WARP - 1)) / p.cgl; q < np; q += U * step) {
    float r[U][KB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (q + u * step >= np) break;
      const float* h = p.partial + (long long)(p0 + q + u * step) * p.k;
#pragma unroll
      for (int j = 0; j < KB; ++j)
        if (col + (j / VEC) * cstep < p.k)
          r[u][j] = h[col + (j / VEC) * cstep + j % VEC];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (q + u * step >= np) break;
#pragma unroll
      for (int j = 0; j < KB; ++j)
        if (col + (j / VEC) * cstep < p.k)
          acc[j] = __fadd_rn(acc[j], r[u][j]);
    }
  }
  team_finish<KB, VEC>(acc, WARP, p.cgl, p.out + (long long)s * p.k, col,
                       cstep, p.k, col < p.k);
}

template <int KB, int VEC>
int launch_kb(const Args& p, cudaStream_t stream) {
  const int smem = 2 * (2 * p.stage + p.pstage) * (int)sizeof(float);
  static int sized = -1, per_sm = 0, sms = 0;     // for the last stage size
  if (smem != sized) {
    int dev = 0;
    cudaError_t err = cudaFuncSetAttribute(
        segsum_kernel<KB, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, segsum_kernel<KB, VEC>, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    sized = smem;
  }
  const long long items = p.n_tiles + (p.n_pieces + WARPS - 1) / WARPS;
  const long long grid = items < (long long)sms * per_sm
                             ? items : (long long)sms * per_sm;
  if (grid > 0) {
    segsum_kernel<KB, VEC><<<(unsigned)grid, THREADS, smem, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || p.n_finish == 0) return (int)err;
  }
  if (p.n_finish > 0)
    finish_kernel<KB, VEC><<<(p.n_finish + WARPS - 1) / WARPS, THREADS, 0,
                             stream>>>(p);
  return (int)cudaGetLastError();
}

// the smallest KB (a power of two, VEC .. 32) that holds `cols` columns
template <int KB, int VEC>
int launch_cols(const Args& p, int cols, cudaStream_t st) {
  if constexpr (KB < 32)
    if (cols > KB) return launch_cols<2 * KB, VEC>(p, cols, st);
  return launch_kb<KB, VEC>(p, st);
}

// val/gix [nnz] in segment order; ptr, tiles, pieces, finish: the plan's
// tables; dense f32 [*, k]; out f32 [n_seg, k], every row written; partial
// f32 [n_pieces, k] scratch (read only for the segments in `finish`).  The
// lanes: a row's VEC-column groups (VEC = 4 if k % 4 == 0, 2 if k % 2 == 0,
// else 1; vector loads where the operand is aligned to VEC floats) dealt
// over cgl lanes (a power of two); team entry slots a light segment (team *
// cgl <= 32); stage and pstage multiples of 4.  Persistent blocks: as many
// as fit the card.
inline int launch(const void* val, const void* gix, const void* ptr,
                  const void* tiles, int n_tiles, const void* pieces,
                  int n_pieces, const void* finish, int n_finish,
                  const void* dense, void* out, void* partial, int k,
                  int cgl, int team, int stage, int pstage,
                  void* stream) {
  const int vw = k % 4 == 0 ? 4 : k % 2 == 0 ? 2 : 1;
  if (k < 1 || k > 32 || cgl < 1 || (cgl & (cgl - 1)) || cgl > WARP ||
      team < 1 || (team & (team - 1)) || team * cgl > WARP || stage % 4 ||
      pstage % 4)
    return (int)cudaErrorInvalidValue;
  const Args p{(const float*)val, (const int32_t*)gix, (const int32_t*)ptr,
               (const int32_t*)tiles, (const int32_t*)pieces,
               (const int32_t*)finish, (const float*)dense, (float*)out,
               (float*)partial, n_tiles, n_pieces, n_finish, k, team, cgl,
               (int)(((uintptr_t)dense % (4 * vw)) == 0), stage, pstage};
  cudaStream_t st = (cudaStream_t)stream;
  const int cols = (k / vw + cgl - 1) / cgl * vw;  // a lane's columns, most
  if (vw == 4) return launch_cols<4, 4>(p, cols, st);
  if (vw == 2) return launch_cols<2, 2>(p, cols, st);
  return launch_cols<1, 1>(p, cols, st);
}

}  // namespace SPSEG_NS
