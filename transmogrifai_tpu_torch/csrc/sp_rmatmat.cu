// sp_rmatmat — X^T @ G for a flat sparse X [n_rows, n_cols] and a dense f32
// G [n_rows, k] (k <= 32): out[c, :] = sum over column c's entries e of
// values[e] * G[row_ids[e], :], over X's column-sorted order.  sp_rmatvec is
// its k = 1 case.
//
// Replaces (JAX): transmogrifai_tpu/sparse/matrix.py:sp_rmatmat and
// sp_rmatvec (:52-70) — take of G's rows then segment_sum over the column
// ids — called from the sparse fitters' gradients, column moments and power
// iteration (solvers.py:472-559).
//
// Design and bound: sp_segsum.cuh.  Columns are where the skew is: ~80
// entries a hash column, but a dense numeric column holds all 10^6 rows;
// the fixed 256-entry chunks give that column ~3,900 warps and the carry
// pass sums their partials in a fixed order.  At 10^6 rows, 9.0M entries
// and k = 6 the function must read 72 MB of values and row ids, 0.4 MB of
// column pointers (int32 would do) and the 24 MB G and write the 2.4 MB
// output: ~0.030 ms at 3.35 TB/s.  The kernel also reads each entry's
// column id (36 MB more).
#include "sp_segsum.cuh"

extern "C" int sp_rmatmat_launch(const void* val, const void* row,
                                 const void* col, const void* col_ptr,
                                 const void* g, void* out, void* head,
                                 void* tail, long long nnz, int k, int chunk,
                                 void* stream) {
  return spseg::launch(val, row, col, col_ptr, g, out, head, tail, nnz, k,
                       chunk, stream);
}
