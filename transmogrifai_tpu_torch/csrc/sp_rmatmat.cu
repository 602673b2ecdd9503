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
// Design and bound: sp_segsum.cuh.  Columns are where the skew is: ~270
// entries a used hash column (a warp's 32 entry slots a column, each lane
// all k columns of its entries' rows), but a dense numeric column holds all
// 10^6 rows; the plan cuts that column into ~2,000 pieces of 512 entries, a
// warp each, and a second launch adds their partials in piece order.  At
// 10^6 rows, 9.0M entries and k = 6 the function must read 72 MB of values
// and row ids, 0.4 MB of column pointers (the plan's int32 copy) and the
// 24 MB G and write the 2.4 MB output: ~0.030 ms at 3.35 TB/s.
#define SPSEG_NS sp_rmatmat
#include "sp_segsum.cuh"

extern "C" int sp_rmatmat_launch(const void* val, const void* row,
                             const void* col_ptr, const void* tiles, int n_tiles,
                             const void* pieces, int n_pieces,
                             const void* finish, int n_finish, const void* g,
                             void* out, void* partial, int k, int cgl,
                             int team, int stage, int pstage, void* stream) {
  return sp_rmatmat::launch(val, row, col_ptr, tiles, n_tiles, pieces, n_pieces,
                        finish, n_finish, g, out, partial, k, cgl, team,
                        stage, pstage, stream);
}
