// sp_matmat — X @ M for a flat sparse X [n_rows, n_cols] and a dense f32
// M [n_cols, k] (k <= 32): out[r, :] = sum over row r's entries e of
// values[e] * M[indices[e], :], over X's row-sorted order.  sp_matvec is its
// k = 1 case.
//
// Replaces (JAX): transmogrifai_tpu/sparse/matrix.py:sp_matmat and sp_matvec
// (:45-63) — take of M's rows then segment_sum over row_ids — called from
// the sparse fitters' margins (solvers.py:472-559), the CV margins
// (tuning.py:566-571) and scoring (linear.py:205-210).
//
// Design and bound: sp_segsum.cuh.  Rows are light segments of ~9 entries:
// a row a team of one entry slot, its k columns dealt over neighbouring lanes
// (4 at k = 6), so a gathered row of M is one access; one launch (a longer
// row is cut into pieces); no float atomics, bit-repeatable.  At 10^6 rows,
// 9.0M entries and k = 6 the function must read 72 MB of values and column
// ids, 4 MB of row pointers (the plan's int32 copy) and the 2.4 MB M and
// write the 24 MB output: ~0.031 ms at 3.35 TB/s.
#define SPSEG_NS sp_matmat
#include "sp_segsum.cuh"

extern "C" int sp_matmat_launch(const void* val, const void* col,
                             const void* row_ptr, const void* tiles, int n_tiles,
                             const void* pieces, int n_pieces,
                             const void* finish, int n_finish, const void* m,
                             void* out, void* partial, int k, int cgl,
                             int team, int stage, int pstage, void* stream) {
  return sp_matmat::launch(val, col, row_ptr, tiles, n_tiles, pieces, n_pieces,
                        finish, n_finish, m, out, partial, k, cgl, team,
                        stage, pstage, stream);
}
