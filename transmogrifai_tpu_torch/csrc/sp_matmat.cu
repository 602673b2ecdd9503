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
// Design and bound: sp_segsum.cuh (two passes over fixed 256-entry chunks,
// no float atomics, bit-repeatable).  At 10^6 rows, 9.0M entries and k = 6
// the function must read 72 MB of values and column ids, 4 MB of row
// pointers (int32 would do) and the 2.4 MB M and write the 24 MB output:
// ~0.031 ms at 3.35 TB/s.  The kernel also reads each entry's row id (36 MB more).
#include "sp_segsum.cuh"

extern "C" int sp_matmat_launch(const void* val, const void* col,
                                const void* row, const void* row_ptr,
                                const void* m, void* out, void* head,
                                void* tail, long long nnz, int k, int chunk,
                                void* stream) {
  return spseg::launch(val, col, row, row_ptr, m, out, head, tail, nnz, k,
                       chunk, stream);
}
