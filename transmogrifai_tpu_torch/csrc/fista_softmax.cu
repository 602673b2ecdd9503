// fista_softmax_step — one gradient evaluation of the FISTA grid solver for
// L lanes (fold x penalty grid points) of the multinomial (softmax) loss on
// the implicitly standardised matrix.
//
// Replaces (JAX): transmogrifai_tpu/models/solvers.py:_softmax_loss_grad
// (:44-50) inside _fista_loop's smooth_grad (:160-166), with the dense
// closures xs_mv / xs_tmv on [D, C] coefficients (:270-286), vmapped over
// the (fold x grid) lanes by linear_grid_fit (:334-376).
//
// Computes, for lanes l < L (fold f(l) = (lane0 + l) / G), classes c < C and
// rows n < N, with the column j = l * C + c:
//   m[n,j] = (sum_d X[n,d] * V[j,d] - muv[j]) + b[j]
//   p[n,j] = exp(m[n,j] - max_c' m[n,l*C+c']) / sum_c' exp(...)
//   g[n,j] = W[f,n] * (p[n,j] - [y[n] == c]) / wsum[l]
//   out[d, j] = sum_n X[n,d] * g[n,j]   (d < D),   out[D, j] = sum_n g[n,j]
// (V = coef / scale per class, muv = mean . V: the caller un-standardises.)
//
// Design, numerics and bound: csrc/fista_tc.cuh, the kernel fista_step runs
// too, with the L*C (lane, class) columns in place of its lanes.  A lane's
// softmax runs in the accumulator fragments with quad shuffles where its
// classes sit in one fragment (C = 2, 4, 8 on a narrow X), else a thread per
// (row, lane) over the margins in shared memory (the 40-class case).  The
// wrapper (models/linear_kernels.py:fista_softmax_step) sizes every launch
// with softmax_launch_plan: at most 64 columns, whole lanes, a launch.
#include "fista_tc.cuh"

// y int32 class ids; out [(D+1) * L*C]; the plan's ints as
// softmax_launch_plan gives them
extern "C" int fista_softmax_launch(const void* X, const void* V, const void* muv,
                          const void* b, const void* W, const void* y,
                          const void* wsum, void* partial, void* accg,
                          void* vg, void* out, long long N, int D, int L,
                          int C, int lane0, int G, int loss, int TR, int CS,
                          int DS, int S, int v_res, int acc_res, int ncl_max,
                          int smem, void* stream) {
  if (C < 2 || loss != FL_SOFTMAX) return (int)cudaErrorInvalidValue;
  return fista_tc_launch(X, V, muv, b, W, y, wsum, partial, accg, vg, out, N,
                         D, L, C, lane0, G, loss, TR, CS, DS, S, v_res,
                         acc_res, ncl_max, smem, stream);
}
