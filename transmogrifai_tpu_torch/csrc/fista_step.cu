// fista_step — one gradient evaluation of the FISTA grid solver for L lanes
// (fold x penalty grid points) on the implicitly standardised matrix, for
// the elementwise losses (logistic, squared hinge, squared; "gram": the
// power iteration's product).
//
// Replaces (JAX): transmogrifai_tpu/models/solvers.py:_fista_loop's
// smooth_grad (:160-166) with the dense closures xs_mv / xs_tmv (:270-286),
// vmapped over the (fold x grid) lanes by linear_grid_fit (:334-376), and the
// power iteration's product of _spectral_norm_sq_weighted (:112-131); the
// squared loss's row gradient is _squared_loss_grad (:53-56).
//
// Computes, for lanes l < L (fold f(l) = (lane0 + l) / G) and rows n < N:
//   m[n,l] = (sum_d X[n,d] * V[l,d] - muv[l]) + b[l]
//   g[n,l] = logistic:       W[f,n] * (sigmoid(m) - y[n]) / wsum[l]
//            squared hinge:  W[f,n] * (-2 * max(0, 1 - y[n]*m) * y[n]) / wsum[l]
//            gram:           (W[f,n] / wsum[l]) * m
//            squared:        W[f,n] * (m - y[n]) / wsum[l]
//   out[d, l] = sum_n X[n,d] * g[n,l]   (d < D),   out[D, l] = sum_n g[n,l]
// (V = coef / scale, muv = mean . V: the caller un-standardises.)
//
// Design, numerics and bound: csrc/fista_tc.cuh (split-TF32 tensor cores,
// X read once, clusters over feature slices for wide X, fixed-order sums).
// The wrapper (models/linear_kernels.py:fista_step) sizes every launch with
// launch_plan and runs at most 64 lanes a launch.
#include "fista_tc.cuh"

// loss: 0 logistic, 1 squared hinge, 2 gram (y unread), 3 squared; out
// [(D+1) * L]; the plan's ints as launch_plan gives them
extern "C" int fista_step_launch(const void* X, const void* V, const void* muv,
                          const void* b, const void* W, const void* y,
                          const void* wsum, void* partial, void* accg,
                          void* vg, void* out, long long N, int D, int L,
                          int C, int lane0, int G, int loss, int TR, int CS,
                          int DS, int S, int v_res, int acc_res, int ncl_max,
                          int smem, void* stream) {
  if (C != 1 || loss < FL_LOGISTIC || loss > FL_SQUARED)
    return (int)cudaErrorInvalidValue;
  return fista_tc_launch(X, V, muv, b, W, y, wsum, partial, accg, vg, out, N,
                         D, L, C, lane0, G, loss, TR, CS, DS, S, v_res,
                         acc_res, ncl_max, smem, stream);
}
