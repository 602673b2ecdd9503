// fista_glm — one evaluation of the FISTA grid solver's smooth part for the
// exp-link GLM losses (poisson, gamma), for L lanes at once: the loss value
// of every lane and, in the gradient form, X^T g and sum g as well.
//
// Replaces (JAX): transmogrifai_tpu/models/solvers.py:_fista_loop's
// smooth_grad and smooth_val (:160-170) with the dense closures xs_mv /
// xs_tmv (:270-286) for the losses _poisson_loss_grad / _gamma_loss_grad
// (:66-80), vmapped over the (fold x grid) lanes by linear_grid_fit
// (:334-376).  The gradient form serves each iteration's smooth_grad at the
// extrapolated point z; the value form serves the Beck-Teboulle
// backtracking tests (:189-215), one lane per (lane, trial step) of a ladder
// of trial steps (the wrapper lays them out; models/solvers.py).
//
// Computes, for lanes l < L (fold f(l) = (lane0 + l) / G) and rows n < N:
//   m[n,l] = (sum_d X[n,d] * V[l,d] - muv[l]) + b[l]
//   poisson: mu = exp(clip(m, -30, 30))
//            lw[n,l] = W[f,n] * (mu - y[n] * m)
//            g[n,l]  = W[f,n] * (mu - y[n]) / wsum[l]
//   gamma:   iv = exp(clip(-m, -30, 30))
//            lw[n,l] = W[f,n] * (y[n] * iv + m)
//            g[n,l]  = W[f,n] * (1 - y[n] * iv) / wsum[l]
//   out[d, l] = sum_n X[n,d] * g[n,l] (d < D), out[D, l] = sum_n g[n,l]
//                                                 (gradient form only)
//   out[(D+1)*L + l] (value form: out[l]) = sum_n lw[n,l]
// As in the JAX package, y * m is not clipped: only the exponent is
// (fista_loss.cuh:fl_glm).  The wrapper divides the loss sums by wsum.
//
// Design, numerics and bound: csrc/fista_tc.cuh — the margins on tensor
// cores in split TF32 with X read once a launch through a cp.async ring,
// the fold weights staged once a (row, fold), the loss terms formed where
// the margins are and summed per (row slot, column) in a fixed order, and
// in the gradient form X^T g on tensor cores; the value form skips X^T g.
// At 1M x 16 the gradient form (12 lanes) is bound by X's bytes; a value
// pass of 96 trial lanes runs as two launches of at most 64 columns
// (models/linear_kernels.py:glm_launch_plan), each reading X once, and is
// bound by X's bytes twice and its 96 M exponentials.  No float atomics:
// the same inputs give the same bits on every run, so the backtracking
// test (a loss sum over a million rows compared with 1e-12 of slack) and
// the tolerance stop decide the same way on every run.
// the GLM's own kernel names in a profile (fista_step's are fista_tc_*)
#define fista_tc_kernel fista_glm_kernel
#define fista_tc_reduce fista_glm_reduce
#include "fista_tc.cuh"

// loss: FL_POISSON or FL_GAMMA; grad != 0: the gradient form, out
// [(D+1)*L + L]; else the value form, out [L]; the plan's ints as
// glm_launch_plan gives them
extern "C" int fista_glm_launch(const void* X, const void* V, const void* muv,
                                const void* b, const void* W, const void* y,
                                const void* wsum, void* partial, void* accg,
                                void* vg, void* out, long long N, int D,
                                int L, int C, int lane0, int G, int loss,
                                int TR, int CS, int DS, int S, int v_res,
                                int acc_res, int ncl_max, int smem, int grad,
                                void* stream) {
  if (C != 1 || (loss != FL_POISSON && loss != FL_GAMMA))
    return (int)cudaErrorInvalidValue;
  return fista_tc_launch(X, V, muv, b, W, y, wsum, partial, accg, vg, out, N,
                         D, L, C, lane0, G, loss, TR, CS, DS, S, v_res,
                         acc_res, ncl_max, smem, stream, grad ? 0 : 1);
}
