// fista_loss.cuh — the FISTA grid solver's row loss derivatives, the one
// copy that the tensor-core form (fista_tc.cuh), the exp-link form
// (fista_glm.cu) and the two-pass form (fista_wide.cu) all call.
//
// Replaces (JAX): transmogrifai_tpu/models/solvers.py:_logistic /
// _squared_hinge / _squared_loss_grad (:53-56), the power iteration's
// product (_spectral_norm_sq_weighted, :112-131) and _poisson_loss_grad /
// _gamma_loss_grad (:66-80).  The softmax loss (:44-50) needs all of a
// row's classes and stays with each form.
#pragma once
#include <math.h>

// the loss codes of the wrappers' LOSSES / WIDE_LOSSES tables
enum { FL_LOGISTIC = 0, FL_SQUARED_HINGE = 1, FL_GRAM = 2, FL_SQUARED = 3,
       FL_SOFTMAX = 4, FL_POISSON = 5, FL_GAMMA = 6 };

// the loss derivative at margin mm, weighted by w / wsum (rws = 1 / wsum);
// "gram" is the power iteration's (w / wsum) * m
__device__ __forceinline__ float fl_grad(int loss, float mm, float yn,
                                         float w, float rws) {
  if (loss == FL_LOGISTIC) {
    const float pr = __frcp_rn(1.f + expf(-mm));
    return w * (pr - yn) * rws;
  }
  if (loss == FL_SQUARED_HINGE) {
    const float viol = fmaxf(0.f, 1.f - yn * mm);
    return w * (-2.f * viol * yn) * rws;
  }
  if (loss == FL_SQUARED) return w * (mm - yn) * rws;
  return (w * rws) * mm;
}

// an exp-link row's weighted loss term lw and gradient g at margin m
// (rws = 1 / wsum); as in the JAX package only the exponent is clipped:
//   poisson: mu = exp(clip(m)),  lw = w (mu - y m),     g = w (mu - y) rws
//   gamma:   iv = exp(clip(-m)), lw = w (y iv + m),     g = w (1 - y iv) rws
__device__ __forceinline__ void fl_glm(bool poisson, float m, float yn,
                                       float w, float rws, float& lw,
                                       float& g) {
  if (poisson) {
    const float mu = expf(fminf(fmaxf(m, -30.f), 30.f));
    lw = w * (mu - yn * m);
    g = w * (mu - yn) * rws;
  } else {
    const float iv = expf(fminf(fmaxf(-m, -30.f), 30.f));
    lw = w * (yn * iv + m);
    g = w * (1.f - yn * iv) * rws;
  }
}
