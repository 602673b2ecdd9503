"""Linear-family models (port of ``transmogrifai_tpu/models/linear.py``;
reference: OpLogisticRegression.scala:46, OpLinearSVC.scala).

The port has binary elastic-net logistic regression and the squared-hinge
linear SVC.  Multinomial, the GLMs, naive Bayes and the MLP come with later
slices of the port.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict

import numpy as np
import torch

from ..columns import device_matrix, to_device_f32
from ..device import tensor_device
from .base import PredictionModel, PredictorEstimator
from .solvers import linear_grid_fit


def _n_classes(y) -> int:
    if not len(y):
        return 2
    if isinstance(y, torch.Tensor):
        return int(y.max()) + 1
    return int(np.max(y)) + 1


def _grouped_grid_fit(est, X, y, fold_weights, grids, *, device, loss: str,
                      l2l1, kind: str):
    """(fold × grid) batched fit: grid points are grouped by their static
    config (max_iter/intercept/standardization/tol) and each group trains as
    one batched lane loop over (fold weights [F, N]) × (l2s, l1s [G])
    (≙ ``_grouped_grid_fit``, linear.py:41).  ``l2l1`` maps a point's params
    to its (l2, l1) penalties.  Returns fitted dicts [F][G]."""
    K, G = len(fold_weights), len(grids)
    out: list = [[None] * G for _ in range(K)]
    groups = defaultdict(list)
    for gi, p in enumerate(grids):
        m = {**est._params, **p}
        groups[(int(m.get("max_iter", 100)), bool(m.get("fit_intercept", True)),
                bool(m.get("standardization", True)),
                float(m.get("tol", 1e-6)))].append(gi)
    Xd = device_matrix(X, device)
    yd = to_device_f32(y, device)
    Wd = to_device_f32(fold_weights, device)
    for (max_iter, fit_intercept, standardization, tol), gidx in groups.items():
        pens = [l2l1({**est._params, **grids[gi]}) for gi in gidx]
        res = linear_grid_fit(
            Xd, yd, Wd,
            torch.tensor([p[0] for p in pens], dtype=torch.float32,
                         device=device),
            torch.tensor([p[1] for p in pens], dtype=torch.float32,
                         device=device),
            loss=loss, fit_intercept=fit_intercept,
            standardization=standardization, max_iter=max_iter, tol=tol)
        n_it = res.n_iter.cpu().numpy()
        for j, gi in enumerate(gidx):
            for k in range(K):
                out[k][gi] = {"coef": res.coef[k, j],
                              "intercept": res.intercept[k, j],
                              "n_iter": int(n_it[k, j]),
                              "kind": kind, "n_classes": 2}
    return out


def _linear_device_scores(X: torch.Tensor, coef: torch.Tensor,
                          intercept: torch.Tensor, kind: str = "binary",
                          full: bool = False):
    """Binary score chain on the device (≙ ``_linear_device_scores`` /
    ``_scores_from_linear``, linear.py:148-184): margin → prediction and
    scores (the sigmoid for logistic, the raw margin for an SVC, which has
    no probability), with ``full`` also probability and rawPrediction."""
    margin = X @ coef + intercept.reshape(-1)[0]
    out = {"prediction": (margin > 0).to(torch.float32)}
    if kind == "svc":
        out["scores"] = margin
    else:
        p1 = torch.sigmoid(margin)
        out["scores"] = p1
        if full:
            out["probability"] = torch.stack([1.0 - p1, p1], dim=1)
    if full:
        out["rawPrediction"] = torch.stack([-margin, margin], dim=1)
    return out


class LinearPredictionModel(PredictionModel):
    """Fitted binary linear model; ``fitted``: coef [D], intercept [1],
    kind "binary" (logistic) or "svc"."""

    def device_scores(self, X, full: bool = False) -> Dict[str, Any]:
        return _linear_device_scores(
            X, to_device_f32(self.fitted["coef"], X.device),
            to_device_f32(self.fitted["intercept"], X.device),
            kind=self.fitted.get("kind", "binary"), full=full)


class _LinearGridEstimator(PredictorEstimator):
    """A binary linear estimator trained by the (fold × grid) FISTA program:
    ``loss`` names the solver's loss, ``kind`` the fitted model's scoring,
    ``_l2l1`` maps a grid point's params to its (l2, l1) penalties."""

    model_cls = LinearPredictionModel
    loss = kind = ""

    @staticmethod
    def _l2l1(m) -> tuple:
        raise NotImplementedError

    def _check_labels(self, y) -> None:
        pass

    def fit_arrays(self, X, y, sample_weight=None,
                   device=None) -> Dict[str, Any]:
        """One fit = the grid program with one fold and one lane."""
        dev = tensor_device(X, device)
        w = (np.ones((1, X.shape[0]), np.float32) if sample_weight is None
             else to_device_f32(sample_weight, dev)[None, :])
        return self.fit_arrays_grid(X, y, w, [{}], device=dev)[0][0]

    def fit_arrays_grid(self, X, y, fold_weights, grids, device=None):
        self._check_labels(y)
        return _grouped_grid_fit(self, X, y, fold_weights, grids,
                                 device=tensor_device(X, device),
                                 loss=self.loss, l2l1=self._l2l1,
                                 kind=self.kind)


class OpLogisticRegression(_LinearGridEstimator):
    """≙ OpLogisticRegression (elastic-net logistic, binary)."""

    loss, kind = "logistic", "binary"

    @staticmethod
    def _l2l1(m) -> tuple:
        reg = float(m.get("reg_param", 0.0))
        en = float(m.get("elastic_net_param", 0.0))
        return reg * (1.0 - en), reg * en

    def __init__(self, reg_param: float = 0.0, elastic_net_param: float = 0.0,
                 max_iter: int = 100, tol: float = 1e-6,
                 fit_intercept: bool = True, standardization: bool = True, **kw):
        super().__init__(reg_param=reg_param, elastic_net_param=elastic_net_param,
                         max_iter=max_iter, tol=tol, fit_intercept=fit_intercept,
                         standardization=standardization, **kw)

    def _check_labels(self, y) -> None:
        if _n_classes(y) > 2:
            raise NotImplementedError(
                "OpLogisticRegression: multinomial labels arrive with the "
                "port's multiclass slice (ROADMAP queue 1 item 14)")


class OpLinearSVC(_LinearGridEstimator):
    """≙ OpLinearSVC (squared-hinge linear SVM, binary, no probabilities;
    linear.py:302-348): an l2 penalty of ``reg_param`` and no l1."""

    loss, kind = "squared_hinge", "svc"

    @staticmethod
    def _l2l1(m) -> tuple:
        return float(m.get("reg_param", 0.0)), 0.0

    def __init__(self, reg_param: float = 0.0, max_iter: int = 100,
                 tol: float = 1e-6, fit_intercept: bool = True,
                 standardization: bool = True, **kw):
        super().__init__(reg_param=reg_param, max_iter=max_iter, tol=tol,
                         fit_intercept=fit_intercept,
                         standardization=standardization, **kw)
