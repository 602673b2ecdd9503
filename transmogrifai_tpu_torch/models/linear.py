"""Linear-family models (port of ``transmogrifai_tpu/models/linear.py``;
reference: OpLogisticRegression.scala:46, OpLinearSVC.scala,
OpLinearRegression.scala, OpNaiveBayes.scala,
OpMultilayerPerceptronClassifier.scala).

The port has elastic-net logistic regression — binary on a dense matrix or
a ``SparseMatrix``, multinomial (softmax, more than two classes) on a dense
one — and the squared-hinge linear SVC, elastic-net linear regression on a
dense matrix (closed-form ridge when no grid point has an l1 penalty),
generalized linear regression on a dense matrix (gaussian through ridge,
binomial through the logistic loss, poisson and gamma through backtracking
FISTA), multinomial naive Bayes and a small ReLU network trained by
full-batch Adam.  Sparse regression, sparse GLMs and sparse multinomial
fits come with a later slice of the port.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict

import numpy as np
import torch

from ..columns import device_matrix, to_device_f32
from ..device import tensor_device
from ..sparse.matrix import SparseMatrix
from .base import PredictionModel, PredictorEstimator
from .solvers import (linear_grid_fit, naive_bayes_fit, ridge_fit,
                      ridge_grid_fit, sparse_linear_grid_fit,
                      standardize_moments, unscale_params)


def _n_classes(y) -> int:
    if not len(y):
        return 2
    if isinstance(y, torch.Tensor):
        return int(y.max()) + 1
    return int(np.max(y)) + 1


def _grouped_grid_fit(est, X, y, fold_weights, grids, *, device, loss: str,
                      l2l1, kind: str, n_classes: int = 2, extra=None):
    """(fold × grid) batched fit: grid points are grouped by their static
    config (max_iter/intercept/standardization/tol) and each group trains as
    one batched lane loop over (fold weights [F, N]) × (l2s, l1s [G])
    (≙ ``_grouped_grid_fit``, linear.py:41); a ``SparseMatrix`` X takes
    ``sparse_linear_grid_fit`` (linear.py:56-90), and the squared loss with
    no l1 penalty in the group the closed-form ``ridge_grid_fit``
    (linear.py:92-97).  ``l2l1`` maps a point's params to its (l2, l1)
    penalties; the "softmax" loss fits ``n_classes`` classes; ``extra``
    goes into every fitted dict (a GLM's family).  Returns fitted dicts
    [F][G], with the step halvings of the backtracking losses."""
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
    sparse = isinstance(Xd, SparseMatrix)
    fit = sparse_linear_grid_fit if sparse else linear_grid_fit
    classes = {"n_classes": n_classes} if loss == "softmax" else {}
    for (max_iter, fit_intercept, standardization, tol), gidx in groups.items():
        pens = [l2l1({**est._params, **grids[gi]}) for gi in gidx]
        l2s, l1s = (torch.tensor(v, dtype=torch.float32, device=device)
                    for v in zip(*pens))
        if loss == "squared" and not sparse and not bool(l1s.any()):
            res = ridge_grid_fit(Xd, yd, Wd, l2s,
                                 fit_intercept=fit_intercept,
                                 standardization=standardization)
        else:
            res = fit(Xd, yd, Wd, l2s, l1s, loss=loss,
                      fit_intercept=fit_intercept,
                      standardization=standardization, max_iter=max_iter,
                      tol=tol, **classes)
        n_it = res.n_iter.cpu().numpy()
        halv = None if res.halvings is None else res.halvings.cpu().numpy()
        for j, gi in enumerate(gidx):
            for k in range(K):
                out[k][gi] = {"coef": res.coef[k, j],
                              "intercept": res.intercept[k, j],
                              "n_iter": int(n_it[k, j]),
                              "kind": kind, "n_classes": n_classes,
                              **(extra or {})}
                if halv is not None:
                    out[k][gi]["halvings"] = int(halv[k, j])
    return out


# a GLM family's inverse link of the clipped margin (≙ linear.py:186-189)
GLM_INVERSE_LINK = {"poisson": torch.exp, "gamma": torch.exp,
                    "binomial": torch.sigmoid, "gaussian": lambda e: e}
GLM_FAMILY_LOSS = {"gaussian": "squared", "binomial": "logistic",
                   "poisson": "poisson", "gamma": "gamma"}


def _linear_device_scores(X, coef: torch.Tensor, intercept: torch.Tensor,
                          kind: str = "binary", full: bool = False,
                          family: str = "gaussian"):
    """Score chain on the device (≙ ``_linear_device_scores`` /
    ``_scores_from_linear``, linear.py:148-189): margin → prediction and
    scores (the sigmoid for logistic, the raw margin for an SVC, which has
    no probability), with ``full`` also probability and rawPrediction; a
    regression's prediction is the margin itself, and it has nothing else;
    a GLM's (kind "glm") is its family's inverse link of the margin clipped
    to [-30, 30], and it has nothing else.
    A multinomial model (coef [D, C]) scores its C logits by one matmul:
    the first largest is the prediction, their softmax the probability and
    the logits themselves the rawPrediction.  A ``SparseMatrix`` X takes
    its margin from ``sp_matmat`` (linear.py:200-210)."""
    sparse = isinstance(X, SparseMatrix)
    if kind == "multinomial":
        logits = (X.matmat(coef.contiguous()) if sparse else X @ coef) \
            + intercept
        out = {"prediction": torch.argmax(logits, dim=1).to(torch.float32),
               "probability": torch.softmax(logits, dim=-1)}
        if full:
            out["rawPrediction"] = logits
        return out
    lin = X.matvec(coef) if sparse else X @ coef
    margin = lin + intercept.reshape(-1)[0]
    if kind == "regression":
        return {"prediction": margin}
    if kind == "glm":
        return {"prediction": GLM_INVERSE_LINK[family](
            torch.clamp(margin, -30.0, 30.0))}
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
    """Fitted linear model; ``fitted``: coef [D], intercept [1], kind
    "binary" (logistic), "svc", "regression" or "glm" (with its
    ``family``); or coef [D, C], intercept [C], kind "multinomial"."""

    def device_scores(self, X, full: bool = False) -> Dict[str, Any]:
        return _linear_device_scores(
            X, to_device_f32(self.fitted["coef"], X.device),
            to_device_f32(self.fitted["intercept"], X.device),
            kind=self.fitted.get("kind", "binary"), full=full,
            family=self.fitted.get("family", "gaussian"))


class _LinearGridEstimator(PredictorEstimator):
    """A linear estimator trained by the (fold × grid) program:
    ``loss`` names the solver's loss, ``kind`` the fitted model's scoring,
    ``_l2l1`` maps a grid point's params to its (l2, l1) penalties."""

    model_cls = LinearPredictionModel
    loss = kind = ""

    @staticmethod
    def _l2l1(m) -> tuple:
        raise NotImplementedError

    def fit_arrays(self, X, y, sample_weight=None,
                   device=None) -> Dict[str, Any]:
        """One fit = the grid program with one fold and one lane."""
        dev = tensor_device(X, device)
        w = (np.ones((1, X.shape[0]), np.float32) if sample_weight is None
             else to_device_f32(sample_weight, dev)[None, :])
        return self.fit_arrays_grid(X, y, w, [{}], device=dev)[0][0]

    def fit_arrays_grid(self, X, y, fold_weights, grids, device=None):
        return _grouped_grid_fit(self, X, y, fold_weights, grids,
                                 device=tensor_device(X, device),
                                 loss=self.loss, l2l1=self._l2l1,
                                 kind=self.kind)


class OpLogisticRegression(_LinearGridEstimator):
    """≙ OpLogisticRegression (elastic-net logistic; binary, or multinomial
    — the softmax loss, kind "multinomial" — for more than two classes,
    linear.py:236-300)."""

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

    def fit_arrays_grid(self, X, y, fold_weights, grids, device=None):
        C = _n_classes(y)
        if C <= 2:
            return super().fit_arrays_grid(X, y, fold_weights, grids,
                                           device=device)
        if isinstance(X, SparseMatrix):
            # the selector's skip seam passes over the family (TypeError)
            raise TypeError(
                "multinomial OpLogisticRegression on a SparseMatrix arrives "
                "with the port's sparse multinomial fits (ROADMAP queue 1 "
                "item 8); use a dense feature vector")
        return _grouped_grid_fit(self, X, y, fold_weights, grids,
                                 device=tensor_device(X, device),
                                 loss="softmax", l2l1=self._l2l1,
                                 kind="multinomial", n_classes=C)


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


class OpLinearRegression(_LinearGridEstimator):
    """≙ OpLinearRegression (elastic-net least squares, linear.py:351-410):
    l1 = reg·en, l2 = reg·(1 - en); closed-form ridge when l1 = 0, else
    FISTA on the squared loss.  Dense matrices only in this slice."""

    loss, kind = "squared", "regression"

    @staticmethod
    def _l2l1(m) -> tuple:
        return OpLogisticRegression._l2l1(m)

    def __init__(self, reg_param: float = 0.0, elastic_net_param: float = 0.0,
                 max_iter: int = 100, tol: float = 1e-6,
                 fit_intercept: bool = True, standardization: bool = True, **kw):
        super().__init__(reg_param=reg_param, elastic_net_param=elastic_net_param,
                         max_iter=max_iter, tol=tol, fit_intercept=fit_intercept,
                         standardization=standardization, **kw)

    def fit_arrays_grid(self, X, y, fold_weights, grids, device=None):
        if isinstance(X, SparseMatrix):
            # the selector's skip seam passes over the family (TypeError)
            raise TypeError(
                "OpLinearRegression on a SparseMatrix arrives with the "
                "port's sparse regression (ROADMAP queue 1 item 8); use a "
                "dense feature vector")
        return super().fit_arrays_grid(X, y, fold_weights, grids,
                                       device=device)

    def fit_arrays(self, X, y, sample_weight=None,
                   device=None) -> Dict[str, Any]:
        """One fit (≙ ``OpLinearRegression.fit_arrays``, linear.py:366-399):
        with no l1 penalty, ``ridge_fit`` on the explicitly standardised
        matrix; else the grid program with one fold and one lane."""
        l2, l1 = self._l2l1(self._params)
        if l1 != 0.0 or isinstance(X, SparseMatrix):
            return super().fit_arrays(X, y, sample_weight, device)
        dev = tensor_device(X, device)
        Xd = device_matrix(X, dev)
        yd = to_device_f32(y, dev)
        w = (torch.ones(Xd.shape[0], dtype=torch.float32, device=dev)
             if sample_weight is None else to_device_f32(sample_weight, dev))
        fit_intercept = bool(self.get("fit_intercept", True))
        if self.get("standardization", True):
            mean, scale = standardize_moments(Xd, w[None], fit_intercept)
            mean, scale = mean[0], scale[0]
            Xs = (Xd - mean) / scale
        else:
            mean = torch.zeros(Xd.shape[1], dtype=torch.float32, device=dev)
            scale = torch.ones_like(mean)
            Xs = Xd
        res = ridge_fit(Xs, yd, w, l2, fit_intercept=fit_intercept)
        coef, intercept = unscale_params(res.coef, res.intercept, mean, scale)
        return {"coef": coef, "intercept": intercept, "n_iter": 0,
                "kind": "regression", "n_classes": 2}


class GLMPredictionModel(LinearPredictionModel):
    """Fitted generalized linear model (≙ ``GLMPredictionModel``,
    linear.py:465-485): kind "glm", its ``family``'s inverse link of the
    clipped margin as the prediction."""


class OpGeneralizedLinearRegression(PredictorEstimator):
    """≙ OpGeneralizedLinearRegression (linear.py:411-462): families
    gaussian (the squared loss: closed-form ridge in the grid program, as
    l1 is always 0), binomial (logistic), poisson and gamma (log link:
    backtracking FISTA on ``fista_glm``), an l2 penalty of ``reg_param``,
    50 iterations by default.  Dense matrices only in this slice."""

    model_cls = GLMPredictionModel

    def __init__(self, family: str = "gaussian", link=None,
                 reg_param: float = 0.0, max_iter: int = 50,
                 tol: float = 1e-6, fit_intercept: bool = True, **kw):
        super().__init__(family=family, link=link, reg_param=reg_param,
                         max_iter=max_iter, tol=tol,
                         fit_intercept=fit_intercept, **kw)

    def _loss(self) -> str:
        family = self.get("family", "gaussian")
        loss = GLM_FAMILY_LOSS.get(family)
        if loss is None:
            raise ValueError(f"unsupported GLM family {family!r}")
        return loss

    @staticmethod
    def _dense_only(X):
        if isinstance(X, SparseMatrix):
            # the selector's skip seam passes over the family (TypeError)
            raise TypeError(
                "OpGeneralizedLinearRegression on a SparseMatrix arrives "
                "with the port's sparse regression (ROADMAP queue 1 item "
                "8); use a dense feature vector")

    def fit_arrays(self, X, y, sample_weight=None,
                   device=None) -> Dict[str, Any]:
        """One fit (≙ ``fit_arrays``, linear.py:426-453): X standardised
        explicitly by its weighted moments, then one FISTA lane on the
        standardised matrix (no further standardisation) and the
        coefficients unscaled."""
        self._dense_only(X)
        loss = self._loss()
        dev = tensor_device(X, device)
        Xd = device_matrix(X, dev)
        w = (torch.ones(Xd.shape[0], dtype=torch.float32, device=dev)
             if sample_weight is None else to_device_f32(sample_weight, dev))
        fit_intercept = bool(self.get("fit_intercept", True))
        mean, scale = standardize_moments(Xd, w[None], fit_intercept)
        Xs = (Xd - mean) / scale
        pen = torch.tensor([float(self.get("reg_param", 0.0))],
                           dtype=torch.float32, device=dev)
        res = linear_grid_fit(Xs, to_device_f32(y, dev), w[None], pen,
                              torch.zeros_like(pen), loss=loss,
                              fit_intercept=fit_intercept,
                              standardization=False,
                              max_iter=int(self.get("max_iter", 50)),
                              tol=float(self.get("tol", 1e-6)))
        coef, intercept = unscale_params(res.coef[0, 0], res.intercept[0, 0],
                                         mean[0], scale[0])
        out = {"coef": coef, "intercept": intercept,
               "n_iter": int(res.n_iter[0, 0]), "kind": "glm",
               "family": self.get("family", "gaussian"), "n_classes": 2}
        if res.halvings is not None:
            out["halvings"] = int(res.halvings[0, 0])
        return out

    def fit_arrays_grid(self, X, y, fold_weights, grids, device=None):
        self._dense_only(X)
        return _grouped_grid_fit(
            self, X, y, fold_weights, grids,
            device=tensor_device(X, device), loss=self._loss(),
            l2l1=lambda m: (float(m.get("reg_param", 0.0)), 0.0),
            kind="glm", extra={"family": self.get("family", "gaussian")})


def _class_scores(logits: torch.Tensor, full: bool) -> Dict[str, Any]:
    """Prediction (the first largest logit), softmax probability, the
    class-1 score of a two-class model and, with ``full``, the logits as
    rawPrediction (≙ the scoring tails of linear.py:488-620)."""
    prob = torch.softmax(logits, dim=-1)
    out = {"prediction": torch.argmax(logits, dim=1).to(torch.float32),
           "probability": prob}
    if prob.shape[1] == 2:
        out["scores"] = prob[:, 1]
    if full:
        out["rawPrediction"] = logits
    return out


def _dense(X, device, name: str) -> torch.Tensor:
    Xd = device_matrix(X, device)
    if isinstance(Xd, SparseMatrix):
        # the selector's skip seam passes over the family (TypeError)
        raise TypeError(f"{name} takes a dense feature vector")
    return Xd


class NaiveBayesModel(PredictionModel):
    """Fitted multinomial naive Bayes: log_prior [C], log_prob [C, D]
    (≙ ``NaiveBayesModel``, linear.py:488-515)."""

    def device_scores(self, X, full: bool = False) -> Dict[str, Any]:
        dev = X.device
        logits = (torch.clamp(X, min=0.0)
                  @ to_device_f32(self.fitted["log_prob"], dev).T
                  + to_device_f32(self.fitted["log_prior"], dev))
        return _class_scores(logits, full)


class OpNaiveBayes(PredictorEstimator):
    """≙ OpNaiveBayes (multinomial, smoothing 1.0; linear.py:517-529).
    Expects non-negative features: negative values count as 0."""

    model_cls = NaiveBayesModel

    def __init__(self, smoothing: float = 1.0, **kw):
        super().__init__(smoothing=smoothing, **kw)

    def fit_arrays(self, X, y, sample_weight=None,
                   device=None) -> Dict[str, Any]:
        dev = tensor_device(X, device)
        Xd = _dense(X, dev, "OpNaiveBayes")
        w = (torch.ones(Xd.shape[0], dtype=torch.float32, device=dev)
             if sample_weight is None else to_device_f32(sample_weight, dev))
        C = _n_classes(y)
        log_prior, log_prob = naive_bayes_fit(
            Xd, to_device_f32(y, dev), w, float(self.get("smoothing", 1.0)),
            n_classes=C)
        return {"log_prior": log_prior, "log_prob": log_prob,
                "kind": "naive_bayes", "n_classes": C}


class MLPClassificationModel(PredictionModel):
    """Fitted feed-forward network: ``W{i}`` [d_i, d_i+1] and ``b{i}`` per
    layer, ReLU between layers (≙ ``MLPClassificationModel``,
    linear.py:531-570)."""

    def device_scores(self, X, full: bool = False) -> Dict[str, Any]:
        dev = X.device
        n_layers = int(self.fitted["n_layers"])
        h = X
        for i in range(n_layers):
            h = (h @ to_device_f32(self.fitted[f"W{i}"], dev)
                 + to_device_f32(self.fitted[f"b{i}"], dev))
            if i < n_layers - 1:
                h = torch.relu(h)
        return _class_scores(h, full)


class _MLP(torch.nn.Module):
    """Linear + ReLU layers; ``params`` [(W [d_in, d_out], b [d_out])]."""

    def __init__(self, params):
        super().__init__()
        self.layers = torch.nn.ModuleList()
        for W, b in params:
            lin = torch.nn.Linear(W.shape[0], W.shape[1], device=W.device)
            with torch.no_grad():
                lin.weight.copy_(W.T)
                lin.bias.copy_(b)
            self.layers.append(lin)

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x

    def params(self):
        return [(lin.weight.detach().T.contiguous(), lin.bias.detach().clone())
                for lin in self.layers]


def mlp_train(params, X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              max_iter: int, step_size: float):
    """``max_iter`` full-batch Adam steps (``torch.optim.Adam``: eps 1e-8
    outside the square root, as optax places it) on the weighted mean
    softmax cross-entropy, from ``params`` [(W [d_in, d_out], b)] (≙ the
    optax loop of ``OpMultilayerPerceptronClassifier.fit_arrays``,
    linear.py:591-612).  Returns the trained [(W, b)]."""
    net = _MLP(params)
    opt = torch.optim.Adam(net.parameters(), lr=step_size, eps=1e-8)
    yl = y.long()
    wsum = w.sum()
    for _ in range(max_iter):
        opt.zero_grad()
        ls = torch.nn.functional.cross_entropy(net(X), yl, reduction="none")
        ((w * ls).sum() / wsum).backward()
        opt.step()
    return net.params()


class OpMultilayerPerceptronClassifier(PredictorEstimator):
    """≙ OpMultilayerPerceptronClassifier (linear.py:573-620): a small
    feed-forward ReLU network trained by full-batch Adam.  The initial
    weights are He-normal draws of a CPU ``torch.Generator`` seeded with
    ``seed`` (other numbers than the JAX package's ``jax.random``; the
    same on every device)."""

    model_cls = MLPClassificationModel

    def __init__(self, hidden_layers=(10,), max_iter: int = 200,
                 step_size: float = 0.05, seed: int = 42, **kw):
        super().__init__(hidden_layers=tuple(hidden_layers),
                         max_iter=max_iter, step_size=step_size, seed=seed,
                         **kw)

    def init_params(self, d: int, n_classes: int, device):
        """[(W [d_i, d_i+1], zeros)] of the layer sizes d → hidden → C."""
        sizes = [d] + list(self.get("hidden_layers", (10,))) + [n_classes]
        gen = torch.Generator().manual_seed(int(self.get("seed", 42)))
        return [((torch.randn((sizes[i], sizes[i + 1]), generator=gen)
                  * (2.0 / sizes[i]) ** 0.5).to(device),
                 torch.zeros(sizes[i + 1], device=device))
                for i in range(len(sizes) - 1)]

    def fit_arrays(self, X, y, sample_weight=None,
                   device=None) -> Dict[str, Any]:
        dev = tensor_device(X, device)
        Xd = _dense(X, dev, "OpMultilayerPerceptronClassifier")
        C = _n_classes(y)
        w = (torch.ones(Xd.shape[0], dtype=torch.float32, device=dev)
             if sample_weight is None else to_device_f32(sample_weight, dev))
        params = mlp_train(self.init_params(Xd.shape[1], C, dev), Xd,
                           to_device_f32(y, dev), w,
                           int(self.get("max_iter", 200)),
                           float(self.get("step_size", 0.05)))
        fitted: Dict[str, Any] = {"kind": "mlp", "n_layers": len(params),
                                  "n_classes": C}
        for i, (W, b) in enumerate(params):
            fitted[f"W{i}"], fitted[f"b{i}"] = W, b
        return fitted
