"""Evaluators (port of the binary, regression and multiclass families of
``transmogrifai_tpu/evaluators.py``; reference: OpEvaluatorBase.scala:113,
OpBinaryClassificationEvaluator.scala:67-185, OpRegressionEvaluator.scala,
OpMultiClassificationEvaluator.scala, Evaluators.scala:40).

The port scores on the device: a model's ``device_scores`` output and a
0/1 row mask go in, and the metric panel comes out of masked reductions
(``metrics_device``); the multiclass evaluator also keeps the JAX
package's host form (``evaluate_all``, numpy).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .metrics_device import (BINARY_CONF_METRICS, MULTI_METRICS,
                             masked_aupr, masked_aupr_fold_grid,
                             masked_aupr_grid, masked_auroc,
                             masked_auroc_fold_grid, masked_auroc_grid,
                             masked_binary_confusion,
                             masked_binary_metric_fold_grid,
                             masked_binary_metric_grid,
                             masked_multiclass_confusion,
                             masked_multiclass_metric_fold_grid,
                             masked_multiclass_metric_grid,
                             masked_reg_errors, masked_reg_metric_fold_grid,
                             masked_reg_metric_grid,
                             masked_threshold_confusion)

DEFAULT_THRESHOLDS = np.linspace(0.0, 1.0, 101)


@dataclass
class EvaluationMetrics:
    metrics: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return dict(self.metrics)


class OpEvaluatorBase:
    """≙ OpEvaluatorBase: ``default_metric`` is the scalar the ModelSelector
    ranks by, ``is_larger_better`` its direction."""

    name: str = "evaluator"
    default_metric: str = ""
    is_larger_better: bool = True
    # what the CV panels give ``evaluate_masked_grid``: score columns, or
    # integer class predictions (the multiclass evaluator)
    grid_panel_input: str = "scores"

    def __init__(self, default_metric: Optional[str] = None,
                 is_larger_better: Optional[bool] = None):
        if default_metric is not None:
            self.default_metric = default_metric
        if is_larger_better is not None:
            self.is_larger_better = is_larger_better

    def evaluate_masked_grid(self, y, S, W) -> torch.Tensor:
        raise NotImplementedError

    def evaluate_masked(self, y, device_out: Dict[str, Any], w) -> float:
        """The default metric of one model's ``device_scores`` output over
        the row mask ``w`` (the per-candidate CV path of a family with no
        batched panel, ≙ ``device_metric``, tuning.py:910-922): its panel
        column through ``evaluate_masked_grid``."""
        return float(self.evaluate_masked_grid(
            y, self.panel_column(device_out)[:, None], w)[0])

    @staticmethod
    def panel_column(device_out: Dict[str, Any]) -> torch.Tensor:
        """The column a panel ranks: ``scores``, else probability[:, 1],
        else the prediction (a regressor's)."""
        if "scores" in device_out:
            return device_out["scores"]
        if "probability" in device_out:
            return device_out["probability"][:, 1]
        return device_out["prediction"]


class OpBinaryClassificationEvaluator(OpEvaluatorBase):
    """≙ OpBinaryClassificationEvaluator.scala:67-185."""

    name = "binEval"
    default_metric = "AuPR"

    def __init__(self, thresholds: Optional[np.ndarray] = None, **kw):
        super().__init__(**kw)
        self.thresholds = (DEFAULT_THRESHOLDS if thresholds is None
                           else np.asarray(thresholds))

    @property
    def grid_panel_input(self) -> str:
        """AuROC and AuPR rank score columns; Precision, Recall, F1 and
        Error count each candidate's hard ``prediction`` (≙ the JAX
        evaluator's ``evaluate_masked``, evaluators.py:240-261)."""
        return ("predictions" if self.default_metric in BINARY_CONF_METRICS
                else "scores")

    def _ranker(self, fold_grid: bool = False):
        m = self.default_metric
        if m in BINARY_CONF_METRICS:
            return functools.partial(
                masked_binary_metric_fold_grid if fold_grid
                else masked_binary_metric_grid, metric=m)
        if m not in ("AuROC", "AuPR"):
            raise NotImplementedError(
                f"binary CV metric {m!r}: the port ranks candidates by "
                "AuROC, AuPR, Precision, Recall, F1 or Error")
        if fold_grid:
            return masked_auroc_fold_grid if m == "AuROC" else masked_aupr_fold_grid
        return masked_auroc_grid if m == "AuROC" else masked_aupr_grid

    def evaluate_masked_grid(self, y, S, W) -> torch.Tensor:
        """Default metric of K columns S [N, K] over the mask W ([N] shared
        or [K, N]) → [K]: score columns, or hard 0/1 predictions for the
        confusion metrics (``grid_panel_input``)."""
        return self._ranker()(y, S, W)

    def evaluate_masked_fold_grid(self, y, S, W) -> torch.Tensor:
        """Default metric of the (fold × grid) panel S [N, F, G] with fold
        validation masks W [F, N] → [F, G]."""
        return self._ranker(fold_grid=True)(y, S, W)

    def evaluate_masked(self, y, device_out: Dict[str, Any], w) -> float:
        """The default metric of one model's ``device_scores`` output: a
        confusion metric counts its ``prediction`` (a logistic or SVC
        model's margin > 0, a forest's argmax), AuROC and AuPR rank its
        score column."""
        if self.default_metric in BINARY_CONF_METRICS:
            return float(self.evaluate_masked_grid(
                y, device_out["prediction"][:, None], w)[0])
        return super().evaluate_masked(y, device_out, w)

    def evaluate_all_device(self, y, device_out: Dict[str, Any],
                            w) -> EvaluationMetrics:
        """The full metric panel from a model's ``device_scores`` output:
        confusion counts, AuROC, AuPR and the per-threshold counts."""
        s = device_out.get("scores")
        if s is None:      # a Prediction column: probability, else margin
            s = device_out.get("probability", device_out.get("rawPrediction"))
            s = s[:, 1]
        pred = device_out["prediction"]
        conf = masked_binary_confusion(y, pred, w)
        order = np.argsort(np.asarray(self.thresholds, np.float64),
                           kind="stable")
        thr = masked_threshold_confusion(
            y, s, w, torch.as_tensor(np.asarray(self.thresholds)[order],
                                     dtype=torch.float32, device=y.device))
        scal = torch.stack([masked_auroc(y, s, w), masked_aupr(y, s, w)])
        tp, fp, tn, fn = (float(v) for v in conf.cpu().numpy())
        au_roc, au_pr = (float(v) for v in scal.cpu().numpy())
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        ttp, tfp, ttn, tfn = thr.cpu().numpy().astype(np.float64)[:, inv]
        precision = tp / (tp + fp) if tp + fp > 0 else 0.0
        recall = tp / (tp + fn) if tp + fn > 0 else 0.0
        n = max(tp + fp + tn + fn, 1.0)
        return EvaluationMetrics({
            "TP": tp, "TN": tn, "FP": fp, "FN": fn,
            "Precision": precision, "Recall": recall,
            "F1": (2 * precision * recall / (precision + recall)
                   if precision + recall > 0 else 0.0),
            "Error": (fp + fn) / n, "AuROC": au_roc, "AuPR": au_pr,
            "thresholds": np.asarray(self.thresholds).tolist(),
            "precisionByThreshold": (ttp / np.maximum(ttp + tfp, 1.0)).tolist(),
            "recallByThreshold": (ttp / np.maximum(ttp + tfn, 1.0)).tolist(),
            "truePositivesByThreshold": ttp.tolist(),
            "falsePositivesByThreshold": tfp.tolist(),
            "trueNegativesByThreshold": ttn.tolist(),
            "falseNegativesByThreshold": tfn.tolist()})


class OpRegressionEvaluator(OpEvaluatorBase):
    """≙ OpRegressionEvaluator (evaluators.py:476-586): RMSE, MSE, MAE, R²
    and the signed-error histogram."""

    name = "regEval"
    default_metric = "RootMeanSquaredError"
    is_larger_better = False

    def __init__(self, hist_bins: int = 20, **kw):
        super().__init__(**kw)
        self.hist_bins = hist_bins

    def evaluate_masked_grid(self, y, S, W) -> torch.Tensor:
        """Default metric of K prediction columns S [N, K] over the mask W
        ([N] shared or [K, N]) → [K]."""
        return masked_reg_metric_grid(y, S, W, self.default_metric)

    def evaluate_masked_fold_grid(self, y, S, W) -> torch.Tensor:
        """Default metric of the (fold × grid) prediction panel S [N, F, G]
        with fold validation masks W [F, N] → [F, G]."""
        return masked_reg_metric_fold_grid(y, S, W, self.default_metric)

    def evaluate_all_device(self, y, device_out: Dict[str, Any],
                            w) -> EvaluationMetrics:
        """The full panel from a model's ``device_scores`` output: the
        errors, R² against the masked labels' variance, and a ``hist_bins``
        histogram of the signed errors (prediction - label) over their
        masked range, each error in the bin ``searchsorted(inner edges,
        side="right")`` gives it (edges in f32, as the JAX package
        compares them)."""
        pred = device_out["prediction"]
        mse, mae = (float(v) for v in
                    masked_reg_errors(y, pred, w).cpu().numpy())
        wsum = torch.clamp(torch.sum(w), min=1e-12)
        ym = torch.sum(w * y) / wsum
        var = float(torch.sum(w * (y - ym) ** 2) / wsum)
        err = pred - y
        lo = float(torch.min(torch.where(w > 0, err, float("inf"))))
        hi = float(torch.max(torch.where(w > 0, err, float("-inf"))))
        edges = np.linspace(lo, hi if hi > lo else lo + 1.0,
                            self.hist_bins + 1)
        inner = torch.as_tensor(edges[1:-1], dtype=torch.float32,
                                device=y.device)
        idx = torch.clamp(torch.bucketize(err, inner, right=True), 0,
                          self.hist_bins - 1)
        counts = torch.bincount(idx, weights=w, minlength=self.hist_bins)
        return EvaluationMetrics({
            "RootMeanSquaredError": float(np.sqrt(mse)),
            "MeanSquaredError": mse,
            "MeanAbsoluteError": mae,
            "R2": 1.0 - mse / var if var > 0 else 0.0,
            "SignedPercentageErrorHistogram": {
                "counts": [int(c) for c in counts.cpu().numpy()],
                "bins": edges.tolist()}})


class OpMultiClassificationEvaluator(OpEvaluatorBase):
    """≙ OpMultiClassificationEvaluator (evaluators.py:334-473): weighted
    precision / recall / F1 / error from the confusion matrix, and the
    top-N correctness by bin of the top probability (≙
    calculateThresholdMetrics).  The CV panels take integer predictions;
    C = max(label, prediction) + 1 from the data, so a class no candidate
    predicts still counts in the support."""

    name = "multiEval"
    default_metric = "F1"
    grid_panel_input = "predictions"

    def __init__(self, top_ns: Sequence[int] = (1, 3), n_bins: int = 10,
                 **kw):
        super().__init__(**kw)
        self.top_ns = tuple(top_ns)
        self.n_bins = n_bins

    def _metric(self) -> str:
        if self.default_metric not in MULTI_METRICS:
            raise NotImplementedError(
                f"multiclass CV metric {self.default_metric!r}: the port "
                f"ranks by one of {MULTI_METRICS}")
        return self.default_metric

    @staticmethod
    def _conf_panel(conf: np.ndarray) -> Dict[str, Any]:
        """Weighted precision / recall / F1 / error from a [C, C] confusion
        matrix in f64 (the host and device paths share it)."""
        C = conf.shape[0]
        support = conf.sum(axis=1)
        tp = np.diag(conf)
        pred_count = conf.sum(axis=0)
        prec_c = np.divide(tp, pred_count, out=np.zeros(C),
                           where=pred_count > 0)
        rec_c = np.divide(tp, support, out=np.zeros(C), where=support > 0)
        f1_c = np.divide(2 * prec_c * rec_c, prec_c + rec_c,
                         out=np.zeros(C), where=(prec_c + rec_c) > 0)
        wts = support / max(support.sum(), 1.0)
        return {
            "Precision": float(wts @ prec_c), "Recall": float(wts @ rec_c),
            "F1": float(wts @ f1_c),
            "Error": 1.0 - float(tp.sum() / max(support.sum(), 1.0)),
            "confusionMatrix": conf.tolist(),
        }

    def evaluate_all(self, y, pred: Dict[str, Any]) -> EvaluationMetrics:
        """The panel on the host from label and prediction arrays (numpy or
        tensors), unweighted (≙ ``evaluate_all``, evaluators.py:367-394)."""
        y = np.asarray(_host(y), dtype=np.int64)
        yhat = np.asarray(_host(pred["prediction"]), dtype=np.int64)
        C = int(max(y.max(initial=0), yhat.max(initial=0))) + 1
        conf = np.zeros((C, C), dtype=np.float64)
        np.add.at(conf, (y, yhat), 1.0)
        m: Dict[str, Any] = self._conf_panel(conf)
        prob = pred.get("probability")
        if prob is not None:
            prob = np.asarray(_host(prob), dtype=np.float64)
            order = np.argsort(-prob, axis=1)
            maxprob = prob[np.arange(len(y)), order[:, 0]]
            bins = np.clip((maxprob * self.n_bins).astype(int), 0,
                           self.n_bins - 1)
            topns = {}
            for n in self.top_ns:
                correct = (order[:, :n] == y[:, None]).any(axis=1)
                counts = np.zeros(self.n_bins)
                corr = np.zeros(self.n_bins)
                np.add.at(counts, bins, 1.0)
                np.add.at(corr, bins, correct.astype(np.float64))
                topns[str(n)] = {"topNCorrectByBin": corr.tolist(),
                                 "topNCountByBin": counts.tolist()}
            m["ThresholdMetrics"] = {"topNs": list(self.top_ns),
                                     "nBins": self.n_bins, "byTopN": topns}
        return EvaluationMetrics(m)

    @staticmethod
    def _n_classes(y, pred) -> int:
        return int(torch.maximum(torch.max(y), torch.max(pred))) + 1

    def evaluate_masked(self, y, device_out: Dict[str, Any], w) -> float:
        """The default metric of one model's predictions over the row mask
        ``w``: the f32 confusion matrix, the panel in f64 (≙
        ``evaluate_masked``, evaluators.py:403-416)."""
        metric = self._metric()
        pred = device_out["prediction"]
        conf = masked_multiclass_confusion(
            y, pred, w, n_classes=self._n_classes(y, pred))
        return self._conf_panel(conf.cpu().numpy().astype(np.float64))[
            metric]

    def evaluate_masked_grid(self, y, S, W) -> torch.Tensor:
        """Default metric of K integer prediction columns S [N, K] over the
        mask W ([N] shared or [K, N]) → [K] f32."""
        return masked_multiclass_metric_grid(
            y, S, W, n_classes=self._n_classes(y, S), metric=self._metric())

    def evaluate_masked_fold_grid(self, y, S, W) -> torch.Tensor:
        """Default metric of the (fold × grid) prediction panel S [N, F, G]
        with fold validation masks W [F, N] → [F, G] f32."""
        return masked_multiclass_metric_fold_grid(
            y, S, W, n_classes=self._n_classes(y, S), metric=self._metric())

    def evaluate_all_device(self, y, device_out: Dict[str, Any],
                            w) -> Optional[EvaluationMetrics]:
        """The full panel from a model's ``device_scores`` output over the
        row weights ``w`` (≙ ``evaluate_all_device``, evaluators.py:
        431-473): the f32 confusion matrix, and the top-N panel from a
        STABLE descending sort of the probabilities (ties, common in forest
        probabilities, keep the lower class first, as ``jnp.argsort``)
        binned by the top probability with weighted counts.  None for no
        rows."""
        pred = device_out["prediction"]
        if not len(y):
            return None
        conf = masked_multiclass_confusion(
            y, pred, w, n_classes=self._n_classes(y, pred))
        m: Dict[str, Any] = self._conf_panel(
            conf.cpu().numpy().astype(np.float64))
        prob = device_out.get("probability")
        if prob is not None and prob.ndim == 2:
            order = torch.argsort(-prob, dim=1, stable=True)
            maxprob = torch.max(prob, dim=1).values
            bins = torch.clamp((maxprob * self.n_bins).to(torch.int32), 0,
                               self.n_bins - 1)
            yi = y.to(torch.int64)
            counts = torch.bincount(bins, weights=w, minlength=self.n_bins)
            topns = {}
            for n in self.top_ns:
                correct = (order[:, :n] == yi[:, None]).any(dim=1)
                corr = torch.bincount(bins, weights=w * correct.to(w.dtype),
                                      minlength=self.n_bins)
                topns[str(n)] = {
                    "topNCorrectByBin": corr.cpu().double().tolist(),
                    "topNCountByBin": counts.cpu().double().tolist()}
            m["ThresholdMetrics"] = {"topNs": list(self.top_ns),
                                     "nBins": self.n_bins, "byTopN": topns}
        return EvaluationMetrics(m)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


class Evaluators:
    """≙ Evaluators.scala:40 factory (binary, regression and multiclass
    families)."""

    class BinaryClassification:
        @staticmethod
        def auPR() -> OpBinaryClassificationEvaluator:
            return OpBinaryClassificationEvaluator(default_metric="AuPR")

        @staticmethod
        def auROC() -> OpBinaryClassificationEvaluator:
            return OpBinaryClassificationEvaluator(default_metric="AuROC")

        @staticmethod
        def precision() -> OpBinaryClassificationEvaluator:
            return OpBinaryClassificationEvaluator(default_metric="Precision")

        @staticmethod
        def recall() -> OpBinaryClassificationEvaluator:
            return OpBinaryClassificationEvaluator(default_metric="Recall")

        @staticmethod
        def f1() -> OpBinaryClassificationEvaluator:
            return OpBinaryClassificationEvaluator(default_metric="F1")

        @staticmethod
        def error() -> OpBinaryClassificationEvaluator:
            return OpBinaryClassificationEvaluator(
                default_metric="Error", is_larger_better=False)

    class MultiClassification:
        @staticmethod
        def precision() -> OpMultiClassificationEvaluator:
            return OpMultiClassificationEvaluator(default_metric="Precision")

        @staticmethod
        def recall() -> OpMultiClassificationEvaluator:
            return OpMultiClassificationEvaluator(default_metric="Recall")

        @staticmethod
        def f1() -> OpMultiClassificationEvaluator:
            return OpMultiClassificationEvaluator(default_metric="F1")

        @staticmethod
        def error() -> OpMultiClassificationEvaluator:
            return OpMultiClassificationEvaluator(
                default_metric="Error", is_larger_better=False)

    class Regression:
        @staticmethod
        def rmse() -> OpRegressionEvaluator:
            return OpRegressionEvaluator(default_metric="RootMeanSquaredError")

        @staticmethod
        def mse() -> OpRegressionEvaluator:
            return OpRegressionEvaluator(default_metric="MeanSquaredError")

        @staticmethod
        def mae() -> OpRegressionEvaluator:
            return OpRegressionEvaluator(default_metric="MeanAbsoluteError")

        @staticmethod
        def r2() -> OpRegressionEvaluator:
            return OpRegressionEvaluator(default_metric="R2",
                                         is_larger_better=True)
