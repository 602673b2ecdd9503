"""Evaluators (port of the binary family of ``transmogrifai_tpu/evaluators.py``;
reference: OpEvaluatorBase.scala:113, OpBinaryClassificationEvaluator
.scala:67-185, Evaluators.scala:40).

The port scores on the device only: a model's ``device_scores`` output and a
0/1 row mask go in, and the metric panel comes out of masked reductions
(``metrics_device``).  Multiclass and regression evaluators come with the
slices that port those model families.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from .metrics_device import (masked_aupr, masked_aupr_fold_grid,
                             masked_aupr_grid, masked_auroc,
                             masked_auroc_fold_grid, masked_auroc_grid,
                             masked_binary_confusion,
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

    def __init__(self, default_metric: Optional[str] = None,
                 is_larger_better: Optional[bool] = None):
        if default_metric is not None:
            self.default_metric = default_metric
        if is_larger_better is not None:
            self.is_larger_better = is_larger_better


class OpBinaryClassificationEvaluator(OpEvaluatorBase):
    """≙ OpBinaryClassificationEvaluator.scala:67-185."""

    name = "binEval"
    default_metric = "AuPR"

    def __init__(self, thresholds: Optional[np.ndarray] = None, **kw):
        super().__init__(**kw)
        self.thresholds = (DEFAULT_THRESHOLDS if thresholds is None
                           else np.asarray(thresholds))

    def _ranker(self, fold_grid: bool = False):
        m = self.default_metric
        if m not in ("AuROC", "AuPR"):
            raise NotImplementedError(
                f"binary CV metric {m!r}: the port ranks candidates by AuROC "
                "or AuPR in this slice")
        if fold_grid:
            return masked_auroc_fold_grid if m == "AuROC" else masked_aupr_fold_grid
        return masked_auroc_grid if m == "AuROC" else masked_aupr_grid

    def evaluate_masked_grid(self, y, S, W) -> torch.Tensor:
        """Default metric of K score columns S [N, K] over the mask W
        ([N] shared or [K, N]) → [K]."""
        return self._ranker()(y, S, W)

    def evaluate_masked_fold_grid(self, y, S, W) -> torch.Tensor:
        """Default metric of the (fold × grid) panel S [N, F, G] with fold
        validation masks W [F, N] → [F, G]."""
        return self._ranker(fold_grid=True)(y, S, W)

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


class Evaluators:
    """≙ Evaluators.scala:40 factory (binary family)."""

    class BinaryClassification:
        @staticmethod
        def auPR() -> OpBinaryClassificationEvaluator:
            return OpBinaryClassificationEvaluator(default_metric="AuPR")

        @staticmethod
        def auROC() -> OpBinaryClassificationEvaluator:
            return OpBinaryClassificationEvaluator(default_metric="AuROC")
