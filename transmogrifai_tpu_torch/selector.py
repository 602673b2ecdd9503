"""ModelSelector — cross-validated model selection (port of
``transmogrifai_tpu/selector.py``; reference: ModelSelector.scala:114,143,
BinaryClassificationModelSelector.scala:60-133).

``fit``: run the validator over every (model × grid-point), refit the winner
on the full train rows through the same batched grid program (one fold, one
lane), evaluate every evaluator on the training rows, and return a
``SelectedModel`` carrying the ``ModelSelectorSummary``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch

from .columns import ColumnBatch
from .evaluators import (Evaluators, OpBinaryClassificationEvaluator,
                         OpEvaluatorBase)
from .models.base import PredictionModel, extract_xy
from .stages.base import Estimator
from .tuning import (ModelCandidate, OpCrossValidation, OpValidator,
                     device_wall_clock)
from .types import OPVector, Prediction, RealNN

__all__ = ["ModelCandidate", "grid", "ModelSelector", "SelectedModel",
           "BinaryClassificationModelSelector", "ModelSelectorSummary"]


def grid(**param_lists) -> List[Dict[str, Any]]:
    """Cartesian product of param lists (≙ ParamGridBuilder)."""
    keys = list(param_lists)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(param_lists[k] for k in keys))]


@dataclass
class ModelEvaluation:
    model_name: str
    params: Dict[str, Any]
    metric_values: Dict[str, float]
    raced_out: bool = False


@dataclass
class ModelSelectorSummary:
    """≙ ModelSelectorSummary (selector/ModelSelectorSummary.scala)."""

    validation_type: str = ""
    validation_parameters: Dict[str, Any] = field(default_factory=dict)
    evaluation_metric: str = ""
    problem_type: str = ""
    best_model_uid: str = ""
    best_model_name: str = ""
    best_model_type: str = ""
    validation_results: List[ModelEvaluation] = field(default_factory=list)
    train_evaluation: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "validationType": self.validation_type,
            "validationParameters": self.validation_parameters,
            "evaluationMetric": self.evaluation_metric,
            "problemType": self.problem_type,
            "bestModelUID": self.best_model_uid,
            "bestModelName": self.best_model_name,
            "bestModelType": self.best_model_type,
            "validationResults": [
                {"modelName": r.model_name, "modelParameters": r.params,
                 "metricValues": r.metric_values,
                 **({"racedOut": True} if r.raced_out else {})}
                for r in self.validation_results],
            "trainEvaluation": self.train_evaluation,
        }


class SelectedModel(PredictionModel):
    """The winning fitted model (≙ SelectedModel, ModelSelector.scala:207);
    delegates scoring to the wrapped best model and carries the summary."""

    def __init__(self, **params):
        self._best_model: Optional[PredictionModel] = params.pop("best_model", None)
        super().__init__(**params)
        self.summary: Optional[ModelSelectorSummary] = None
        # wall seconds of the fit: each candidate family's CV block, the
        # winner's refit and the train evaluation
        self.selector_seconds: Dict[str, float] = {}

    @property
    def best_model(self) -> PredictionModel:
        return self._best_model

    def device_scores(self, X, full: bool = False):
        return self._best_model.device_scores(X, full=full)


class ModelSelector(Estimator):
    """≙ ModelSelector.scala:114-191."""

    in_kinds = (RealNN, OPVector)
    out_kind = Prediction
    allow_label_as_input = True
    problem_type = "Unknown"

    def __init__(self, validator: OpValidator, models: Sequence[ModelCandidate],
                 evaluators: Sequence[OpEvaluatorBase] = (), **kw):
        super().__init__(**kw)
        self.validator = validator
        self.models = list(models)
        self.evaluators = list(evaluators)

    def output_name(self) -> str:
        return f"{self.input_features[0].name}_prediction_{self.uid[-6:]}"

    def fit(self, batch: ColumnBatch) -> SelectedModel:
        label_f, feats_f = self.input_features
        result = self.validator.validate(self.models, batch, label_f.name,
                                         feats_f.name)
        best_est = result.best.estimator
        X, y = extract_xy(batch, label_f, feats_f)
        # the full-data refit runs the family's batched grid program with one
        # all-ones fold and the winner's params, the program the JAX package
        # reuses for its refit
        t0 = device_wall_clock(X.device)
        ones = torch.ones((1, X.shape[0]), dtype=torch.float32,
                          device=X.device)
        fitted = best_est.fit_arrays_grid(X, y, ones,
                                          [dict(result.best_params)])[0][0]
        best_model = best_est.model_cls(fitted=fitted, **best_est._params)
        t1 = device_wall_clock(X.device)

        y_dev = torch.as_tensor(y, device=X.device)
        dev_out = best_model.device_scores(X, full=True)
        train_eval = {ev.name: ev.evaluate_all_device(
            y_dev, dev_out, torch.ones_like(y_dev)).to_json()
            for ev in self.evaluators}
        t2 = device_wall_clock(X.device)

        v = self.validator
        summary = ModelSelectorSummary(
            validation_type=result.validation_type,
            validation_parameters={
                "seed": v.seed, "stratify": v.stratify,
                "numFolds": getattr(v, "num_folds", None),
                "racing": {"enabled": v.racing, "eta": v.racing_eta,
                           "minSurvivors": v.racing_min_survivors}},
            evaluation_metric=result.metric_name,
            problem_type=self.problem_type,
            best_model_uid=best_est.uid,
            best_model_name=result.best.model_name,
            best_model_type=type(best_est).__name__,
            validation_results=[
                ModelEvaluation(r.model_name, r.params,
                                {result.metric_name: r.mean_metric},
                                raced_out=r.raced_out)
                for r in result.all_results],
            train_evaluation=train_eval)
        model = SelectedModel(best_model=best_model, **self._params)
        model.summary = summary
        model.selector_seconds = {**result.family_seconds, "refit": t1 - t0,
                                  "train_evaluation": t2 - t1}
        model.metadata["summary"] = summary.to_json()
        model.fitted = {"best_model_class": type(best_model).__name__,
                        "best_metric": float(result.best_metric)}
        return self._finalize_model(model)


class BinaryClassificationModelSelector(ModelSelector):
    """≙ BinaryClassificationModelSelector.scala:60-133: 3-fold CV ranked by
    AuPR by default, over the model candidates given."""

    problem_type = "BinaryClassification"

    def __init__(self, num_folds: int = 3, seed: int = 42,
                 validation_metric: Optional[OpEvaluatorBase] = None,
                 models: Sequence[ModelCandidate] = (),
                 stratify: bool = False, **kw):
        if not models:
            raise ValueError(
                "BinaryClassificationModelSelector: pass models=[...] — the "
                "reference's default grid includes OpLinearSVC and trees "
                "of depth up to 12 (the unrolled fit), which the port's next "
                "slice brings; LR, GBT, random forests and decision trees run "
                "now")
        ev = validation_metric or Evaluators.BinaryClassification.auPR()
        validator = OpCrossValidation(num_folds, ev, seed, stratify)
        super().__init__(validator, models, [OpBinaryClassificationEvaluator()],
                         **kw)

