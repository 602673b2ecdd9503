"""ModelSelector — cross-validated model selection (port of
``transmogrifai_tpu/selector.py``; reference: ModelSelector.scala:114,143,
BinaryClassificationModelSelector.scala:60-133).

``fit``: reserve the splitter's test holdout (if any), run the validator
over every (model × grid-point), refit the winner on the full train rows
through the same batched grid program (one fold, one lane), evaluate every
evaluator on the training rows (and the holdout), and return a
``SelectedModel`` carrying the ``ModelSelectorSummary``.  With no
``models=`` the binary selector runs the reference's default grid
(``DefaultSelectorParams``): LR x8, RF x18, GBT x18, LinearSVC x4; the
regression selector LinReg x8, RF regressor x18 and GBT regressor x18; the
multiclass selector LR x8 (softmax) and RF x18, with a ``DataCutter``.
The splitter prepares the data before the sweep and before the refit.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch

from .columns import ColumnBatch
from .evaluators import (Evaluators, OpBinaryClassificationEvaluator,
                         OpEvaluatorBase, OpMultiClassificationEvaluator,
                         OpRegressionEvaluator)
from .models.base import PredictionModel, extract_xy
from .resilience import FailureLog
from .stages.base import Estimator
from .tuning import (DataCutter, DataSplitter, ModelCandidate,
                     OpCrossValidation, OpTrainValidationSplit,
                     OpValidator, Splitter,
                     device_wall_clock)
from .types import OPVector, Prediction, RealNN

__all__ = ["ModelCandidate", "grid", "ModelSelector", "SelectedModel",
           "BinaryClassificationModelSelector", "RegressionModelSelector",
           "MultiClassificationModelSelector", "ModelSelectorSummary",
           "DefaultSelectorParams"]


class DefaultSelectorParams:
    """≙ DefaultSelectorParams.scala:36-68 — the pinned reference grid
    values (the JAX package's selector.py:35-56; those the binary and
    regression default grids read)."""

    MAX_DEPTH = [3, 6, 12]
    MAX_BIN = [32]
    MIN_INSTANCES_PER_NODE = [10, 100]
    MIN_INFO_GAIN = [0.001, 0.01, 0.1]
    REGULARIZATION = [0.001, 0.01, 0.1, 0.2]
    MAX_ITER_LIN = [50]
    MAX_ITER_TREE = [20]
    ELASTIC_NET = [0.1, 0.5]
    MAX_TREES = [50]


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
    data_prep_parameters: Dict[str, Any] = field(default_factory=dict)
    data_prep_results: Dict[str, Any] = field(default_factory=dict)
    evaluation_metric: str = ""
    problem_type: str = ""
    best_model_uid: str = ""
    best_model_name: str = ""
    best_model_type: str = ""
    validation_results: List[ModelEvaluation] = field(default_factory=list)
    train_evaluation: Dict[str, Any] = field(default_factory=dict)
    holdout_evaluation: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        return {
            "validationType": self.validation_type,
            "validationParameters": self.validation_parameters,
            "dataPrepParameters": self.data_prep_parameters,
            "dataPrepResults": self.data_prep_results,
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
            "holdoutEvaluation": self.holdout_evaluation,
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
        # candidate families the sweep skipped (≙ model.failure_log)
        self.failure_log: Optional[FailureLog] = None

    @property
    def best_model(self) -> PredictionModel:
        return self._best_model

    def device_scores(self, X, full: bool = False):
        return self._best_model.device_scores(X, full=full)

    # -- the winner saved inline (≙ selector.py:182-217) ----------------------
    def save_extra(self):
        if self._best_model is None:
            return {}, {}
        from .stages.serialization import _is_array
        inner = self._best_model
        j = {"bestModelClass": type(inner).__name__,
             "bestModelParams": {k: v for k, v in inner._params.items()
                                 if isinstance(v, (str, int, float, bool,
                                                   list, tuple))
                                 or v is None},
             "bestFittedJson": {k: v for k, v in inner.fitted.items()
                                if not _is_array(v)}}
        arrays = {f"best/{k}": v for k, v in inner.fitted.items()
                  if _is_array(v)}
        return j, arrays

    def load_extra(self, extra_json, arrays):
        """The winner by class name from ``MODEL_REGISTRY``; a class the
        registry lacks (``GLMPredictionModel``, as in the JAX package)
        raises ``KeyError``."""
        from .models import MODEL_REGISTRY
        cls = MODEL_REGISTRY[extra_json["bestModelClass"]]
        fitted = dict(extra_json.get("bestFittedJson") or {})
        for k, v in arrays.items():
            if k.startswith("best/"):
                fitted[k[len("best/"):]] = v
        self._best_model = cls(fitted=fitted,
                               **(extra_json.get("bestModelParams") or {}))

    def place_fitted(self, device) -> None:
        if self._best_model is not None:
            self._best_model.place_fitted(device)


class ModelSelector(Estimator):
    """≙ ModelSelector.scala:114-191."""

    in_kinds = (RealNN, OPVector)
    out_kind = Prediction
    allow_label_as_input = True
    problem_type = "Unknown"

    def __init__(self, validator: OpValidator, splitter: Optional[Splitter],
                 models: Sequence[ModelCandidate],
                 evaluators: Sequence[OpEvaluatorBase] = (),
                 model_types_to_use: Optional[Sequence[str]] = None, **kw):
        super().__init__(**kw)
        self.validator = validator
        self.splitter = splitter
        self.models = list(models)
        if model_types_to_use is not None:
            # ≙ setModelsToTry / modelTypesToUse (selector.py:236-245)
            wanted = set(model_types_to_use)
            known = {c.model_name for c in self.models}
            unknown = wanted - known
            if unknown:
                raise ValueError(
                    f"model_types_to_use: unknown model types "
                    f"{sorted(unknown)}; available: {sorted(known)}")
            self.models = [c for c in self.models if c.model_name in wanted]
        self.evaluators = list(evaluators)

    def output_name(self) -> str:
        return f"{self.input_features[0].name}_prediction_{self.uid[-6:]}"

    def _evaluate_all(self, model, X, y) -> Dict[str, Any]:
        y_dev = torch.as_tensor(y, device=X.device)
        dev_out = model.device_scores(X, full=True)
        return {ev.name: ev.evaluate_all_device(
            y_dev, dev_out, torch.ones_like(y_dev)).to_json()
            for ev in self.evaluators}

    def fit(self, batch: ColumnBatch, *, in_fold_dag=None, sweep=None,
            log: Optional[FailureLog] = None) -> SelectedModel:
        """≙ selector.py:391-478.  ``in_fold_dag``, ``sweep`` and ``log``
        go to ``OpValidator.validate`` (workflow-CV's 'during' DAG, the
        train's ``SweepCheckpoint`` and ``FailureLog``).  The sweep is
        sealed with the winner (``set_winner``); a failure to persist it is
        recorded "degraded".  A sweep replayed whole still refits its
        winner on all rows, and that is all it runs."""
        label_f, feats_f = self.input_features
        holdout = None
        if self.splitter is not None:
            if self.splitter.reserve_test_fraction > 0:
                batch, holdout = self.splitter.split(batch)
            batch = self.splitter.pre_validation_prepare(batch, label_f.name)
        result = self.validator.validate(self.models, batch, label_f.name,
                                         feats_f.name, splitter=self.splitter,
                                         in_fold_dag=in_fold_dag,
                                         sweep=sweep, log=log)
        train_batch = batch
        if self.splitter is not None:
            # ≙ selector.py:401-404: the refit sees the prepared rows
            train_batch = self.splitter.validation_prepare(batch,
                                                           label_f.name)
        best_est = result.best.estimator
        X, y = extract_xy(train_batch, label_f, feats_f)
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

        train_eval = self._evaluate_all(best_model, X, y)
        t2 = device_wall_clock(X.device)
        holdout_eval = None
        if holdout is not None and len(holdout):
            holdout_eval = self._evaluate_all(
                best_model, *extract_xy(holdout, label_f, feats_f))

        v = self.validator
        summary = ModelSelectorSummary(
            validation_type=result.validation_type,
            validation_parameters={
                "seed": v.seed, "stratify": v.stratify,
                # the families fit one after another: no thread pool
                "parallelism": 1,
                **({"numFolds": v.num_folds}
                   if isinstance(v, OpCrossValidation) else
                   {"trainRatio": v.train_ratio}
                   if isinstance(v, OpTrainValidationSplit) else {}),
                "racing": {"enabled": v.racing, "eta": v.racing_eta,
                           "minSurvivors": v.racing_min_survivors}},
            # the splitter's settings and what it prepared (≙
            # selector.py:438-447): a DataCutter's labels kept and dropped
            data_prep_parameters=(
                {} if self.splitter is None else {
                    k: v for k, v in vars(self.splitter).items()
                    if isinstance(v, (int, float, str, bool))}),
            data_prep_results=(
                {} if self.splitter is None or self.splitter.summary is None
                else self.splitter.summary.info),
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
            train_evaluation=train_eval, holdout_evaluation=holdout_eval)
        model = SelectedModel(best_model=best_model, **self._params)
        model.summary = summary
        model.selector_seconds = {**result.family_seconds, "refit": t1 - t0,
                                  "train_evaluation": t2 - t1}
        model.failure_log = result.failure_log
        model.metadata["summary"] = summary.to_json()
        model.fitted = {"best_model_class": type(best_model).__name__,
                        "best_metric": float(result.best_metric)}
        if sweep is not None:
            try:
                sweep.set_winner(result.best.model_name, result.best_params,
                                 float(result.best_metric))
            except Exception as e:  # noqa: BLE001 — durability only
                result.failure_log.record(
                    "selector", "degraded", e, point="checkpoint.save",
                    fallback="winner not persisted")
        return self._finalize_model(model)


# --------------------------------------------------------------------------
# the reference's default binary grid (≙ selector.py:486-520)
# --------------------------------------------------------------------------

def _lr_candidates(p=DefaultSelectorParams) -> ModelCandidate:
    from .models.linear import OpLogisticRegression
    return ModelCandidate(
        OpLogisticRegression(),
        grid(reg_param=p.REGULARIZATION, elastic_net_param=p.ELASTIC_NET,
             max_iter=p.MAX_ITER_LIN),
        "OpLogisticRegression")


def _rf_classifier(p=DefaultSelectorParams) -> ModelCandidate:
    from .models.trees import OpRandomForestClassifier
    return ModelCandidate(
        OpRandomForestClassifier(),
        grid(max_depth=p.MAX_DEPTH,
             min_instances_per_node=p.MIN_INSTANCES_PER_NODE,
             min_info_gain=p.MIN_INFO_GAIN, num_trees=p.MAX_TREES,
             max_bins=p.MAX_BIN),
        "OpRandomForestClassifier")


def _gbt_classifier(p=DefaultSelectorParams) -> ModelCandidate:
    from .models.trees import OpGBTClassifier
    return ModelCandidate(
        OpGBTClassifier(),
        grid(max_depth=p.MAX_DEPTH,
             min_instances_per_node=p.MIN_INSTANCES_PER_NODE,
             min_info_gain=p.MIN_INFO_GAIN, max_iter=p.MAX_ITER_TREE,
             max_bins=p.MAX_BIN),
        "OpGBTClassifier")


def _compact_models(linear_cls, forest_cls) -> List[ModelCandidate]:
    """Fast starter grid (≙ ``_compact_models``, selector.py:551-562): a
    linear ``reg_param`` sweep and one 20-tree depth-6 forest."""
    return [ModelCandidate(linear_cls(), grid(reg_param=[0.01, 0.1]),
                           linear_cls.__name__),
            ModelCandidate(forest_cls(), grid(num_trees=[20], max_depth=[6]),
                           forest_cls.__name__)]


def _svc_candidates(p=DefaultSelectorParams) -> ModelCandidate:
    from .models.linear import OpLinearSVC
    return ModelCandidate(
        OpLinearSVC(), grid(reg_param=p.REGULARIZATION,
                            max_iter=p.MAX_ITER_LIN), "OpLinearSVC")


class BinaryClassificationModelSelector(ModelSelector):
    """≙ BinaryClassificationModelSelector.scala:60-133: 3-fold CV ranked by
    AuPR by default and a ``DataSplitter(seed)``; with no ``models`` the
    reference's default candidates LR, RF, GBT and LinearSVC
    (selector.py:565-587)."""

    problem_type = "BinaryClassification"

    def __init__(self, num_folds: int = 3, seed: int = 42,
                 validation_metric: Optional[OpEvaluatorBase] = None,
                 splitter: Optional[Splitter] = None,
                 models: Optional[Sequence[ModelCandidate]] = None,
                 stratify: bool = False,
                 use_train_validation_split: bool = False,
                 train_ratio: float = 0.75, **kw):
        ev = validation_metric or Evaluators.BinaryClassification.auPR()
        validator = (OpTrainValidationSplit(train_ratio, ev, seed, stratify)
                     if use_train_validation_split
                     else OpCrossValidation(num_folds, ev, seed, stratify))
        if models is None:
            models = [_lr_candidates(), _rf_classifier(), _gbt_classifier(),
                      _svc_candidates()]
        super().__init__(validator,
                         splitter if splitter is not None
                         else DataSplitter(seed),
                         models, [OpBinaryClassificationEvaluator()], **kw)

    @staticmethod
    def compact_models() -> List[ModelCandidate]:
        """An LR ``reg_param`` sweep and one 20-tree depth-6 forest."""
        from .models.linear import OpLogisticRegression
        from .models.trees import OpRandomForestClassifier
        return _compact_models(OpLogisticRegression, OpRandomForestClassifier)


# --------------------------------------------------------------------------
# the reference's default regression grid (≙ selector.py:522-549)
# --------------------------------------------------------------------------

def _linreg_candidates(p=DefaultSelectorParams) -> ModelCandidate:
    from .models.linear import OpLinearRegression
    return ModelCandidate(
        OpLinearRegression(),
        grid(reg_param=p.REGULARIZATION, elastic_net_param=p.ELASTIC_NET,
             max_iter=p.MAX_ITER_LIN),
        "OpLinearRegression")


def _rf_regressor(p=DefaultSelectorParams) -> ModelCandidate:
    from .models.trees import OpRandomForestRegressor
    return ModelCandidate(
        OpRandomForestRegressor(),
        grid(max_depth=p.MAX_DEPTH,
             min_instances_per_node=p.MIN_INSTANCES_PER_NODE,
             min_info_gain=p.MIN_INFO_GAIN, num_trees=p.MAX_TREES,
             max_bins=p.MAX_BIN),
        "OpRandomForestRegressor")


def _gbt_regressor(p=DefaultSelectorParams) -> ModelCandidate:
    from .models.trees import OpGBTRegressor
    return ModelCandidate(
        OpGBTRegressor(),
        grid(max_depth=p.MAX_DEPTH,
             min_instances_per_node=p.MIN_INSTANCES_PER_NODE,
             min_info_gain=p.MIN_INFO_GAIN, max_iter=p.MAX_ITER_TREE,
             max_bins=p.MAX_BIN),
        "OpGBTRegressor")


class RegressionModelSelector(ModelSelector):
    """≙ RegressionModelSelector.scala:61 (selector.py:622-646): 3-fold CV
    ranked by RMSE (smaller is better) by default and a
    ``DataSplitter(seed)``; with no ``models`` the reference's default
    candidates LinReg, RF regressor and GBT regressor."""

    problem_type = "Regression"

    def __init__(self, num_folds: int = 3, seed: int = 42,
                 validation_metric: Optional[OpEvaluatorBase] = None,
                 splitter: Optional[Splitter] = None,
                 models: Optional[Sequence[ModelCandidate]] = None, **kw):
        ev = validation_metric or Evaluators.Regression.rmse()
        validator = OpCrossValidation(num_folds, ev, seed, False)
        if models is None:
            models = [_linreg_candidates(), _rf_regressor(),
                      _gbt_regressor()]
        super().__init__(validator,
                         splitter if splitter is not None
                         else DataSplitter(seed),
                         models, [OpRegressionEvaluator()], **kw)

    @staticmethod
    def compact_models() -> List[ModelCandidate]:
        """A ridge ``reg_param`` sweep and one 20-tree depth-6 RF
        regressor."""
        from .models.linear import OpLinearRegression
        from .models.trees import OpRandomForestRegressor
        return _compact_models(OpLinearRegression, OpRandomForestRegressor)


# --------------------------------------------------------------------------
# the reference's default multiclass grid (≙ selector.py:596-620)
# --------------------------------------------------------------------------

class MultiClassificationModelSelector(ModelSelector):
    """≙ MultiClassificationModelSelector (selector.py:596-620): 3-fold CV
    ranked by F1 by default and a ``DataCutter(seed=seed)``; with no
    ``models`` the reference's default candidates LR (softmax for more than
    two classes) and RF."""

    problem_type = "MultiClassification"

    def __init__(self, num_folds: int = 3, seed: int = 42,
                 validation_metric: Optional[OpEvaluatorBase] = None,
                 splitter: Optional[Splitter] = None,
                 models: Optional[Sequence[ModelCandidate]] = None,
                 stratify: bool = False, **kw):
        ev = validation_metric or Evaluators.MultiClassification.f1()
        validator = OpCrossValidation(num_folds, ev, seed, stratify)
        if models is None:
            models = [_lr_candidates(), _rf_classifier()]
        super().__init__(validator,
                         splitter if splitter is not None
                         else DataCutter(seed=seed),
                         models, [OpMultiClassificationEvaluator()], **kw)

    compact_models = staticmethod(
        BinaryClassificationModelSelector.compact_models)
