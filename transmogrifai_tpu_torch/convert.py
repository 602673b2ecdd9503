"""Build the port's fitted stages from a fitted model's parameters.

The input is plain data — numpy arrays, numbers, strings — never an object of
another framework, so a model fitted by the JAX package can be scored by the
port once its parameters are exported (one dict per fitted stage, in DAG
order).  The dicts this slice reads, by the fitted stage's class name:

* ``RealNNVectorizerModel`` / ``VectorsCombiner``: nothing;
* ``RealVectorizerModel``: ``fills`` [F];
* ``SanityCheckerModel``: ``indices_to_keep`` [D'] and optionally ``summary``;
* ``SelectedModel``: ``model`` = ``"LinearPredictionModel"`` (``coef`` [D],
  ``intercept`` [1], ``kind`` "binary" for logistic regression, "svc" for
  a linear SVC or "regression" for a linear regression; or ``coef`` [D, C],
  ``intercept`` [C], ``kind`` "multinomial"), ``"GLMPredictionModel"``
  (``coef`` [D], ``intercept`` [1], ``kind`` "glm", ``family`` gaussian,
  binomial, poisson or gamma), ``"NaiveBayesModel"``
  (``log_prior`` [C], ``log_prob`` [C, D]),
  ``"MLPClassificationModel"`` (``n_layers``, ``W{i}`` [d_i, d_i+1],
  ``b{i}``) or
  ``"TreeEnsembleModel"`` — a GBT (``kind`` "gbt": ``task``, ``feature``,
  ``threshold``, ``is_leaf`` [R, T], ``leaf`` [R, T, 1], ``eta``, ``base``,
  ``max_depth``) or a forest (``kind`` "forest": ``task``, ``n_classes``,
  ``feature``, ``threshold``, ``is_leaf`` [R, T], ``leaf`` [R, T, C] or,
  for a regressor, [R, T, 1], ``max_depth``) — with those arrays under
  ``fitted``; ``task`` is "classification" (the default) or
  "regression";
* ``RecordInsightsLOCO``: the explained model as ``model`` / ``fitted``
  (the ``SelectedModel`` forms above; the stage keeps its own ``top_k`` and
  ``strategy``);
* ``RecordInsightsCorrModel``: ``corr`` [P, D], ``s1``, ``s2`` [D] and
  ``offset``;
* ``DateToUnitCircleModel`` / ``DateListVectorizerModel``: nothing;
  ``GeolocationVectorizerModel``: ``fills`` [F, 3];
  ``MultiPickListVectorizerModel``: ``top_values`` (feature name → its
  pivot's values, in column order);
* ``DecisionTreeNumericBucketizerModel``: ``splits`` [B + 1] (empty: no
  split); ``DecisionTreeNumericMapBucketizerModel``: ``keys`` and
  ``splits_by_key`` (key → splits); ``PercentileCalibratorModel``:
  ``splits``; ``IsotonicRegressionCalibratorModel``: ``boundaries`` and
  ``predictions``;
* ``NumericBucketizer``, ``ScalerTransformer``, ``DescalerTransformer``,
  ``TimePeriodTransformer``: nothing (their parameters are the stage's
  own).

A ``SanityCheckerModel`` may also carry ``input_vector_meta`` (the JSON of
its input vector's meta), which ``WorkflowModel.summary`` reads for lineage.

Tree arrays are taken as the JAX package writes them in either form of its
tree fit.  Trees deeper than 7 come from ``_fit_tree_unrolled``, whose
nodes below a leaf carry thresholds and leaf values of the rows it routed on
past the leaf; the port's walk stops at the first leaf, as the JAX walk
does, so those nodes are never read.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from .dag import compute_dag
from .device import DeviceLike, resolve_device
from .models.linear import (GLM_FAMILY_LOSS, GLMPredictionModel,
                            LinearPredictionModel, MLPClassificationModel,
                            NaiveBayesModel)
from .models.trees import TreeEnsembleModel
from .ops import bucketizers as bk
from .ops.collections import MultiPickListVectorizer
from .ops.combiner import VectorsCombiner
from .ops.dates import (DateListVectorizer, DateToUnitCircleVectorizer,
                        TimePeriodTransformer)
from .ops.geo import GeolocationVectorizer
from .ops.numeric import RealNNVectorizer, RealVectorizer, RealVectorizerModel
from .preparators.sanity_checker import SanityChecker, SanityCheckerModel
from .record_insights import (RecordInsightsCorr, RecordInsightsCorrModel,
                              RecordInsightsLOCO)
from .selector import ModelSelector, SelectedModel
from .workflow import WorkflowModel

_MODELS = {"LinearPredictionModel": LinearPredictionModel,
           "GLMPredictionModel": GLMPredictionModel,
           "TreeEnsembleModel": TreeEnsembleModel,
           "NaiveBayesModel": NaiveBayesModel,
           "MLPClassificationModel": MLPClassificationModel}


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """A copy (the exporter's arrays may be read-only views)."""
    return torch.tensor(np.asarray(a), device=device, dtype=dtype)


def _model_fitted(name: str, fitted: Dict[str, Any], device) -> Dict[str, Any]:
    """``fitted`` of the model class ``name`` with the arrays its scoring
    reads as tensors on ``device`` (the table above); the rest as given."""
    out = dict(fitted)
    if name in ("LinearPredictionModel", "GLMPredictionModel"):
        out["coef"] = _tensor(fitted["coef"], device, torch.float32)
        out["intercept"] = _tensor(fitted["intercept"], device,
                                   torch.float32).reshape(-1)
        out.setdefault("kind", "glm" if name == "GLMPredictionModel"
                       else "binary")
        if out["kind"] not in ("binary", "svc", "regression", "multinomial",
                               "glm"):
            raise NotImplementedError(
                f"convert: no port model for linear kind {out['kind']!r}")
        if (out["kind"] == "glm"
                and out.setdefault("family", "gaussian") not in
                GLM_FAMILY_LOSS):
            raise NotImplementedError(
                f"convert: no port model for GLM family {out['family']!r}")
    elif name == "TreeEnsembleModel":
        out["feature"] = _tensor(fitted["feature"], device, torch.int32)
        out["threshold"] = _tensor(fitted["threshold"], device, torch.float32)
        out["is_leaf"] = _tensor(fitted["is_leaf"], device, torch.bool)
        leaf = _tensor(fitted["leaf"], device, torch.float32)
        out["leaf"] = leaf if leaf.ndim == 3 else leaf[..., None]
        out["max_depth"] = int(fitted["max_depth"])
        if "feature_gain" in fitted:
            out["feature_gain"] = _tensor(fitted["feature_gain"], device,
                                          torch.float32)
        out.setdefault("kind", "gbt")
        if out["kind"] == "gbt":
            out["eta"] = float(fitted["eta"])
            out["base"] = float(fitted["base"])
        elif out["kind"] != "forest":
            raise NotImplementedError(
                f"convert: no port model for tree kind {out['kind']!r}")
        if out.setdefault("task", "classification") not in (
                "classification", "regression"):
            raise NotImplementedError(
                f"convert: no port model for tree task {out['task']!r}")
    elif name == "NaiveBayesModel":
        out["log_prior"] = _tensor(fitted["log_prior"], device, torch.float32)
        out["log_prob"] = _tensor(fitted["log_prob"], device, torch.float32)
        out["kind"] = "naive_bayes"
    elif name == "MLPClassificationModel":
        out["n_layers"] = int(fitted["n_layers"])
        for i in range(out["n_layers"]):
            out[f"W{i}"] = _tensor(fitted[f"W{i}"], device, torch.float32)
            out[f"b{i}"] = _tensor(fitted[f"b{i}"], device, torch.float32)
        out["kind"] = "mlp"
    else:
        raise NotImplementedError(f"convert: no port model for {name!r}")
    return out


def prediction_model(params: Dict[str, Any], device: torch.device):
    """The port's fitted model of ``params["model"]`` / ``params["fitted"]``
    (a ``SelectedModel``'s winner)."""
    cls = _MODELS.get(params["model"])
    if cls is None:
        raise NotImplementedError(
            f"convert: no port model for {params['model']!r}")
    return cls(fitted=_model_fitted(params["model"], params["fitted"],
                                    device))


def fitted_stage(stage, params: Dict[str, Any], device: torch.device):
    """The port's fitted counterpart of ``stage`` (an unfitted stage of the
    port's feature graph) carrying ``params``."""
    name = params.get("stage")

    def expect(want):
        if name != want:
            raise ValueError(f"convert: {type(stage).__name__} needs "
                             f"{want!r} parameters, got {name!r}")

    if isinstance(stage, (VectorsCombiner, TimePeriodTransformer,
                          bk.NumericBucketizer, bk.ScalerTransformer,
                          bk.DescalerTransformer)):
        expect(type(stage).__name__)
        return stage
    if isinstance(stage, DateToUnitCircleVectorizer):
        expect("DateToUnitCircleModel")
        return stage.fit(None)
    if isinstance(stage, DateListVectorizer):
        expect("DateListVectorizerModel")
        return stage.fit(None)
    if isinstance(stage, GeolocationVectorizer):
        expect("GeolocationVectorizerModel")
        return stage.model(params["fills"])
    if isinstance(stage, MultiPickListVectorizer):
        expect("MultiPickListVectorizerModel")
        return stage.model({k: [str(v) for v in vs]
                            for k, vs in params["top_values"].items()})
    if isinstance(stage, bk.DecisionTreeNumericBucketizer):
        expect("DecisionTreeNumericBucketizerModel")
        splits = np.asarray(params["splits"], np.float64)
        return stage._finalize_model(bk.DecisionTreeNumericBucketizerModel(
            fitted={"should_split": len(splits) > 0, "splits": splits},
            **stage.params))
    if isinstance(stage, bk.DecisionTreeNumericMapBucketizer):
        expect("DecisionTreeNumericMapBucketizerModel")
        return stage._finalize_model(
            bk.DecisionTreeNumericMapBucketizerModel(fitted={
                "keys": [str(k) for k in params["keys"]],
                "splits_by_key": {str(k): np.asarray(v, np.float64)
                                  for k, v in params["splits_by_key"].items()}},
                **stage.params))
    if isinstance(stage, bk.PercentileCalibrator):
        expect("PercentileCalibratorModel")
        splits = np.asarray(params["splits"], np.float64)
        model = bk.PercentileCalibratorModel(
            fitted={"splits": splits, "actual_num_buckets": len(splits)},
            **stage.params)
        model.metadata["origSplits"] = [float(v) for v in splits]
        return stage._finalize_model(model)
    if isinstance(stage, bk.IsotonicRegressionCalibrator):
        expect("IsotonicRegressionCalibratorModel")
        return stage._finalize_model(bk.IsotonicRegressionCalibratorModel(
            fitted={"boundaries": np.asarray(params["boundaries"],
                                             np.float64),
                    "predictions": np.asarray(params["predictions"],
                                              np.float64)},
            **stage.params))
    if isinstance(stage, RealNNVectorizer):
        expect("RealNNVectorizerModel")
        return stage.fit(None)
    if isinstance(stage, RealVectorizer):
        expect("RealVectorizerModel")
        return stage._finalize_model(RealVectorizerModel(fitted={
            "fills": _tensor(params["fills"], device, torch.float32),
            "meta": stage.vector_meta()}, **stage.params))
    if isinstance(stage, SanityChecker):
        expect("SanityCheckerModel")
        model = SanityCheckerModel(fitted={"indices_to_keep": np.asarray(
            params["indices_to_keep"], dtype=np.int64)}, **stage.params)
        model.metadata["summary"] = params.get("summary")
        if params.get("input_vector_meta") is not None:
            model.metadata["input_vector_meta"] = params["input_vector_meta"]
        return stage._finalize_model(model)
    if isinstance(stage, RecordInsightsLOCO):
        expect("RecordInsightsLOCO")
        stage.model = prediction_model(params, device)
        return stage
    if isinstance(stage, RecordInsightsCorr):
        expect("RecordInsightsCorrModel")
        model = RecordInsightsCorrModel(fitted={
            "corr": np.asarray(params["corr"], np.float64),
            "s1": np.asarray(params["s1"], np.float64),
            "s2": np.asarray(params["s2"], np.float64),
            "offset": float(params["offset"])},
            top_k=int(stage.get("top_k", 20)))
        return stage._finalize_model(model)
    if isinstance(stage, ModelSelector):
        expect("SelectedModel")
        best = prediction_model(params, device)
        model = SelectedModel(best_model=best, **stage.params)
        model.fitted = {"best_model_class": params["model"]}
        return stage._finalize_model(model)
    raise NotImplementedError(
        f"convert: no port counterpart for {type(stage).__name__}")


def workflow_model(result_features: Sequence, stage_params: Sequence[Dict[str, Any]],
                   device: DeviceLike = None) -> WorkflowModel:
    """A fitted ``WorkflowModel`` over the port's feature graph
    ``result_features``, with ``stage_params`` given per stage in DAG order
    (``compute_dag`` layering, deepest layer first)."""
    dev = resolve_device(device)
    dag = compute_dag(result_features)
    flat = [s for layer in dag for s in layer]
    if len(flat) != len(stage_params):
        raise ValueError(f"convert: the DAG has {len(flat)} stages, got "
                         f"parameters for {len(stage_params)}")
    it = iter(stage_params)
    fitted_dag = [[fitted_stage(s, next(it), dev) for s in layer]
                  for layer in dag]
    raw = sorted({f.uid: f for rf in result_features for f in rf.all_features()
                  if f.is_raw}.values(), key=lambda f: f.name)
    return WorkflowModel(result_features, fitted_dag, raw, dev)
