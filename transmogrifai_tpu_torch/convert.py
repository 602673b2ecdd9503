"""Build the port's fitted stages from a fitted model's parameters.

The input is plain data — numpy arrays, numbers, strings — never an object of
another framework, so a model fitted by the JAX package can be scored by the
port once its parameters are exported (one dict per fitted stage, in DAG
order).  The dicts this slice reads, by the fitted stage's class name:

* ``RealNNVectorizerModel`` / ``VectorsCombiner``: nothing;
* ``RealVectorizerModel``: ``fills`` [F];
* ``SanityCheckerModel``: ``indices_to_keep`` [D'] and optionally ``summary``;
* ``SelectedModel``: ``model`` = ``"LinearPredictionModel"`` (``coef`` [D],
  ``intercept`` [1], ``kind`` "binary" for logistic regression or "svc" for
  a linear SVC) or ``"TreeEnsembleModel"`` — a GBT (``kind`` "gbt":
  ``feature``, ``threshold``, ``is_leaf`` [R, T], ``leaf`` [R, T, 1],
  ``eta``, ``base``, ``max_depth``) or a forest (``kind`` "forest": ``task``,
  ``n_classes``, ``feature``, ``threshold``, ``is_leaf`` [R, T], ``leaf``
  [R, T, C], ``max_depth``) — with those arrays under ``fitted``.

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
from .models.linear import LinearPredictionModel
from .models.trees import TreeEnsembleModel
from .ops.combiner import VectorsCombiner
from .ops.numeric import RealNNVectorizer, RealVectorizer, RealVectorizerModel
from .preparators.sanity_checker import SanityChecker, SanityCheckerModel
from .selector import ModelSelector, SelectedModel
from .workflow import WorkflowModel

_MODELS = {"LinearPredictionModel": LinearPredictionModel,
           "TreeEnsembleModel": TreeEnsembleModel}


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """A copy (the exporter's arrays may be read-only views)."""
    return torch.tensor(np.asarray(a), device=device, dtype=dtype)


def _model_fitted(name: str, fitted: Dict[str, Any], device) -> Dict[str, Any]:
    out = dict(fitted)
    if name == "LinearPredictionModel":
        out["coef"] = _tensor(fitted["coef"], device, torch.float32)
        out["intercept"] = _tensor(fitted["intercept"], device,
                                   torch.float32).reshape(-1)
        out.setdefault("kind", "binary")
        if out["kind"] not in ("binary", "svc"):
            raise NotImplementedError(
                f"convert: no port model for linear kind {out['kind']!r}")
    elif name == "TreeEnsembleModel":
        out["feature"] = _tensor(fitted["feature"], device, torch.int32)
        out["threshold"] = _tensor(fitted["threshold"], device, torch.float32)
        out["is_leaf"] = _tensor(fitted["is_leaf"], device, torch.bool)
        leaf = _tensor(fitted["leaf"], device, torch.float32)
        out["leaf"] = leaf if leaf.ndim == 3 else leaf[..., None]
        out["max_depth"] = int(fitted["max_depth"])
        out.setdefault("kind", "gbt")
        if out["kind"] == "gbt":
            out["eta"] = float(fitted["eta"])
            out["base"] = float(fitted["base"])
        elif out["kind"] != "forest":
            raise NotImplementedError(
                f"convert: no port model for tree kind {out['kind']!r}")
        elif out.get("task", "classification") != "classification":
            raise NotImplementedError(
                "convert: forest regression comes with the port's regression "
                "slice")
    else:
        raise NotImplementedError(f"convert: no port model for {name!r}")
    return out


def fitted_stage(stage, params: Dict[str, Any], device: torch.device):
    """The port's fitted counterpart of ``stage`` (an unfitted stage of the
    port's feature graph) carrying ``params``."""
    name = params.get("stage")

    def expect(want):
        if name != want:
            raise ValueError(f"convert: {type(stage).__name__} needs "
                             f"{want!r} parameters, got {name!r}")

    if isinstance(stage, VectorsCombiner):
        expect("VectorsCombiner")
        return stage
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
        return stage._finalize_model(model)
    if isinstance(stage, ModelSelector):
        expect("SelectedModel")
        cls = _MODELS.get(params["model"])
        if cls is None:
            raise NotImplementedError(
                f"convert: no port model for {params['model']!r}")
        best = cls(fitted=_model_fitted(params["model"], params["fitted"],
                                        device))
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
