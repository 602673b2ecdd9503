"""Workflow — the user-facing DAG container and fitted model (port of
``transmogrifai_tpu/workflow.py``; reference: OpWorkflow.scala:207,344,
OpWorkflowModel.scala:184-394).

``train`` runs the optional RawFeatureFilter over the raw columns, drops the
features it rejects from every stage's inputs, reconstructs the stage DAG
from the result features, fits it layer by layer on the workflow's device
and returns a ``WorkflowModel``.  Scoring
applies the fitted stages in DAG order, eagerly, on the device; the JAX
package's compiled ``ScoreProgram`` and save/load come with later slices.
``summary()`` / ``summary_pretty()`` report the fitted model's insights.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from .columns import ColumnBatch, to_device_f32
from .dag import apply_dag, compute_dag, dag_stages, prune_batch
from .device import DeviceLike, resolve_device
from .features import Feature
from .stages.base import Estimator, Transformer
from .types import Prediction


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Workflow:
    """≙ OpWorkflow.  Runs on CUDA unless ``device="cpu"`` is passed."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.result_features: tuple = ()
        self.raw_features: List[Feature] = []
        self.blacklisted: List[Feature] = []
        self._input_batch: Optional[ColumnBatch] = None
        self._raw_feature_filter = None

    def set_input_batch(self, batch: ColumnBatch) -> "Workflow":
        self._input_batch = batch
        return self

    def set_result_features(self, *features: Feature) -> "Workflow":
        """≙ setResultFeatures: the DAG is everything these depend on."""
        self.result_features = tuple(features)
        seen: Dict[str, Feature] = {}
        for rf in self.result_features:
            for f in rf.all_features():
                seen[f.uid] = f
        self.raw_features = sorted((f for f in seen.values() if f.is_raw),
                                   key=lambda f: f.name)
        return self

    def with_raw_feature_filter(self, **kw) -> "Workflow":
        """≙ withRawFeatureFilter (OpWorkflow.scala:538): ``train`` filters
        the raw features first (``filters.RawFeatureFilter(**kw)``)."""
        from .filters import RawFeatureFilter
        self._raw_feature_filter = RawFeatureFilter(**kw)
        return self

    def _apply_blacklist(self) -> None:
        """≙ setBlacklist (OpWorkflow.scala:117): remove blacklisted raw
        features from every stage's inputs; a stage that loses all its
        inputs dies and its outputs die with it."""
        dead = {f.uid for f in self.blacklisted}
        if not dead:
            return
        for st in dag_stages(compute_dag(self.result_features)):
            if not st.input_features:
                continue
            new_inputs = tuple(f for f in st.input_features
                               if f.uid not in dead)
            if not new_inputs:
                dead.update(out.uid for out in st.output_features)
            elif len(new_inputs) != len(st.input_features):
                st.input_features = new_inputs
                for out in st.output_features:
                    out.parents = new_inputs
        lost = [f.name for f in self.result_features if f.uid in dead]
        if lost:
            raise ValueError(
                f"RawFeatureFilter removed all inputs of result feature(s) "
                f"{lost}; relax the filter thresholds or protect features")

    def train(self) -> "WorkflowModel":
        """≙ OpWorkflow.train:344 on the plain (no workflow-CV) path.
        ``model.phase_seconds`` holds the wall time of the RawFeatureFilter
        and of each stage type (fit and transform of all its stages, the
        device's queued work included)."""
        if self._input_batch is None:
            raise ValueError("no input batch set — call set_input_batch first")
        batch = self._input_batch.on(self.device)
        phases: Dict[str, float] = {}
        rff_results = None
        if self._raw_feature_filter is not None:
            t0 = time.perf_counter()
            batch, self.blacklisted, rff_results = \
                self._raw_feature_filter.filter_batch(batch,
                                                      self.raw_features)
            self._apply_blacklist()
            phases["RawFeatureFilter"] = time.perf_counter() - t0
        dag = compute_dag(self.result_features)
        keep = ({f.name for f in self.raw_features}
                | {f.name for f in self.result_features} | {"key"})
        fitted_dag = []
        for i, layer in enumerate(dag):
            models = []
            for st in layer:
                t0 = time.perf_counter()
                m = st.fit(batch) if isinstance(st, Estimator) else st
                if not isinstance(m, Transformer):
                    raise TypeError(
                        f"stage {m} is neither Transformer nor Estimator")
                batch = m.transform_batch(batch)
                _sync(self.device)
                tag = type(st).__name__
                phases[tag] = phases.get(tag, 0.0) + time.perf_counter() - t0
                models.append(m)
            fitted_dag.append(models)
            batch = prune_batch(batch, (s for l in dag[i + 1:] for s in l),
                                keep)
        model = WorkflowModel(self.result_features, fitted_dag,
                              self.raw_features, self.device)
        model._input_batch = self._input_batch
        model.phase_seconds = phases
        model.blacklisted = list(self.blacklisted)
        model.rff_results = rff_results
        return model


class WorkflowModel:
    """≙ OpWorkflowModel: the fitted DAG, scored on ``device``."""

    def __init__(self, result_features: Sequence[Feature],
                 fitted_dag: List[List[Transformer]],
                 raw_features: Sequence[Feature] = (),
                 device: DeviceLike = None):
        self.result_features = tuple(result_features)
        self.fitted_dag = fitted_dag
        self.raw_features = list(raw_features)
        self.device = resolve_device(device)
        self._input_batch: Optional[ColumnBatch] = None
        self.phase_seconds: Dict[str, float] = {}
        self.blacklisted: List[Feature] = []
        self.rff_results = None

    @property
    def stages(self) -> List[Transformer]:
        return [s for layer in self.fitted_dag for s in layer]

    @property
    def selected_model(self):
        from .selector import SelectedModel
        return next((s for s in self.stages if isinstance(s, SelectedModel)),
                    None)

    def _apply(self, batch: Optional[ColumnBatch]) -> ColumnBatch:
        if batch is None:
            batch = self._input_batch
        if batch is None:
            raise ValueError("no batch to score — pass one or train on an "
                             "input batch")
        return apply_dag(batch.on(self.device), self.fitted_dag)

    def score(self, batch: Optional[ColumnBatch] = None) -> ColumnBatch:
        """≙ OpWorkflowModel.score:255 — the result-feature columns (plus
        ``key`` when the batch has one)."""
        scored = self._apply(batch)
        keep = [f.name for f in self.result_features if f.name in scored]
        if "key" in scored:
            keep = ["key"] + keep
        return scored.select(list(dict.fromkeys(keep)))

    def evaluate(self, evaluator, batch: Optional[ColumnBatch] = None
                 ) -> Dict[str, Any]:
        """≙ OpWorkflowModel.evaluate:320 — the evaluator's metric panel on
        the scored rows, computed on the device."""
        scored = self._apply(batch)
        sm = self.selected_model
        label = (sm.input_features[0] if sm is not None
                 else next((f for f in self.raw_features if f.is_response),
                           None))
        if label is None or label.name not in scored:
            raise ValueError("evaluate: the scoring data has no label column")
        pred_f = next((f for f in self.result_features
                       if f.kind is Prediction), None)
        if pred_f is None:
            raise ValueError("evaluate: no Prediction-typed result feature")
        y = to_device_f32(scored[label.name].values, self.device)
        return evaluator.evaluate_all_device(
            y, dict(scored[pred_f.name].values), torch.ones_like(y)).to_json()

    # -- insights -------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """≙ OpWorkflowModel.summary: the ModelInsights JSON
        (``insights.ModelInsights``; the JAX package's workflow.py:670-678)."""
        from .insights import ModelInsights
        return ModelInsights.extract(self).to_json()

    def summary_pretty(self) -> str:
        """≙ OpWorkflowModel.summaryPretty: ASCII tables of the model
        evaluation and the top raw-feature contributions."""
        from .insights import ModelInsights
        return ModelInsights.extract(self).pretty()
