"""Workflow — the user-facing DAG container and fitted model (port of
``transmogrifai_tpu/workflow.py``; reference: OpWorkflow.scala:207,344,
OpWorkflowModel.scala:184-394).

``train`` screens the input batch for non-finite numeric values
(``quality.screen_batch`` under ``QualityConfig.resolve(parameters
["quality"])``, on by default), runs the optional RawFeatureFilter over the
raw columns, drops the features it rejects from every stage's inputs,
reconstructs the stage DAG from the result features, fits it layer by layer
on the workflow's device and returns a ``WorkflowModel``.  Around that fit:
``train(resume_from=)`` replays the candidate families a
``SweepCheckpoint`` holds and flushes each one it completes, and a
preemption signal stops it at a family boundary with ``TrainingPreempted``;
``with_workflow_cv()`` cuts the DAG at the model selector and refits its
label-consuming feature stages inside each fold; ``with_sanitizers()``
runs the NaN guard, the purity audit and the serialization audit
(``sanitizer.py``).  The train's ``FailureLog`` is ``model.failure_log``.
The model scores through its ``ScoreProgram`` (``compiled.py``) on its
device, and ``save`` / ``load`` write and read the JAX package's bundle
format (``op-model.json``, ``params.npz`` and a ``MANIFEST.json`` of
SHA-256 digests, ``checkpoint.py``), so bundles move both ways between the
two packages.  ``summary()`` / ``summary_pretty()`` report the fitted
model's insights.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .checkpoint import (MANIFEST_NAME, CorruptModelError, SweepCheckpoint,
                         TrainingPreempted, atomic_bundle_write,
                         find_latest_valid, is_bundle_dir, preemption_guard,
                         verify_bundle)
from .columns import ColumnBatch, to_device_f32
from .dag import apply_dag, compute_dag, cut_dag, dag_stages, prune_batch
from .device import DeviceLike, resolve_device
from .features import Feature
from .resilience import FailureLog, record_failure
from .stages.base import Estimator, PipelineStage, Transformer
from .stages.generator import FeatureGeneratorStage
from .stages.serialization import (feature_to_json, kind_by_name,
                                   stage_fitted_arrays, stage_from_json,
                                   stage_to_json)
from .types import Prediction

MODEL_JSON = "op-model.json"
PARAMS_NPZ = "params.npz"


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
        self.parameters: Dict[str, Any] = {}
        self._input_batch: Optional[ColumnBatch] = None
        self._raw_feature_filter = None
        self._workflow_cv = False
        self._sanitizers: Dict[str, bool] = {}

    def set_input_batch(self, batch: ColumnBatch) -> "Workflow":
        self._input_batch = batch
        return self

    def set_parameters(self, params: Dict[str, Any]) -> "Workflow":
        """The run's parameters (≙ OpParams; JAX workflow.py:61), copied
        onto the trained model and saved in its bundle.  ``train`` reads
        ``params["quality"]`` (camelCase keys: ``enabled``, ``policy``,
        ``maxQuarantineFraction``)."""
        self.parameters = dict(params)
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

    def with_workflow_cv(self) -> "Workflow":
        """≙ withWorkflowCV (OpWorkflowCore.scala:104; JAX
        workflow.py:104): refit the label-consuming feature stages that
        feed the model selector inside each CV fold (``dag.cut_dag``)."""
        self._workflow_cv = True
        return self

    def with_sanitizers(self, nan_check: bool = False,
                        purity_check: bool = True,
                        serialization_check: bool = True) -> "Workflow":
        """Opt-in checks during ``train`` (``sanitizer.py``; JAX
        workflow.py:110-121): ``nan_check`` runs the NaN guard over the
        fit, ``purity_check`` applies every fitted transformer twice and
        wants the same bits, ``serialization_check`` wants every stage's
        params to survive ``stage_to_json``."""
        self._sanitizers = {"nan": nan_check, "purity": purity_check,
                            "serialization": serialization_check}
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

    def train(self, resume_from: Optional[str] = None) -> "WorkflowModel":
        """≙ OpWorkflow.train:344 (JAX workflow.py:220-321).

        The train owns one ``FailureLog``, which becomes
        ``model.failure_log``: the quality screen's quarantines, the
        validator's skipped, resumed and degraded work, and later what
        ``save`` drops.  ``resume_from`` names a sweep-checkpoint directory
        (``checkpoint.SweepCheckpoint``): each completed candidate family
        is flushed there, and a train pointed at the same directory replays
        those families instead of fitting them again ("resumed" events).
        For the extent of the call SIGTERM / SIGINT request a stop at the
        next family boundary: the completed families are flushed and
        ``TrainingPreempted`` (carrying ``resume_from``, the log as
        ``failure_log`` and the checkpoint as ``sweep_checkpoint``) is
        raised instead of dying mid-write.  The model keeps the checkpoint
        as ``sweep_checkpoint``."""
        if self._input_batch is None:
            raise ValueError("no input batch set — call set_input_batch first")
        log = FailureLog()
        sweep = SweepCheckpoint(resume_from) if resume_from is not None \
            else None
        try:
            with preemption_guard("train", log=log):
                if sweep is not None and len(sweep):
                    log.record("train", "resumed",
                               f"sweep checkpoint with {len(sweep)} "
                               "completed candidate(s)",
                               point="checkpoint.load",
                               resume_from=sweep.path)
                return self._train_guarded(log, sweep)
        except TrainingPreempted as e:
            e.failure_log = log
            e.sweep_checkpoint = sweep
            raise

    def _train_guarded(self, log: FailureLog,
                       sweep: Optional[SweepCheckpoint]) -> "WorkflowModel":
        """The body of ``train``: screen → RawFeatureFilter → fit (plain or
        workflow-CV, under the NaN guard) → purity audit.
        ``model.phase_seconds`` holds the wall time of the quality screen,
        the RawFeatureFilter and each stage type (fit and transform of all
        its stages, the device's queued work included)."""
        from .quality import QualityConfig, screen_batch
        from .sanitizer import (audit_dag_purity, audit_stage_serialization,
                                nan_guard)
        phases: Dict[str, float] = {}
        batch = self._input_batch
        # the train-time screen (JAX workflow.py:271-289): rows with NaN or
        # ±inf at present positions of numeric columns are dropped before
        # anything reaches the device; past maxQuarantineFraction,
        # DataQualityError
        qcfg = QualityConfig.resolve(self.parameters.get("quality"))
        if qcfg.enabled:
            t0 = time.perf_counter()
            batch = screen_batch(batch, self.raw_features, qcfg,
                                 stage="train", log=log)
            phases["quality"] = time.perf_counter() - t0
        batch = batch.on(self.device)
        rff_results = None
        if self._raw_feature_filter is not None:
            t0 = time.perf_counter()
            batch, self.blacklisted, rff_results = \
                self._raw_feature_filter.filter_batch(batch,
                                                      self.raw_features)
            self._apply_blacklist()
            phases["RawFeatureFilter"] = time.perf_counter() - t0
        dag = compute_dag(self.result_features)
        if self._sanitizers.get("serialization"):
            audit_stage_serialization(dag_stages(dag))
        raw_batch = batch if self._sanitizers.get("purity") else None
        with nan_guard(self._sanitizers.get("nan", False)) as nan_check:
            fitted_dag = self._fit(batch, dag, phases, nan_check, sweep, log)
        if raw_batch is not None:
            t0 = time.perf_counter()
            audit_dag_purity(fitted_dag, raw_batch)
            _sync(self.device)
            phases["purity_audit"] = time.perf_counter() - t0
        model = WorkflowModel(self.result_features, fitted_dag,
                              self.raw_features, self.device)
        model._input_batch = self._input_batch
        model.phase_seconds = phases
        model.blacklisted = list(self.blacklisted)
        model.rff_results = rff_results
        model.parameters = dict(self.parameters)
        model.failure_log = log
        model.sweep_checkpoint = sweep
        return model

    def _fit(self, batch: ColumnBatch, dag, phases: Dict[str, float],
             nan_check, sweep, log: FailureLog) -> List[List[Transformer]]:
        """Fit the DAG layer by layer, releasing each column once no later
        stage reads it.  With workflow CV the DAG is cut around the model
        selector (``cut_dag``, JAX workflow.py:452-502): 'before' and
        'during' are fit on all rows (the final model's feature stages),
        then the selector refits 'during' inside each fold, so the columns
        'during' reads stay until the selector is fit."""
        from .selector import ModelSelector
        selector = next((s for s in dag_stages(dag)
                         if isinstance(s, ModelSelector)), None)
        during: List[List[PipelineStage]] = []
        if self._workflow_cv and selector is not None:
            before, during, after = cut_dag(dag, selector)
            dag = before + during + after
        keep = ({f.name for f in self.raw_features}
                | {f.name for f in self.result_features} | {"key"})
        fitted_dag: List[List[Transformer]] = []
        selector_fitted = False
        for i, layer in enumerate(dag):
            models = []
            for st in layer:
                t0 = time.perf_counter()
                if st is selector:
                    m = st.fit(batch, in_fold_dag=during or None,
                               sweep=sweep, log=log)
                    selector_fitted = True
                elif isinstance(st, Estimator):
                    m = st.fit(batch)
                else:
                    m = st
                if not isinstance(m, Transformer):
                    raise TypeError(
                        f"stage {m} is neither Transformer nor Estimator")
                batch = m.transform_batch(batch)
                if nan_check is not None:
                    nan_check(m, batch)
                _sync(self.device)
                tag = type(st).__name__
                phases[tag] = phases.get(tag, 0.0) + time.perf_counter() - t0
                models.append(m)
            fitted_dag.append(models)
            remaining = [s for l in dag[i + 1:] for s in l]
            if during and not selector_fitted:
                remaining += dag_stages(during)
            batch = prune_batch(batch, remaining, keep)
        return fitted_dag


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
        self._score_program = None
        self.phase_seconds: Dict[str, float] = {}
        self.blacklisted: List[Feature] = []
        self.rff_results = None
        self.parameters: Dict[str, Any] = {}
        # what save dropped and load did without ("swallowed", "degraded")
        self.failure_log: Optional[FailureLog] = None
        # the data-quality contract a load read (quality.RawSchema)
        self.raw_schema = None
        # the SweepCheckpoint a train(resume_from=) flushed to
        self.sweep_checkpoint = None

    @property
    def stages(self) -> List[Transformer]:
        return [s for layer in self.fitted_dag for s in layer]

    @property
    def selected_model(self):
        from .selector import SelectedModel
        return next((s for s in self.stages if isinstance(s, SelectedModel)),
                    None)

    def _raw_batch(self, batch: Optional[ColumnBatch]) -> ColumnBatch:
        if batch is None:
            batch = self._input_batch
        if batch is None:
            raise ValueError("no batch to score — pass one or train on an "
                             "input batch")
        return batch.on(self.device)

    # -- scoring -------------------------------------------------------------
    def score_program(self):
        """The fitted DAG as a ``compiled.ScoreProgram``, kept on the
        model."""
        if self._score_program is None:
            from .compiled import ScoreProgram
            self._score_program = ScoreProgram(
                self.fitted_dag, [f.name for f in self.result_features])
        return self._score_program

    def score(self, batch: Optional[ColumnBatch] = None,
              keep_raw_features: bool = False,
              keep_intermediate_features: bool = False) -> ColumnBatch:
        """≙ OpWorkflowModel.score:255 — the result-feature columns (plus
        ``key`` when the batch has one, and the raw columns with
        ``keep_raw_features``) through the score program; every column
        with ``keep_intermediate_features``."""
        scored = self.score_program()(
            self._raw_batch(batch),
            keep_intermediate=keep_intermediate_features)
        if keep_intermediate_features:
            return scored
        keep = [f.name for f in self.result_features if f.name in scored]
        if keep_raw_features:
            keep = [f.name for f in self.raw_features if f.name in scored] \
                + keep
        if "key" in scored:
            keep = ["key"] + keep
        return scored.select(list(dict.fromkeys(keep)))

    def score_fn(self):
        """≙ scoreFn: batch → scored batch."""
        return lambda batch: self.score(batch)

    def evaluate(self, evaluator, label_feature: Optional[Feature] = None,
                 batch: Optional[ColumnBatch] = None) -> Dict[str, Any]:
        """≙ OpWorkflowModel.evaluate:320 — the evaluator's metric panel on
        the scored rows, computed on the device.  The label is
        ``label_feature``, else the selector's label input, else the raw
        response (JAX workflow.py:590-657)."""
        raw = self._raw_batch(batch)
        label = label_feature
        if label is None:
            sm = self.selected_model
            if sm is not None and sm.input_features:
                label = sm.input_features[0]
        if label is None:
            label = next((f for f in self.raw_features if f.is_response),
                         None)
        if label is None:
            raise ValueError(
                "evaluate: no response feature in the model's raw features — "
                "pass label_feature explicitly")
        program = self.score_program()
        try:
            scored = program(raw)
        except KeyError as e:
            raise ValueError(
                f"evaluate: column {e.args[0]!r} required by the DAG is "
                "missing from the scoring data — evaluation needs labelled "
                "rows (use score() for label-free data)") from e
        has_intermediate = False
        if label.name not in scored:
            # a label the DAG computes lives in a column the lean pass drops
            scored = program(raw, keep_intermediate=True)
            has_intermediate = True
        if label.name not in scored:
            raise ValueError(
                f"evaluate: response column {label.name!r} is not present in "
                "the scoring data — evaluation needs labelled rows (use "
                "score() for label-free data)")
        pred_f = next((f for f in self.result_features
                       if f.kind is Prediction), None)
        if pred_f is None:
            # any dict-valued (Prediction-shaped) result column
            if not has_intermediate:
                scored = program(raw, keep_intermediate=True)
            pred_f = next((f for f in self.result_features
                           if f.name in scored
                           and isinstance(scored[f.name].values, dict)), None)
        if pred_f is None:
            raise ValueError(
                "evaluate: no Prediction-typed result feature on this model; "
                f"result features: {[f.name for f in self.result_features]}")
        y = to_device_f32(scored[label.name].values, self.device)
        return evaluator.evaluate_all_device(
            y, dict(scored[pred_f.name].values), torch.ones_like(y)).to_json()

    def score_and_evaluate(self, evaluator, **kw):
        return self.score(**kw), self.evaluate(evaluator,
                                               batch=kw.get("batch"))

    def compute_data_up_to(self, feature: Feature,
                           batch: Optional[ColumnBatch] = None
                           ) -> ColumnBatch:
        """≙ computeDataUpTo (OpWorkflowCore.scala:299): the eager pass up to
        the stage that makes ``feature``."""
        return apply_dag(self._raw_batch(batch), self.fitted_dag,
                         up_to_feature=feature)

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

    # -- persistence (≙ OpWorkflowModelWriter / Reader) ----------------------
    def save(self, path: str, overwrite: bool = True) -> None:
        """Atomically write the model bundle to ``path`` (JAX
        workflow.py:681-802): staged in a temp sibling, digested into a
        ``MANIFEST.json``, fsynced and renamed into place.
        ``overwrite=False`` raises ``FileExistsError`` on a non-empty
        ``path``.  The bundle carries the data-quality contract
        (``schema.json``, ``quality.RawSchema``, range hints from the
        training batch).  No AOT executables, drift baselines or telemetry
        are written (the JAX package loads such a bundle, recording each as
        degraded)."""
        if self.failure_log is None:
            self.failure_log = FailureLog()
        with atomic_bundle_write(path, overwrite=overwrite,
                                 manifest_extra={"kind": "workflow-model"}
                                 ) as tmp:
            self._write_bundle_files(tmp)

    def _write_bundle_files(self, path: str) -> None:
        all_feats: Dict[str, Feature] = {}
        for rf in self.result_features:
            for f in rf.all_features():
                all_feats[f.uid] = f
        stages_json, arrays = [], {}
        for layer_i, layer in enumerate(self.fitted_dag):
            for st in layer:
                d = stage_to_json(st, self.failure_log)
                d["layer"] = layer_i
                d["outputFeatures"] = [f.uid for f in st.output_features]
                stages_json.append(d)
                arrays.update(stage_fitted_arrays(st))
        raw_json = []
        for f in self.raw_features:
            st = f.origin_stage
            if f.uid not in all_feats \
                    or not isinstance(st, FeatureGeneratorStage):
                continue
            d = {"uid": st.uid, "name": st.name, "type": f.kind.__name__,
                 "isResponse": f.is_response, "outputFeature": f.uid}
            if st.get("aggregate_window_ms") is not None:
                d["aggregateWindowMs"] = int(st.get("aggregate_window_ms"))
            if st.extract_source:
                d["extractSource"] = st.extract_source
            elif st.has_custom_extract:
                warnings.warn(
                    f"feature {st.name!r} has a custom extract function "
                    "with no source text; the reloaded model will fall "
                    "back to by-name record lookup — pass "
                    "FeatureBuilder.extract(fn, source='<expr over r>') "
                    "to persist it", stacklevel=3)
            raw_json.append(d)
        manifest = {
            "uid": "OpWorkflowModel",
            "resultFeaturesUids": [f.uid for f in self.result_features],
            "blacklistedFeaturesUids": [f.uid for f in self.blacklisted],
            "rawFeatures": raw_json,
            "allFeatures": [feature_to_json(f) for f in all_feats.values()],
            "stages": stages_json,
            "parameters": self.parameters,
            "rawFeatureFilterResults": (
                self.rff_results.to_json() if self.rff_results is not None
                else None),
        }
        with open(os.path.join(path, MODEL_JSON), "w") as fh:
            json.dump(manifest, fh, indent=2, default=str)
        np.savez_compressed(os.path.join(path, PARAMS_NPZ), **arrays)
        # the data-quality contract (JAX workflow.py:779-791): raw kinds,
        # nullability and training-range hints, under the manifest's
        # digests; a failed write never fails the save
        try:
            from .quality import RawSchema
            RawSchema.derive(self.raw_features,
                             batch=self._input_batch).save(path)
        except Exception as e:  # noqa: BLE001 — serving re-derives it
            record_failure(self.failure_log, "workflow.save", "swallowed",
                           e, point="checkpoint.save", detail="schema.json")

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "WorkflowModel":
        """≙ OpWorkflowModelReader (JAX workflow.py:804-931): stages →
        features → model, the fitted tensors on ``device`` (CUDA unless the
        caller asks for the CPU).

        ``path`` is one bundle or a checkpoint root of ``ckpt-NNNNNN``
        bundles, where the newest bundle that verifies is loaded (each one
        passed over is recorded "skipped").  A bundle with a
        ``MANIFEST.json`` has its version and every digest checked
        (``ModelVersionError`` / ``CorruptModelError`` naming the file); a
        legacy bundle without one loads with a warning.  The data-quality
        contract is ``model.raw_schema``: the bundle's ``schema.json``, or
        one re-derived from the raw features when the bundle has none
        (JAX :926-930).  Files of subsystems the port has not ported (AOT
        executables, drift baselines, telemetry) are digest-checked, not
        read, and recorded "degraded".  The model's ``failure_log`` holds
        the records."""
        dev = resolve_device(device)
        log = FailureLog()
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"model directory {path!r} does not exist")
        if not is_bundle_dir(path):
            path = find_latest_valid(path, log)
        manifest_meta = verify_bundle(path)
        if manifest_meta is None:
            warnings.warn(
                f"model bundle {path!r} has no MANIFEST.json (saved by a "
                "pre-checkpointing build); loading without integrity "
                "verification", stacklevel=2)
            record_failure(log, "checkpoint", "degraded",
                           "legacy bundle without MANIFEST",
                           point="checkpoint.load", bundle=path)
        json_path = os.path.join(path, MODEL_JSON)
        if not os.path.exists(json_path):
            raise CorruptModelError(path, MODEL_JSON,
                                    "model description file is missing")
        with open(json_path) as fh:
            manifest = json.load(fh)
        npz_path = os.path.join(path, PARAMS_NPZ)
        if os.path.exists(npz_path):
            with np.load(npz_path, allow_pickle=False) as z:
                arrays = dict(z)
        elif manifest_meta is not None and \
                PARAMS_NPZ in (manifest_meta.get("files") or {}):
            raise CorruptModelError(path, PARAMS_NPZ,
                                    "fitted-parameter file is missing")
        else:
            arrays = {}   # a legacy bundle may have no arrays

        stages_by_uid: Dict[str, PipelineStage] = {}
        layers: Dict[int, List[PipelineStage]] = {}
        for d in manifest["stages"]:
            st = stage_from_json(d, arrays, dev)
            stages_by_uid[d["uid"]] = st
            layers.setdefault(d["layer"], []).append(st)
        raw_gens: Dict[str, FeatureGeneratorStage] = {}
        for d in manifest["rawFeatures"]:
            raw_gens[d["uid"]] = FeatureGeneratorStage(
                name=d["name"], kind=kind_by_name(d["type"]), uid=d["uid"],
                aggregate_window_ms=d.get("aggregateWindowMs"),
                extract_source=d.get("extractSource"))

        feats: Dict[str, Feature] = {}
        feat_json = {d["uid"]: d for d in manifest["allFeatures"]}

        def build_feature(uid: str) -> Feature:
            if uid in feats:
                return feats[uid]
            d = feat_json[uid]
            parents = tuple(build_feature(p) for p in d.get("parents", ()))
            origin = None
            if d.get("originStage"):
                origin = (stages_by_uid.get(d["originStage"])
                          or raw_gens.get(d["originStage"]))
            f = Feature(d["name"], kind_by_name(d["type"]), d["isResponse"],
                        origin, parents, uid=uid)
            feats[uid] = f
            return f

        for uid in feat_json:
            build_feature(uid)
        for d in manifest["stages"]:
            st = stages_by_uid[d["uid"]]
            st.input_features = tuple(feats[u] for u in d["inputFeatures"])
            outs = tuple(feats[u] for u in d.get("outputFeatures", ()))
            if outs:
                st._output = outs[0]
                for f in outs:
                    f.origin_stage = st
        for d in manifest["rawFeatures"]:
            gen = raw_gens[d["uid"]]
            f = feats[d["outputFeature"]]
            gen._output = f
            f.origin_stage = gen

        model = WorkflowModel(
            [feats[u] for u in manifest["resultFeaturesUids"]],
            [layers[i] for i in sorted(layers)],
            sorted((f for f in feats.values()
                    if f.is_raw and f.origin_stage is not None),
                   key=lambda f: f.name), dev)
        model.blacklisted = [feats[u] for u in
                             manifest.get("blacklistedFeaturesUids", ())
                             if u in feats]
        model.parameters = manifest.get("parameters") or {}
        from .quality import SCHEMA_JSON, RawSchema
        # a re-derived contract lists the fields in the bundle's order, as
        # the JAX package's does (its loaded raw features are not sorted)
        model.raw_schema = RawSchema.for_model(
            model, path, log, [f for f in feats.values()
                               if f.is_raw and f.origin_stage is not None])
        unread = sorted({name.split("/", 1)[0] for name in
                         (manifest_meta or {}).get("files") or {}}
                        - {MODEL_JSON, PARAMS_NPZ, MANIFEST_NAME, SCHEMA_JSON})
        if unread:
            record_failure(log, "checkpoint", "degraded",
                           f"bundle files this build does not read: {unread}",
                           point="checkpoint.load", bundle=path)
        model.failure_log = log
        return model
