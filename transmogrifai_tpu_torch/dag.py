"""DAG layering, fitting and the workflow-CV cut (port of
``transmogrifai_tpu/dag.py``; reference: FitStagesUtil.computeDAG,
fitAndTransformLayer and cutDAG, FitStagesUtil.scala:173-356)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .columns import ColumnBatch
from .features import Feature
from .stages.base import Estimator, PipelineStage, Transformer
from .stages.generator import FeatureGeneratorStage

StageLayer = List[PipelineStage]


def compute_dag(result_features: Sequence[Feature]) -> List[StageLayer]:
    """Layer stages by max distance to any result feature, deepest first
    (≙ FitStagesUtil.computeDAG).  FeatureGeneratorStages are excluded — raw
    data generation is the reader's job."""
    dist: Dict[PipelineStage, int] = {}
    for f in result_features:
        for stage, d in f.parent_stages().items():
            if dist.get(stage, -1) < d:
                dist[stage] = d
    layers: Dict[int, StageLayer] = {}
    for stage, d in dist.items():
        if isinstance(stage, FeatureGeneratorStage):
            continue
        layers.setdefault(d, []).append(stage)
    out = [sorted(layers[d], key=lambda s: s.uid)
           for d in sorted(layers, reverse=True)]
    return [layer for layer in out if layer]


def dag_stages(dag: List[StageLayer]) -> List[PipelineStage]:
    return [s for layer in dag for s in layer]


def prune_batch(batch: ColumnBatch, remaining_stages, keep_names) -> ColumnBatch:
    """Release columns no remaining stage consumes (device-memory liveness)."""
    needed = set(keep_names)
    for s in remaining_stages:
        needed.update(f.name for f in s.input_features)
    drop = [n for n in batch.names() if n not in needed]
    return batch.drop(drop) if drop else batch


def apply_dag(batch: ColumnBatch, dag: List[StageLayer],
              up_to_feature: Optional[Feature] = None) -> ColumnBatch:
    """Apply an already-fitted DAG in order, eagerly on the batch's device
    (≙ applyTransformationsDAG, OpWorkflowCore.scala:321), stopping after
    the stage that makes ``up_to_feature`` when one is given."""
    for layer in dag:
        for t in layer:
            if not isinstance(t, Transformer):
                raise TypeError(
                    f"DAG contains unfitted estimator {t}; fit the workflow first")
            batch = t.transform_batch(batch)
            if up_to_feature is not None and any(
                    f.name == up_to_feature.name for f in t.output_features):
                return batch
    return batch


def fit_layer(batch: ColumnBatch, layer: StageLayer
              ) -> Tuple[ColumnBatch, List[Transformer]]:
    """Fit every estimator of a layer, then apply every transformer of the
    layer (≙ fitAndTransformLayer, FitStagesUtil.scala:253; JAX
    dag.py:60-74)."""
    fitted: List[Transformer] = []
    for stage in layer:
        if isinstance(stage, Estimator):
            fitted.append(stage.fit(batch))
        elif isinstance(stage, Transformer):
            fitted.append(stage)
        else:
            raise TypeError(
                f"stage {stage} is neither Transformer nor Estimator")
    for t in fitted:
        batch = t.transform_batch(batch)
    return batch, fitted


def fit_dag(batch: ColumnBatch, dag: List[StageLayer]
            ) -> Tuple[ColumnBatch, List[StageLayer]]:
    """Fit and apply the whole DAG (≙ fitAndTransformDAG:213): the batch it
    made and the fitted DAG, layered as ``dag``."""
    fitted_dag: List[StageLayer] = []
    for layer in dag:
        batch, fitted = fit_layer(batch, layer)
        fitted_dag.append(list(fitted))
    return batch, fitted_dag


def cut_dag(dag: List[StageLayer], selector
            ) -> Tuple[List[StageLayer], List[StageLayer], List[StageLayer]]:
    """(before, during, after) of the DAG around a model selector for
    workflow-level cross-validation (≙ FitStagesUtil.cutDAG:304-356; JAX
    dag.py:104-156).

    'during', the part refit inside every fold, is the selector's ancestor
    DAG from the first layer that holds a stage consuming both the label and
    a predictor (SanityChecker; ``firstCVTSIndex``, :333-337) onward.  A side
    branch that reads a 'during' output follows it into 'during'.  What lies
    upstream of that layer, estimators that never see the label included,
    is 'before' and is fit once on all rows; 'after' is the selector's layer
    and everything downstream of it."""
    sel_layer_idx = next((i for i, layer in enumerate(dag)
                          if any(s is selector for s in layer)), None)
    if sel_layer_idx is None:
        return dag, [], []
    anc_layers = compute_dag(selector.output_features)
    if anc_layers and any(s is selector for s in anc_layers[-1]):
        anc_layers = anc_layers[:-1]

    def consumes_label_and_features(stage) -> bool:
        ins = stage.input_features
        return (any(f.is_response for f in ins)
                and any(not f.is_response for f in ins))

    first = next((i for i, layer in enumerate(anc_layers)
                  if any(consumes_label_and_features(s) for s in layer)), -1)
    during_stages = (set() if first < 0 else
                     {s for layer in anc_layers[first:] for s in layer})
    # layers are in topological order, so one forward pass moves every side
    # branch of a 'during' output behind its producer
    during_out = {f.name for s in during_stages for f in s.output_features}
    for layer in dag[:sel_layer_idx]:
        for s in layer:
            if s not in during_stages and any(
                    f.name in during_out for f in s.input_features):
                during_stages.add(s)
                during_out.update(f.name for f in s.output_features)
    before = [[s for s in layer if s not in during_stages]
              for layer in dag[:sel_layer_idx]]
    during = [[s for s in layer if s in during_stages]
              for layer in dag[:sel_layer_idx]]
    return ([l for l in before if l], [l for l in during if l],
            dag[sel_layer_idx:])
