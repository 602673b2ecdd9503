"""DAG layering (port of ``transmogrifai_tpu/dag.py``; reference:
FitStagesUtil.computeDAG, FitStagesUtil.scala:173-304)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .columns import ColumnBatch
from .features import Feature
from .stages.base import PipelineStage, Transformer
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
