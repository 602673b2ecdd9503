"""Local scoring — one record at a time, no batch engine (port of
``transmogrifai_tpu/local.py``; reference:
local/src/main/scala/com/salesforce/op/local/OpWorkflowModelLocal.scala:61-199,
the score function at :93).

``score_function(model)`` returns a closure ``dict → dict`` that extracts
the raw features from a record and folds the fitted stages over it row by
row, each stage's ``transform_row`` running on the model's device: CUDA for
a model loaded with the default device, the CPU for one loaded with
``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from .stages.generator import FeatureGeneratorStage
from .types import FeatureType, Prediction


def extract_raw_value(feature, record: Dict[str, Any]) -> FeatureType:
    """One raw feature of one record: the generator's ``extract_fn``, then
    the monoid zero of a non-nullable kind the record lacks (so unlabelled
    records score)."""
    gen = feature.origin_stage
    val = (gen.extract_fn(record)
           if isinstance(gen, FeatureGeneratorStage)
           else record.get(feature.name))
    if isinstance(val, FeatureType):
        return val
    if val is None and feature.kind.non_nullable:
        return feature.kind(0.0)
    return feature.kind(val)


def score_function(workflow_model) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """≙ OpWorkflowModelLocal.scoreFunction."""
    stages = workflow_model.stages
    raw_features = list(workflow_model.raw_features)
    result_names = {f.name for f in workflow_model.result_features}
    device = workflow_model.device

    def score(record: Dict[str, Any]) -> Dict[str, Any]:
        row: Dict[str, FeatureType] = {
            f.name: extract_raw_value(f, record) for f in raw_features}
        for st in stages:
            row[st.get_output().name] = st.transform_row(row, device)
        result: Dict[str, Any] = {}
        for name in result_names:
            v = row.get(name)
            if isinstance(v, Prediction):
                result[name] = dict(v.value)
            elif isinstance(v, FeatureType):
                result[name] = v.value
            else:
                result[name] = v
        return result

    return score
