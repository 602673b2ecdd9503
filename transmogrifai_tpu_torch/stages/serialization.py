"""Stage and feature serialization (port of
``transmogrifai_tpu/stages/serialization.py``; reference:
OpPipelineStageReaderWriter.scala, OpWorkflowModelWriter.scala:53-171).

The format is the JAX package's: a stage is JSON (uid, class name, ctor
params, input features, fitted JSON, metadata, extra) and its fitted arrays
go to ``params.npz`` under ``<stage uid>/<name>``.  A tensor is written as a
host numpy array in its own dtype, which is the dtype the JAX package
writes for the same state (f32 values, int32 tree features, bool leaves,
int64 indices).  On load a stage class is found by its bare name in
``_STAGE_MODULES`` (the JAX package's list, cut to the modules the port
has), and ``place_fitted`` turns its arrays into what the port's transform
reads, on the load's device.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..columns import host_array
from ..features import Feature
from ..resilience import FailureLog, record_failure
from ..types import FEATURE_TYPES
from ..vector_meta import VectorMeta
from .base import PipelineStage, TransformerModel


def _is_array(v: Any) -> bool:
    return isinstance(v, (np.ndarray, np.generic, torch.Tensor))


# modules searched for stage classes on load (≙ ReflectionUtils.classForName)
_STAGE_MODULES = [
    "transmogrifai_tpu_torch.stages.generator",
    "transmogrifai_tpu_torch.ops.numeric",
    "transmogrifai_tpu_torch.ops.bucketizers",
    "transmogrifai_tpu_torch.ops.categorical",
    "transmogrifai_tpu_torch.ops.text",
    "transmogrifai_tpu_torch.ops.dates",
    "transmogrifai_tpu_torch.ops.geo",
    "transmogrifai_tpu_torch.ops.maps",
    "transmogrifai_tpu_torch.ops.collections",
    "transmogrifai_tpu_torch.ops.combiner",
    "transmogrifai_tpu_torch.models.linear",
    "transmogrifai_tpu_torch.models.trees",
    "transmogrifai_tpu_torch.preparators.sanity_checker",
    "transmogrifai_tpu_torch.selector",
]


def resolve_stage_class(class_name: str):
    for mod_name in _STAGE_MODULES:
        cls = getattr(importlib.import_module(mod_name), class_name, None)
        if cls is not None:
            return cls
    raise ValueError(f"unknown stage class {class_name!r}")


def _json_safe(v: Any, log: Optional[FailureLog], key: str = "") -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (np.ndarray, torch.Tensor)):
        # arrays nested in dict / list state round-trip as lists; top-level
        # arrays go to params.npz instead
        return _json_safe(host_array(v).tolist(), log, key)
    if isinstance(v, (list, tuple)):
        return [_json_safe(x, log, f"{key}[{i}]") for i, x in enumerate(v)]
    if isinstance(v, dict):
        return {str(k): _json_safe(x, log, f"{key}.{k}" if key else str(k))
                for k, x in v.items()}
    # a callable or another object: dropped, as the reference drops
    # non-ctor state, and recorded
    record_failure(log, "serialization", "swallowed",
                   f"dropped unserializable value of type {type(v).__name__}",
                   point="serialization.json_safe", key=key or "<anonymous>")
    return None


def stage_to_json(stage: PipelineStage,
                  log: Optional[FailureLog] = None) -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    for k, v in stage.ctor_args().items():
        if callable(v):
            record_failure(log, "serialization", "swallowed",
                           f"ctor param {k!r} is callable and cannot be "
                           "persisted", point="serialization.json_safe",
                           stage_uid=stage.uid, key=k)
            continue
        params[k] = _json_safe(v, log, key=f"{stage.uid}.{k}")
    d: Dict[str, Any] = {
        "uid": stage.uid,
        "className": type(stage).__name__,
        "params": params,
        "inputFeatures": [f.uid for f in stage.input_features],
    }
    if isinstance(stage, TransformerModel):
        fitted_json = {}
        for k, v in stage.fitted.items():
            if _is_array(v):
                continue
            if isinstance(v, VectorMeta):
                fitted_json[k] = {"__vector_meta__": v.to_json()}
            else:
                fitted_json[k] = _json_safe(v, log, key=f"{stage.uid}.{k}")
        d["fittedJson"] = fitted_json
        d["metadata"] = _json_safe(stage.metadata, log,
                                   key=f"{stage.uid}.metadata")
    extra_json, _ = stage.save_extra()
    if extra_json:
        d["extra"] = extra_json
    return d


def stage_fitted_arrays(stage: PipelineStage) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(stage, TransformerModel):
        out.update({f"{stage.uid}/{k}": host_array(v)
                    for k, v in stage.fitted.items() if _is_array(v)})
    _, extra_arrays = stage.save_extra()
    out.update({f"{stage.uid}/{k}": host_array(v)
                for k, v in extra_arrays.items()})
    return out


def stage_from_json(d: Dict[str, Any], arrays: Dict[str, np.ndarray],
                    device) -> PipelineStage:
    """The stage of ``d`` with its arrays, its fitted state placed on
    ``device``."""
    cls = resolve_stage_class(d["className"])
    params = dict(d.get("params") or {})
    params["uid"] = d["uid"]
    stage = cls(**params)
    prefix = d["uid"] + "/"
    own = {k[len(prefix):]: v for k, v in arrays.items()
           if k.startswith(prefix)}
    if isinstance(stage, TransformerModel):
        fitted: Dict[str, Any] = {}
        for k, v in (d.get("fittedJson") or {}).items():
            if isinstance(v, dict) and "__vector_meta__" in v:
                fitted[k] = VectorMeta.from_json(v["__vector_meta__"])
            else:
                fitted[k] = v
        fitted.update(own)
        stage.fitted = fitted
        stage.metadata = dict(d.get("metadata") or {})
    if d.get("extra"):
        stage.load_extra(d["extra"], own)
    if isinstance(stage, TransformerModel):
        stage.place_fitted(device)
    return stage


def feature_to_json(f: Feature) -> Dict[str, Any]:
    return {"name": f.name, "uid": f.uid, "type": f.kind.__name__,
            "isResponse": f.is_response,
            "originStage": f.origin_stage.uid if f.origin_stage else None,
            "parents": [p.uid for p in f.parents]}


def kind_by_name(name: str):
    for k, v in FEATURE_TYPES.items():
        if k == name or v.__name__ == name:
            return v
    raise ValueError(f"unknown feature type {name!r}")
