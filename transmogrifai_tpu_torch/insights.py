"""ModelInsights — the model explainability report (port of
``transmogrifai_tpu/insights.py``; reference:
core/src/main/scala/com/salesforce/op/ModelInsights.scala:74-392,
extractFromStages:440) and the ASCII ``summaryPretty`` rendering.

Walks the fitted DAG, collecting per-derived-feature contributions (raw and
descaled), label correlations / variances / Cramér's V from the
SanityChecker metadata, RawFeatureFilter feature distributions, the selected
model's summary and validation results, the label profile and a
training-stage echo.  Host work on a fitted model: nothing here touches the
device beyond reading the winner's fitted arrays.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .utils.table import render_table


@dataclass
class FeatureInsights:
    feature_name: str
    feature_type: str = ""
    derived_columns: List[Dict[str, Any]] = field(default_factory=list)
    # RawFeatureFilter distributions of this raw feature (per map key when
    # the feature is a map)
    distributions: List[Dict[str, Any]] = field(default_factory=list)

    def max_contribution(self) -> float:
        vals = [abs(c.get("contribution") or 0.0) for c in self.derived_columns]
        return max(vals) if vals else 0.0

    def max_abs_correlation(self) -> float:
        vals = [abs(c["corr"]) for c in self.derived_columns
                if c.get("corr") is not None and np.isfinite(c["corr"])]
        return max(vals) if vals else float("nan")

    def cramers_v(self) -> float:
        vals = [c["cramersV"] for c in self.derived_columns
                if c.get("cramersV") is not None and np.isfinite(c["cramersV"])]
        return max(vals) if vals else float("nan")


def _label_profile(workflow_model, resp) -> Dict[str, Any]:
    label = {"labelName": resp.name, "rawFeatureName": [resp.name],
             "rawFeatureType": [resp.kind.__name__]}
    batch = workflow_model._input_batch
    if batch is None or resp.name not in batch:
        return label
    raw = batch[resp.name].values
    if isinstance(raw, torch.Tensor):
        raw = raw.cpu().numpy()
    try:
        y = np.asarray(raw, dtype=np.float64)
    except (TypeError, ValueError):
        # raw string labels: profile the categorical values directly
        y = np.asarray([("" if v is None else str(v)) for v in raw])
    vals, counts = np.unique(y, return_counts=True)
    label.update({"sampleSize": int(len(y)), "distinctCount": int(len(vals))})
    if y.dtype.kind == "f" and len(y):
        label["mean"] = float(y.mean())
    if len(vals) <= 30:
        label["distribution"] = {str(v): int(c) for v, c in zip(vals, counts)}
    return label


@dataclass
class ModelInsights:
    """≙ ModelInsights.scala:74."""

    label: Dict[str, Any] = field(default_factory=dict)
    features: List[FeatureInsights] = field(default_factory=list)
    selected_model: Dict[str, Any] = field(default_factory=dict)
    problem_type: str = ""
    stage_info: Dict[str, Any] = field(default_factory=dict)
    training_params: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def extract(workflow_model) -> "ModelInsights":
        """≙ extractFromStages:440 (insights.py:64-211)."""
        from .preparators.sanity_checker import SanityCheckerModel
        from .vector_meta import VectorMeta

        ins = ModelInsights()
        sel = workflow_model.selected_model
        checker = next((s for s in workflow_model.stages
                        if isinstance(s, SanityCheckerModel)), None)
        resp = next((f for f in workflow_model.raw_features if f.is_response),
                    None)
        if resp is not None:
            ins.label = _label_profile(workflow_model, resp)

        contributions = _model_contributions(sel)
        by_parent: Dict[str, FeatureInsights] = {}
        if checker is not None and checker.metadata.get("summary"):
            s = checker.metadata["summary"]
            names = s.get("names", [])
            corrs = s.get("correlationsWithLabel", [])
            variances = s.get("variances", [])
            cramers_by_group = (s.get("categoricalStats", {}) or {}).get(
                "cramersV", {}) or {}
            dropped = set(s.get("dropped", []))
            reasons = s.get("dropReasons", {})
            # lineage from the checker's recorded vector meta; without it
            # each column is its own parent and the lineage is marked absent
            meta = None
            if "input_vector_meta" in checker.metadata:
                meta = VectorMeta.from_json(
                    checker.metadata["input_vector_meta"])
                if len(meta.columns) != len(names):
                    raise ValueError(
                        f"vector meta covers {len(meta.columns)} columns but "
                        f"the SanityChecker summary names {len(names)}")
            else:
                ins.stage_info["lineage"] = "absent"
            kept_pos = 0
            for i, name in enumerate(names):
                col_meta = meta.columns[i] if meta is not None else None
                parent = (col_meta.parent_feature_name if col_meta is not None
                          else name)
                fi = by_parent.setdefault(parent, FeatureInsights(
                    parent, col_meta.parent_feature_type if col_meta else ""))
                is_dropped = name in dropped
                contribution = descaled = None
                if not is_dropped and kept_pos < len(contributions):
                    contribution = contributions[kept_pos]
                    # |effect| in label units: |coef_j| * std_j
                    var_i = variances[i] if i < len(variances) else None
                    if (contribution is not None and var_i is not None
                            and np.isfinite(var_i)):
                        descaled = float(contribution
                                         * np.sqrt(max(var_i, 0.0)))
                if not is_dropped:
                    kept_pos += 1
                grouping = col_meta.grouping if col_meta else None
                indicator = col_meta.indicator_value if col_meta else None
                gname = parent if grouping is None else f"{parent}({grouping})"
                cram = (cramers_by_group.get(gname)
                        if indicator is not None else None)
                fi.derived_columns.append({
                    "name": name,
                    "corr": corrs[i] if i < len(corrs) else None,
                    "variance": variances[i] if i < len(variances) else None,
                    "cramersV": cram,
                    "dropped": is_dropped,
                    "dropReasons": reasons.get(name, []),
                    "contribution": contribution,
                    "descaledContribution": descaled,
                    "indicatorValue": indicator,
                    "grouping": grouping,
                })

        rff = getattr(workflow_model, "rff_results", None)
        if rff is not None:
            for d in rff.train_distributions:
                fi = by_parent.get(d.name)
                if fi is None:
                    fi = by_parent.setdefault(d.name, FeatureInsights(d.name))
                fi.distributions.append(d.to_json())

        ins.features = sorted(by_parent.values(),
                              key=lambda f: -f.max_contribution())
        if sel is not None:
            if sel.summary is not None:
                ins.selected_model = sel.summary.to_json()
                ins.problem_type = sel.summary.problem_type
            elif sel.metadata.get("summary"):
                ins.selected_model = sel.metadata["summary"]
                ins.problem_type = ins.selected_model.get("problemType", "")

        # training echo: workflow parameters + per-stage constructor params
        ins.training_params = dict(getattr(workflow_model, "parameters", None)
                                   or {})
        for stage in workflow_model.stages:
            ins.stage_info[stage.uid] = {
                "className": type(stage).__name__,
                "params": {k: v for k, v in stage.params.items()
                           if isinstance(v, (str, int, float, bool))
                           or v is None},
            }
        return ins

    def to_json(self) -> Dict[str, Any]:
        return {
            "label": self.label,
            "features": [{
                "featureName": f.feature_name,
                "featureType": f.feature_type,
                "derivedFeatures": f.derived_columns,
                "distributions": f.distributions,
            } for f in self.features],
            "selectedModelInfo": self.selected_model,
            "problemType": self.problem_type,
            "stageInfo": self.stage_info,
            "trainingParams": self.training_params,
        }

    def pretty(self) -> str:
        """≙ summaryPretty: ASCII tables of model evaluation + top
        features (insights.py:227-270)."""
        out = []
        sm = self.selected_model
        if sm:
            out.append(f"Selected model: {sm.get('bestModelName')} "
                       f"({sm.get('validationType')}, metric "
                       f"{sm.get('evaluationMetric')})")
            rows = []
            for r in sm.get("validationResults", [])[:20]:
                mv = r.get("metricValues", {})
                metric = next(iter(mv.values())) if mv else float("nan")
                shown = (f"{metric:.4f}"
                         if isinstance(metric, float) else metric)
                if r.get("racedOut"):
                    shown = f"{shown} (raced out @fold0)"
                rows.append([r.get("modelName"),
                             json.dumps(r.get("modelParameters", {}))[:48],
                             shown])
            out.append(render_table(
                ["Model", "Parameters", sm.get("evaluationMetric", "metric")],
                rows, title="Model Evaluation Metrics"))
        if self.features:
            rows = []
            for f in self.features[:25]:
                fill = ""
                if f.distributions:
                    fr = f.distributions[0].get("fillRate")
                    if fr is not None:
                        fill = f"{fr:.3f}"
                rows.append([
                    f.feature_name,
                    f"{f.max_contribution():.4f}",
                    ("%.4f" % f.max_abs_correlation()
                     if np.isfinite(f.max_abs_correlation()) else "-"),
                    ("%.4f" % f.cramers_v()
                     if np.isfinite(f.cramers_v()) else "-"),
                    fill or "-",
                    str(sum(1 for c in f.derived_columns if c["dropped"])),
                ])
            out.append(render_table(
                ["Top Raw Feature", "Max Contribution", "Max |Corr|",
                 "Cramér's V", "Fill Rate", "Dropped"],
                rows, title="Top Model Contributions"))
        return "\n".join(out)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _model_contributions(sel) -> List[float]:
    """Per-kept-column contribution of the winning model (≙
    insights.py:273-309): |coef| for linear models, normalised accumulated
    split gain for trees, split-usage frequency as the fallback."""
    if sel is None or sel.best_model is None:
        return []
    fitted = sel.best_model.fitted
    if "coef" in fitted:
        coef = _host(fitted["coef"])
        if coef.ndim == 2:
            return np.abs(coef).max(axis=1).tolist()
        return np.abs(coef).tolist()
    if "feature_gain" in fitted:
        gain = _host(fitted["feature_gain"]).astype(np.float64)
        tot = gain.sum()
        return (gain / tot if tot > 0 else gain).tolist()
    if "feature" in fitted:
        feats = _host(fitted["feature"]).ravel()
        feats = feats[feats >= 0]
        if feats.size == 0:
            return []
        d = int(feats.max()) + 1
        counts = np.bincount(feats, minlength=d).astype(np.float64)
        return (counts / counts.sum()).tolist()
    if "log_prob" in fitted:  # naive Bayes: spread of the class log-probs
        lp = _host(fitted["log_prob"])
        return np.abs(lp - lp.mean(axis=0)).max(axis=0).tolist()
    return []
