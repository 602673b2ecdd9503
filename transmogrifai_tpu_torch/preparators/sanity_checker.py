"""SanityChecker — automatic feature validation / leakage detection (port of
``transmogrifai_tpu/preparators/sanity_checker.py``; reference:
SanityChecker.scala:535-640, SanityCheckerModel:695, OpStatistics.scala:71,
188, 234).

The fit is a handful of reductions over the device-resident feature matrix
(moments, min/max and the label correlation) and, where the vector has
categorical indicator groups, one [C, |union|] contingency product over the
union of their columns, from which each group's Cramér's V and rule
confidences are computed on the host; the model is a gather of the kept
column indices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columns import Column, ColumnBatch, to_device_f32
from ..stages.base import Estimator, TransformerModel
from ..types import OPVector, RealNN
from ..utils.stats import contingency_stats
from ..vector_meta import VectorMeta

DEFAULT_MAX_CORRELATION = 0.95
DEFAULT_MIN_CORRELATION = 0.0
DEFAULT_MIN_VARIANCE = 1e-5
DEFAULT_MAX_CRAMERS_V = 0.95
DEFAULT_MAX_RULE_CONFIDENCE = 1.0
DEFAULT_MIN_REQUIRED_RULE_SUPPORT = 1.0
DEFAULT_SAMPLE_UPPER_LIMIT = 1_000_000
DEFAULT_CORRELATION_TYPE = "pearson"


def _label_corr(Xf: torch.Tensor, yf: torch.Tensor) -> torch.Tensor:
    """Per-column Pearson correlation with the label (over raw values, or
    over average ranks, which makes it Spearman)."""
    yc = yf - yf.mean()
    ysd = torch.sqrt(torch.sum(yc * yc))
    Xc = Xf - Xf.mean(dim=0)
    cov = yc @ Xc
    xsd = torch.sqrt(torch.sum(Xc * Xc, dim=0))
    return cov / torch.clamp(xsd * ysd, min=1e-12)


def _rank_transform(a: torch.Tensor) -> torch.Tensor:
    """Average rank per column (ties get the mean of their positions, like
    scipy's 'average'); ≙ ``_rank_transform`` at sanity_checker.py:89-105."""
    if a.ndim == 1:
        return _rank_transform(a[:, None])[:, 0]
    ss, order = torch.sort(a, dim=0, stable=True)
    sst = ss.T.contiguous()
    left = torch.searchsorted(sst, sst, right=False).to(torch.float32)
    right = torch.searchsorted(sst, sst, right=True).to(torch.float32)
    avg = (0.5 * (left + right - 1.0)).T
    return torch.zeros_like(avg).scatter_(0, order, avg)


def _col_stats(X: torch.Tensor, y: torch.Tensor, spearman: bool = False):
    """Per-column mean / var (ddof=1) / min / max + label correlation
    (≙ ``_col_stats``, sanity_checker.py:49-73)."""
    Xf = X.to(torch.float32)
    yf = y.to(torch.float32)
    mean = Xf.mean(dim=0)
    var = Xf.var(dim=0, unbiased=True)
    mn = Xf.amin(dim=0)
    mx = Xf.amax(dim=0)
    if spearman:
        corr = _label_corr(_rank_transform(Xf), _rank_transform(yf))
    else:
        corr = _label_corr(Xf, yf)
    return mean, var, mn, mx, corr


def _col_stats_with_contingency(X: torch.Tensor, y: torch.Tensor,
                                union_idx: torch.Tensor,
                                y_classes: torch.Tensor,
                                spearman: bool = False):
    """``_col_stats`` stacked [5, D] and the contingency [C, |union|] of
    the label classes against the union of indicator columns, one product
    (≙ ``_col_stats_with_contingency``, sanity_checker.py:76-86).  The
    contingency always contracts the raw indicator values."""
    stats = torch.stack(_col_stats(X, y, spearman=spearman))
    yoh = (y[:, None] == y_classes[None, :]).to(torch.float32)
    return stats, yoh.T @ X[:, union_idx].to(torch.float32)


@dataclass
class SanityCheckerSummary:
    """≙ SanityCheckerSummary metadata."""

    correlation_type: str = DEFAULT_CORRELATION_TYPE
    names: List[str] = field(default_factory=list)
    correlations_with_label: List[float] = field(default_factory=list)
    variances: List[float] = field(default_factory=list)
    means: List[float] = field(default_factory=list)
    mins: List[float] = field(default_factory=list)
    maxs: List[float] = field(default_factory=list)
    cramers_v_by_group: Dict[str, float] = field(default_factory=dict)
    contingency_stats_by_group: Dict[str, Any] = field(default_factory=dict)
    dropped: List[str] = field(default_factory=list)
    drop_reasons: Dict[str, List[str]] = field(default_factory=dict)
    sample_size: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {
            "correlationType": self.correlation_type,
            "names": self.names,
            "correlationsWithLabel": self.correlations_with_label,
            "variances": self.variances,
            "means": self.means,
            "mins": self.mins,
            "maxs": self.maxs,
            "categoricalStats": {
                "cramersV": self.cramers_v_by_group,
                "contingencyStats": self.contingency_stats_by_group},
            "dropped": self.dropped,
            "dropReasons": self.drop_reasons,
            "sampleSize": self.sample_size,
        }


class SanityCheckerModel(TransformerModel):
    """Keeps the surviving column slice (≙ SanityCheckerModel:695)."""

    in_kinds = (RealNN, OPVector)
    out_kind = OPVector
    allow_label_as_input = True

    def transform(self, batch: ColumnBatch) -> Column:
        vec = batch[self.input_features[1].name]
        idx = np.asarray(self.fitted["indices_to_keep"], dtype=np.int64)
        X = to_device_f32(vec.values, batch.device)
        values = X[:, torch.as_tensor(idx, device=X.device)].contiguous()
        meta = (vec.meta.select(idx.tolist(), name=self.get_output().name)
                if vec.meta is not None else None)
        return Column(OPVector, values, meta=meta)


class SanityChecker(Estimator):
    """≙ SanityChecker estimator on (label, featureVector)."""

    in_kinds = (RealNN, OPVector)
    out_kind = OPVector
    allow_label_as_input = True

    def __init__(self, max_correlation: float = DEFAULT_MAX_CORRELATION,
                 min_correlation: float = DEFAULT_MIN_CORRELATION,
                 min_variance: float = DEFAULT_MIN_VARIANCE,
                 max_cramers_v: float = DEFAULT_MAX_CRAMERS_V,
                 max_rule_confidence: float = DEFAULT_MAX_RULE_CONFIDENCE,
                 min_required_rule_support: float =
                 DEFAULT_MIN_REQUIRED_RULE_SUPPORT,
                 remove_bad_features: bool = True,
                 correlation_type: str = DEFAULT_CORRELATION_TYPE,
                 check_sample_fraction: float = 1.0,
                 sample_upper_limit: int = DEFAULT_SAMPLE_UPPER_LIMIT,
                 seed: int = 42, **kw):
        super().__init__(max_correlation=max_correlation,
                         min_correlation=min_correlation,
                         min_variance=min_variance,
                         max_cramers_v=max_cramers_v,
                         max_rule_confidence=max_rule_confidence,
                         min_required_rule_support=min_required_rule_support,
                         remove_bad_features=remove_bad_features,
                         correlation_type=correlation_type,
                         check_sample_fraction=check_sample_fraction,
                         sample_upper_limit=sample_upper_limit, seed=seed, **kw)

    def output_name(self) -> str:
        return f"{self.input_features[1].name}_sanityChecked_{self.uid[-6:]}"

    def fit(self, batch: ColumnBatch) -> SanityCheckerModel:
        label_f, vec_f = self.input_features
        y = np.asarray(batch[label_f.name].values, dtype=np.float32)
        vec = batch[vec_f.name]
        Xd = to_device_f32(vec.values, batch.device)
        n, d = Xd.shape
        meta = vec.meta or VectorMeta(vec_f.name, [])
        names = (meta.column_names() if meta.size == d
                 else [f"f_{i}" for i in range(d)])

        # sampling (≙ SanityChecker sample fraction:524) — the same numpy
        # draw as the JAX package, so both check the same rows
        frac = float(self.get("check_sample_fraction", 1.0))
        limit = int(self.get("sample_upper_limit", DEFAULT_SAMPLE_UPPER_LIMIT))
        if frac < 1.0 or n > limit:
            m = min(int(n * frac) if frac < 1.0 else n, limit)
            rng = np.random.default_rng(int(self.get("seed", 42)))
            idx = rng.choice(n, size=m, replace=False)
            Xs = Xd[torch.as_tensor(idx, device=Xd.device)]
            ys_host = y[idx]
        else:
            Xs, ys_host = Xd, y
        ys = to_device_f32(ys_host, Xd.device)
        corr_type = self.get("correlation_type", DEFAULT_CORRELATION_TYPE)
        spearman = corr_type == "spearman"

        # Cramér's V and association rules per categorical indicator group
        # (≙ categoricalTests): a group is the columns with an indicator
        # value sharing (parent feature, grouping); skipped for a label of
        # more than 100 classes (a regression label is no category)
        groups: Dict[Tuple[str, Optional[str]], List[int]] = {}
        if meta.size == d:
            for c in meta.columns:
                if c.indicator_value is not None:
                    groups.setdefault((c.parent_feature_name, c.grouping),
                                      []).append(c.index)
        y_classes = np.unique(ys_host)
        if len(y_classes) > 100:
            groups = {}
        if groups:
            # ONE product over the union of indicator columns covers every
            # group's contingency
            union = sorted({i for idxs in groups.values() for i in idxs})
            pos_of = {i: p for p, i in enumerate(union)}
            stacked, cont = _col_stats_with_contingency(
                Xs, ys, torch.as_tensor(union, device=Xs.device),
                torch.as_tensor(y_classes, dtype=torch.float32,
                                device=Xs.device), spearman=spearman)
            cont_all = cont.cpu().numpy()
        else:
            stacked = torch.stack(_col_stats(Xs, ys, spearman=spearman))
        mean, var, mn, mx, corr_arr = stacked.cpu().numpy()

        cramers: Dict[str, float] = {}
        contingency_by_group: Dict[str, Dict] = {}
        group_fail: Dict[int, List[str]] = {}
        max_rule_conf = float(self.get("max_rule_confidence", 1.0))
        min_rule_supp = float(self.get("min_required_rule_support", 1.0))
        for (parent, grouping), idxs in groups.items():
            contingency = cont_all[:, [pos_of[i] for i in idxs]]  # [C, k]
            # the reference's rows are the choices: transpose
            cstats = contingency_stats(contingency.T)
            v = cstats.cramers_v
            gname = parent if grouping is None else f"{parent}({grouping})"
            cramers[gname] = v
            contingency_by_group[gname] = cstats.to_json()
            reasons = []
            if np.isfinite(v) and v > float(self.get("max_cramers_v", 1.0)):
                reasons.append(f"CramersV {v:.4f} > max")
            # association rule confidence (leakage): P(label = c | col = 1)
            conf = np.asarray(cstats.max_confidences)
            supp = np.asarray(cstats.supports) * contingency.sum() / max(
                len(ys_host), 1)
            if max_rule_conf < 1.0 or min_rule_supp < 1.0:
                if ((conf >= max_rule_conf) & (supp >= min_rule_supp)).any():
                    reasons.append("rule confidence leakage")
            if reasons:
                for i in idxs:
                    group_fail.setdefault(i, []).extend(reasons)

        # per-column drop rules
        max_corr = float(self.get("max_correlation", DEFAULT_MAX_CORRELATION))
        min_corr = float(self.get("min_correlation", DEFAULT_MIN_CORRELATION))
        min_var = float(self.get("min_variance", DEFAULT_MIN_VARIANCE))
        reasons_by_col: Dict[int, List[str]] = {
            i: list(r) for i, r in group_fail.items()}
        for i in range(d):
            c = abs(corr_arr[i])
            if np.isfinite(c):
                if c > max_corr:
                    reasons_by_col.setdefault(i, []).append(
                        f"correlation {c:.4f} > maxCorrelation")
                elif c < min_corr:
                    reasons_by_col.setdefault(i, []).append(
                        f"correlation {c:.4f} < minCorrelation")
            if var[i] < min_var:
                reasons_by_col.setdefault(i, []).append(
                    f"variance {var[i]:.2e} < minVariance")

        remove = bool(self.get("remove_bad_features", True))
        drop_idx = sorted(reasons_by_col) if remove else []
        keep = [i for i in range(d) if i not in set(drop_idx)]
        if not keep:  # never drop everything
            keep = list(range(d))
            drop_idx = []

        summary = SanityCheckerSummary(
            correlation_type=corr_type, names=names,
            correlations_with_label=[float(c) for c in corr_arr],
            variances=[float(v) for v in var], means=[float(m) for m in mean],
            mins=[float(v) for v in mn], maxs=[float(v) for v in mx],
            cramers_v_by_group=cramers,
            contingency_stats_by_group=contingency_by_group,
            dropped=[names[i] for i in drop_idx],
            drop_reasons={names[i]: r for i, r in reasons_by_col.items()},
            sample_size=len(ys_host))
        model = SanityCheckerModel(
            fitted={"indices_to_keep": np.asarray(keep, dtype=np.int64)},
            **self._params)
        model.metadata["summary"] = summary.to_json()
        if meta.size == d:  # full input lineage for ModelInsights
            model.metadata["input_vector_meta"] = meta.to_json()
        model.summary = summary
        return self._finalize_model(model)
