"""Contingency statistics and the mergeable streaming histogram — the
port's copy of ``transmogrifai_tpu/utils/stats.py`` (numpy only; reference:
utils/src/main/scala/com/salesforce/op/utils/stats/OpStatistics.scala:188-345
and utils/src/main/java/com/salesforce/op/utils/stats/StreamingHistogram.java:36).

Convention matches the reference: a contingency matrix has one ROW per feature
choice and one COLUMN per label value."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# contingency statistics (≙ OpStatistics)
# ---------------------------------------------------------------------------

def _igamc(a: float, x: float) -> float:
    """Regularized upper incomplete gamma Q(a, x) — series expansion for
    x < a+1, modified-Lentz continued fraction otherwise (the classical
    numerics; |err| ~ 1e-14).  Stdlib-only on purpose: this p-value is all
    the path would import scipy for."""
    import math
    if x <= 0.0 or a <= 0.0:
        return 1.0
    norm = math.exp(-x + a * math.log(x) - math.lgamma(a))
    if x < a + 1.0:
        ap, term, total = a, 1.0 / a, 1.0 / a
        for _ in range(500):
            ap += 1.0
            term *= x / ap
            total += term
            if abs(term) < abs(total) * 1e-16:
                break
        return max(0.0, min(1.0, 1.0 - total * norm))
    tiny = 1e-300
    b = x + 1.0 - a
    c = 1.0 / tiny
    d = 1.0 / b
    h = d
    for i in range(1, 500):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        if abs(d) < tiny:
            d = tiny
        c = b + an / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-16:
            break
    return max(0.0, min(1.0, norm * h))


def chi2_sf(chi2: float, dof: int) -> float:
    """Chi-squared survival function P[X >= chi2] = Q(dof/2, chi2/2).

    ``dof <= 0`` matches scipy's convention: the distribution is a point
    mass at 0, so the survival probability is 0.0 for any chi2 > 0 and 1.0
    at (or below) 0 — _igamc's blanket ``a <= 0 → 1.0`` would report the
    least-significant possible p-value for a degenerate table."""
    if dof <= 0:
        return 1.0 if chi2 <= 0.0 else 0.0
    return _igamc(dof / 2.0, chi2 / 2.0)


def chi_squared_test(contingency: np.ndarray) -> Tuple[float, float, float]:
    """(chi2 statistic, p-value, Cramér's V) on a contingency matrix with
    empty rows/cols filtered (≙ chiSquaredTest, OpStatistics.scala:188)."""
    obs = np.asarray(contingency, dtype=np.float64)
    obs = obs[obs.sum(axis=1) > 0][:, obs.sum(axis=0) > 0]
    if obs.size == 0 or min(obs.shape) < 2:
        return float("nan"), float("nan"), float("nan")
    n = obs.sum()
    expected = np.outer(obs.sum(axis=1), obs.sum(axis=0)) / n
    chi2 = float(((obs - expected) ** 2 / np.maximum(expected, 1e-12)).sum())
    dof = (obs.shape[0] - 1) * (obs.shape[1] - 1)
    p = chi2_sf(chi2, dof)
    k = min(obs.shape) - 1
    v = float(np.sqrt(chi2 / (n * max(k, 1))))
    return chi2, p, v


def pointwise_mutual_info(contingency: np.ndarray
                          ) -> Tuple[Dict[str, List[float]], float]:
    """(label → per-choice PMI values in log2, total mutual information)
    (≙ OpStatistics.mutualInfo, OpStatistics.scala:234: zeros where the cell
    or a margin is empty)."""
    obs = np.asarray(contingency, dtype=np.float64)
    n = obs.sum()
    row_sum = obs.sum(axis=1)            # per choice
    col_sum = obs.sum(axis=0)            # per label
    with np.errstate(divide="ignore", invalid="ignore"):
        pmi = np.log2(np.maximum(obs, 1e-99) * n
                      / np.outer(row_sum, col_sum))
    zero = (obs == 0) | (row_sum[:, None] == 0) | (col_sum[None, :] == 0)
    pmi = np.where(zero, 0.0, pmi)
    mi = float(np.sum(pmi * obs) / n) if n > 0 else float("nan")
    pmi_map = {str(j): [float(x) for x in pmi[:, j]]
               for j in range(obs.shape[1])}
    return pmi_map, mi


def max_confidences(contingency: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-choice (max rule confidence, support) — confidence of the rule
    "choice i ⇒ label argmax" (≙ OpStatistics.maxConfidences,
    OpStatistics.scala:280)."""
    obs = np.asarray(contingency, dtype=np.float64)
    row_sum = obs.sum(axis=1)
    total = row_sum.sum()
    supports = row_sum / total if total > 0 else np.zeros_like(row_sum)
    conf = np.where(row_sum > 0, obs.max(axis=1) / np.maximum(row_sum, 1e-99),
                    0.0)
    return conf, supports


@dataclass
class ContingencyStats:
    """≙ OpStatistics.ContingencyStats."""

    cramers_v: float = float("nan")
    chi_squared_stat: float = float("nan")
    p_value: float = float("nan")
    pointwise_mutual_info: Dict[str, List[float]] = field(default_factory=dict)
    mutual_info: float = float("nan")
    max_confidences: List[float] = field(default_factory=list)
    supports: List[float] = field(default_factory=list)

    def to_json(self) -> Dict:
        return {
            "cramersV": self.cramers_v,
            "chiSquaredStat": self.chi_squared_stat,
            "pValue": self.p_value,
            "pointwiseMutualInfo": self.pointwise_mutual_info,
            "mutualInfo": self.mutual_info,
            "maxRuleConfidences": self.max_confidences,
            "supports": self.supports,
        }


def contingency_stats(contingency: np.ndarray) -> ContingencyStats:
    """All contingency-derived stats (≙ OpStatistics.contingencyStats:300)."""
    obs = np.asarray(contingency, dtype=np.float64)
    if obs.size == 0 or obs.sum() == 0:
        return ContingencyStats()
    chi2, p, v = chi_squared_test(obs)
    pmi, mi = pointwise_mutual_info(obs)
    conf, supp = max_confidences(obs)
    return ContingencyStats(
        cramers_v=v, chi_squared_stat=chi2, p_value=p,
        pointwise_mutual_info=pmi, mutual_info=mi,
        max_confidences=[float(c) for c in conf],
        supports=[float(s) for s in supp])


# ---------------------------------------------------------------------------
# mergeable streaming histogram (≙ StreamingHistogram.java — Ben-Haim/Tom-Tov)
# ---------------------------------------------------------------------------

class StreamingHistogram:
    """Ben-Haim/Tom-Tov streaming histogram: a bounded set of (centroid,
    count) bins maintained by closest-pair merging.  ``merge`` combines
    sketches built independently (shards / stream micro-batches) without a
    shared binning — the property fixed-range ``np.histogram`` lacks
    (≙ StreamingHistogram.java:36, StreamingHistogramBuilder:120, merge:269)."""

    def __init__(self, max_bins: int = 64):
        self.max_bins = int(max_bins)
        self._points: List[List[float]] = []   # sorted [centroid, count]

    # -- updates -----------------------------------------------------------
    def update(self, p: float, count: float = 1.0) -> "StreamingHistogram":
        if not np.isfinite(p):
            return self
        self._insert(float(p), float(count))
        self._compress()
        return self

    def update_all(self, values) -> "StreamingHistogram":
        values = np.asarray(values, dtype=np.float64)
        values = values[np.isfinite(values)]
        if len(values) == 0:
            return self
        # bulk path: exact value-count aggregation when cardinality is low
        # (constant/binary columns keep their exact shape), else quantile
        # pre-binning — same sketch contract, vectorized host work
        uniq, counts = np.unique(values, return_counts=True)
        if len(uniq) <= 4 * self.max_bins:
            for v, cnt in zip(uniq, counts):
                self._insert(float(v), float(cnt))
        else:
            qs = np.linspace(0, 1, 4 * self.max_bins + 1)
            edges = np.unique(np.quantile(values, qs))
            counts, edges = np.histogram(values, bins=edges)
            centers = 0.5 * (edges[:-1] + edges[1:])
            for c, cnt in zip(centers, counts):
                if cnt > 0:
                    self._insert(float(c), float(cnt))
        self._compress()
        return self

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        out = StreamingHistogram(max(self.max_bins, other.max_bins))
        for c, n in self._points + other._points:
            out._insert(c, n)
        out._compress()
        return out

    def _insert(self, p: float, count: float) -> None:
        import bisect
        idx = bisect.bisect_left([x[0] for x in self._points], p)
        if idx < len(self._points) and self._points[idx][0] == p:
            self._points[idx][1] += count
        else:
            self._points.insert(idx, [p, count])

    def _compress(self) -> None:
        while len(self._points) > self.max_bins:
            gaps = [self._points[i + 1][0] - self._points[i][0]
                    for i in range(len(self._points) - 1)]
            i = int(np.argmin(gaps))
            (p1, n1), (p2, n2) = self._points[i], self._points[i + 1]
            self._points[i] = [(p1 * n1 + p2 * n2) / (n1 + n2), n1 + n2]
            del self._points[i + 1]

    # -- queries -----------------------------------------------------------
    @property
    def bins(self) -> List[Tuple[float, float]]:
        return [(p, n) for p, n in self._points]

    @property
    def total(self) -> float:
        return float(sum(n for _, n in self._points))

    def sum_to(self, b: float) -> float:
        """Estimated count of points ≤ b (trapezoid interpolation between
        centroids, ≙ StreamingHistogram.sum)."""
        pts = self._points
        if not pts:
            return 0.0
        if b < pts[0][0]:
            return 0.0
        if b >= pts[-1][0]:
            return self.total
        s = 0.0
        for i in range(len(pts) - 1):
            p1, n1 = pts[i]
            p2, n2 = pts[i + 1]
            if b < p1:
                break
            if b >= p2:
                s += n1
                continue
            # inside trapezoid (p1, p2)
            frac = (b - p1) / (p2 - p1)
            nb = n1 + (n2 - n1) * frac
            s += n1 / 2.0 + (n1 + nb) / 2.0 * frac
            break
        return float(s)

    # -- serialization -----------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        """JSON form of the sketch — the bundle-baseline representation.
        Round-trips exactly: the points ARE the sketch state."""
        return {"maxBins": self.max_bins,
                "points": [[float(p), float(n)] for p, n in self._points]}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "StreamingHistogram":
        h = StreamingHistogram(int(d.get("maxBins", 64)))
        for p, n in d.get("points") or []:
            h._insert(float(p), float(n))
        h._compress()
        return h

    def to_fixed_bins(self, n_bins: int, lo: Optional[float] = None,
                      hi: Optional[float] = None) -> np.ndarray:
        """Export to a fixed-range density histogram (the FeatureDistribution
        representation) via cumulative differences."""
        pts = self._points
        if not pts:
            return np.zeros(n_bins)
        lo = pts[0][0] if lo is None else lo
        hi = pts[-1][0] if hi is None else hi
        if hi <= lo:
            out = np.zeros(n_bins)
            out[0] = self.total
            return out
        edges = np.linspace(lo, hi, n_bins + 1)
        cums = np.asarray([self.sum_to(e) for e in edges])
        return np.maximum(np.diff(cums), 0.0)
