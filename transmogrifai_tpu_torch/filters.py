"""RawFeatureFilter — pre-training data hygiene (port of
``transmogrifai_tpu/filters.py``; reference:
core/src/main/scala/com/salesforce/op/filters/RawFeatureFilter.scala:137-486,
FeatureDistribution.scala:58 with fillRate:94, jsDivergence,
relativeFillRate/Ratio; results in RawFeatureFilterResults.scala).

Computes per-raw-feature fill rates and value histograms on the training
data (and optionally a scoring set) on the host with numpy, then drops
features whose fill rate is too low, whose train/score fill rates diverge,
whose distributions diverge (Jensen-Shannon), or whose null pattern
correlates with the label.  Text features hash into bins like the
reference, from the cached one-pass column profile; numeric maps bin per
key from the cached map expansion.  The JAX package's mesh-sharded
histogram (``_sharded_numeric_hist``) comes with the port's multi-card
slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import zlib

import numpy as np

from .columns import Column, ColumnBatch
from .features import Feature
from .types import is_map_kind, is_numeric_kind, is_text_kind


@dataclass
class FeatureDistribution:
    """≙ FeatureDistribution.scala:58."""

    name: str
    key: Optional[str] = None           # map key (map features expand per key)
    count: int = 0
    nulls: int = 0
    distribution: np.ndarray = field(default_factory=lambda: np.zeros(0))
    summary: Dict[str, float] = field(default_factory=dict)

    @property
    def fill_rate(self) -> float:
        """≙ fillRate:94."""
        return 0.0 if self.count == 0 else 1.0 - self.nulls / self.count

    def relative_fill_rate(self, other: "FeatureDistribution") -> float:
        return abs(self.fill_rate - other.fill_rate)

    def relative_fill_ratio(self, other: "FeatureDistribution") -> float:
        a, b = self.fill_rate, other.fill_rate
        mn, mx = min(a, b), max(a, b)
        return float("inf") if mn == 0 else mx / mn

    def js_divergence(self, other: "FeatureDistribution") -> float:
        """Jensen-Shannon divergence of the binned distributions."""
        p, q = self.distribution, other.distribution
        if p.size == 0 or q.size == 0 or p.size != q.size:
            return 0.0
        ps, qs = p.sum(), q.sum()
        if ps == 0 or qs == 0:
            return 0.0
        p = p / ps
        q = q / qs
        m = 0.5 * (p + q)

        def kl(a, b):
            mask = a > 0
            return float(np.sum(a[mask] * np.log2(a[mask] / b[mask])))

        return 0.5 * kl(p, m) + 0.5 * kl(q, m)

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "key": self.key, "count": self.count,
                "nulls": self.nulls, "fillRate": self.fill_rate,
                "distribution": self.distribution.tolist(),
                "summary": self.summary}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "FeatureDistribution":
        # fillRate is derived from count/nulls and not read back
        return FeatureDistribution(
            d["name"], key=d.get("key"), count=int(d.get("count", 0)),
            nulls=int(d.get("nulls", 0)),
            distribution=np.asarray(d.get("distribution") or [],
                                    dtype=np.float64),
            summary={k: float(v)
                     for k, v in (d.get("summary") or {}).items()})


@dataclass
class FeatureSketch:
    """Mergeable per-feature distribution sketch for sharded / streamed data
    (≙ StreamingHistogram.java + FeatureDistribution's monoid `reduce`):
    numeric values go into a Ben-Haim/Tom-Tov streaming histogram (merges
    without a shared binning), text hashes into fixed bins (trivially
    mergeable)."""

    name: str
    key: Optional[str] = None
    count: int = 0
    nulls: int = 0
    histogram: Optional[Any] = None      # StreamingHistogram (numeric kinds)
    text_counts: Optional[np.ndarray] = None  # [text_bins] (text kinds)

    @property
    def fill_rate(self) -> float:
        """≙ FeatureDistribution.fill_rate (count = rows seen, nulls ⊆)."""
        return 0.0 if self.count == 0 else 1.0 - self.nulls / self.count

    def merge(self, other: "FeatureSketch") -> "FeatureSketch":
        assert (self.name, self.key) == (other.name, other.key)
        hist = None
        if self.histogram is not None or other.histogram is not None:
            from .utils.stats import StreamingHistogram
            a = self.histogram or StreamingHistogram()
            b = other.histogram or StreamingHistogram()
            hist = a.merge(b)
        tc = None
        if self.text_counts is not None or other.text_counts is not None:
            za = self.text_counts if self.text_counts is not None else 0.0
            zb = other.text_counts if other.text_counts is not None else 0.0
            tc = za + zb
        return FeatureSketch(self.name, self.key, self.count + other.count,
                             self.nulls + other.nulls, hist, tc)

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "key": self.key, "count": int(self.count),
                "nulls": int(self.nulls),
                "histogram": (self.histogram.to_json()
                              if self.histogram is not None else None),
                "textCounts": ([float(x) for x in self.text_counts]
                               if self.text_counts is not None else None)}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "FeatureSketch":
        hist = None
        if d.get("histogram") is not None:
            from .utils.stats import StreamingHistogram
            hist = StreamingHistogram.from_json(d["histogram"])
        tc = (np.asarray(d["textCounts"], dtype=np.float64)
              if d.get("textCounts") is not None else None)
        return FeatureSketch(d["name"], d.get("key"), int(d.get("count", 0)),
                             int(d.get("nulls", 0)), hist, tc)

    def to_distribution(self, bins: int) -> FeatureDistribution:
        if self.text_counts is not None:
            dist = np.asarray(self.text_counts, dtype=np.float64)
        elif self.histogram is not None:
            dist = self.histogram.to_fixed_bins(bins)
        else:
            dist = np.zeros(bins)
        return FeatureDistribution(self.name, key=self.key, count=self.count,
                                   nulls=self.nulls, distribution=dist)


def compute_sketches(raw_features: Sequence[Feature], batch: ColumnBatch,
                     max_bins: int = 64, text_bins: int = 100
                     ) -> Dict[Tuple[str, Optional[str]], FeatureSketch]:
    """Per-feature mergeable sketches over one shard/micro-batch.  Combine
    shards with ``merge_sketches``; finalize with ``FeatureSketch
    .to_distribution`` — distributions then combine across shards/streams the
    way the reference merges StreamingHistograms (StreamingHistogram.java:269)."""
    from .utils.stats import StreamingHistogram

    out: Dict[Tuple[str, Optional[str]], FeatureSketch] = {}
    for f in raw_features:
        col = batch.get(f.name)
        if col is None:
            continue
        n = len(col)
        kind = f.kind
        if is_map_kind(kind):
            keys = sorted({k for m in col.values if m for k in m})
            for k in keys:
                vals = [m.get(k) if m else None for m in col.values]
                out[(f.name, k)] = _sketch_of(
                    f.name, k, vals, kind, max_bins, text_bins)
            # whole-map presence sketch — also the per-shard row count that
            # merge_sketches uses to pad keys absent from a shard
            out[(f.name, None)] = FeatureSketch(
                f.name, None, n,
                int(sum(1 for m in col.values if not m)),
                text_counts=np.zeros(text_bins))
            continue
        vals = (list(col.values) if col.is_host_object()
                else np.asarray(col.values))
        if not col.is_host_object() and col.mask is not None:
            vals = np.where(np.asarray(col.mask), vals, np.nan)
        out[(f.name, None)] = _sketch_of(
            f.name, None, vals, kind, max_bins, text_bins)
    return out


def _sketch_of(name, key, vals, kind, max_bins, text_bins) -> FeatureSketch:
    from .types import map_value_kind
    from .utils.stats import StreamingHistogram

    n = len(vals)
    vkind = map_value_kind(kind) if is_map_kind(kind) else kind
    if is_numeric_kind(vkind):
        arr = np.asarray(
            [float(v) if isinstance(v, (int, float, np.floating, np.integer))
             and not isinstance(v, bool) else
             (1.0 if v is True else 0.0 if v is False else np.nan)
             for v in vals] if isinstance(vals, list) else vals,
            dtype=np.float64)
        finite = np.isfinite(arr)
        hist = StreamingHistogram(max_bins).update_all(arr[finite])
        return FeatureSketch(name, key, n, int((~finite).sum()),
                             histogram=hist)
    counts = np.zeros(text_bins)
    nulls = 0
    for v in vals:
        # same emptiness convention as _value_presence: None/""/[]/{} are null
        if v is None or (isinstance(v, float) and np.isnan(v)) or (
                hasattr(v, "__len__") and len(v) == 0):
            nulls += 1
            continue
        for item in (v if isinstance(v, (list, set, frozenset, tuple))
                     else [v]):
            counts[_stable_text_bin(item, text_bins)] += 1.0
    return FeatureSketch(name, key, n, nulls, text_counts=counts)


def merge_sketches(a: Dict, b: Dict) -> Dict:
    """Monoid merge of two shards' sketch maps.  A map key absent from one
    shard is padded with that shard's row count as nulls (taken from the
    feature's whole-map sketch) so per-key counts/fill rates stay exact."""
    def _pad(sk: FeatureSketch, side: Dict) -> FeatureSketch:
        if sk.key is None:
            return sk
        base = side.get((sk.name, None))
        if base is None or base.count == 0:
            return sk
        missing = FeatureSketch(sk.name, sk.key, base.count, base.count)
        if sk.histogram is not None:
            from .utils.stats import StreamingHistogram
            missing.histogram = StreamingHistogram(sk.histogram.max_bins)
        if sk.text_counts is not None:
            missing.text_counts = np.zeros_like(sk.text_counts)
        return sk.merge(missing)

    out: Dict = {}
    for k in set(a) | set(b):
        if k in a and k in b:
            out[k] = a[k].merge(b[k])
        elif k in a:
            out[k] = _pad(a[k], b)
        else:
            out[k] = _pad(b[k], a)
    return out


def _stable_text_bin(item, text_bins: int) -> int:
    """Process-stable hash bin (crc32, not Python's randomized hash()) so
    sketches/distributions built in different processes stay mergeable and
    train-vs-score comparable."""
    return zlib.crc32(str(item).encode("utf-8")) % text_bins


def _value_presence(col: Column) -> np.ndarray:
    if col.is_host_object():
        if is_text_kind(col.kind):
            # cached one-pass profile (ops/text_profile.py) — the same scan
            # the vectorizers reuse, so RFF costs no extra column walk
            from .ops.text_profile import column_profile
            return column_profile(col).presence
        return np.array([v is not None and v != "" and v != [] and v != {}
                         for v in col.values])
    if col.mask is not None:
        return np.asarray(col.mask)
    return np.ones(len(col), dtype=bool)


def numeric_ranges(feature: Feature, col: Column
                   ) -> Dict[Optional[str], Tuple[float, float]]:
    """Per-(feature[, map-key]) numeric (min, max) — the reference's Summary
    pass.  Train + score ranges merge so BOTH sides bin identically; without a
    shared range a pure mean shift produces near-identical histogram shapes
    and JS divergence never fires."""
    kind = feature.kind
    out: Dict[Optional[str], Tuple[float, float]] = {}

    def rng_of(vals):
        arr = np.asarray(
            [float(v) if isinstance(v, (int, float, np.integer, np.floating))
             and not isinstance(v, bool) else np.nan for v in vals],
            dtype=np.float64)
        arr = arr[np.isfinite(arr)]
        if not arr.size:
            return None
        return float(arr.min()), float(arr.max())

    if is_map_kind(kind):
        from .types import map_value_kind
        if not is_numeric_kind(map_value_kind(kind)):
            return out
        from .ops.map_profile import map_expansion
        exp = map_expansion(col)
        if exp is not None:
            # cached one-pass expansion (bool-free: bools fall through to
            # the Python path below, where rng_of treats them as NaN)
            for j, k in enumerate(exp.keys):
                v = exp.vals[:, j]
                v = v[np.isfinite(v)]
                if v.size:
                    out[k] = (float(v.min()), float(v.max()))
            return out
        keys = sorted({k for m in col.values if m for k in m})
        for k in keys:
            r = rng_of([m.get(k) if m else None for m in col.values])
            if r is not None:
                out[k] = r
        return out
    if is_numeric_kind(kind) and not col.is_host_object():
        vals = np.asarray(col.values, dtype=np.float64)
        if col.mask is not None:
            vals = vals[np.asarray(col.mask)]
        vals = vals[np.isfinite(vals)]
        if vals.size:
            out[None] = (float(vals.min()), float(vals.max()))
    elif is_numeric_kind(kind):
        r = rng_of(list(col.values))
        if r is not None:
            out[None] = r
    return out


def merge_ranges(a: Dict, b: Dict) -> Dict:
    out = dict(a)
    for k, (lo, hi) in b.items():
        if k in out:
            out[k] = (min(out[k][0], lo), max(out[k][1], hi))
        else:
            out[k] = (lo, hi)
    return out


def compute_distribution(feature: Feature, col: Column, bins: int,
                         text_bins: int,
                         ranges: Optional[Dict] = None
                         ) -> List[FeatureDistribution]:
    """Per-feature histogram(s).  Maps expand per key (≙ PreparedFeatures).
    ``ranges`` pins the numeric binning range per key (shared train/score
    Summary)."""
    n = len(col)
    present = _value_presence(col)
    out = []
    kind = feature.kind
    ranges = ranges or {}
    if is_map_kind(kind):
        from .types import map_value_kind
        vkind = map_value_kind(kind)
        exp = None
        if is_numeric_kind(vkind):
            from .ops.map_profile import map_expansion
            exp = map_expansion(col)
        if exp is not None:
            idx = exp.key_index()
            for k in sorted(exp.keys):
                j = idx[k]
                sub_present = exp.present[:, j]
                dist = _histogram_of(exp.vals[:, j], sub_present, vkind,
                                     bins, text_bins,
                                     value_range=ranges.get(k))
                out.append(FeatureDistribution(
                    feature.name, key=k, count=n,
                    nulls=int((~sub_present).sum()), distribution=dist))
            if not exp.keys:
                out.append(FeatureDistribution(feature.name, count=n, nulls=n,
                                               distribution=np.zeros(bins)))
            return out
        keys = sorted({k for m in col.values if m for k in m})
        for k in keys:
            vals = [m.get(k) if m else None for m in col.values]
            sub_present = np.array([v is not None for v in vals])
            # histogram by the map's VALUE kind: a RealMap's values are
            # numeric and must bin numerically, not hash as text
            dist = _histogram_of(vals, sub_present, vkind, bins, text_bins,
                                 value_range=ranges.get(k))
            out.append(FeatureDistribution(
                feature.name, key=k, count=n,
                nulls=int((~sub_present).sum()), distribution=dist))
        if not keys:
            out.append(FeatureDistribution(feature.name, count=n, nulls=n,
                                           distribution=np.zeros(bins)))
        return out
    if is_text_kind(kind) and col.is_host_object():
        # hashed whole-value bins straight from the cached column profile
        from .ops.text_profile import column_profile
        dist = column_profile(col).crc_hist(text_bins)
    else:
        dist = _histogram_of(list(np.asarray(col.values, dtype=object))
                             if col.is_host_object() else np.asarray(col.values),
                             present, kind, bins, text_bins,
                             value_range=ranges.get(None))
    out.append(FeatureDistribution(feature.name, count=n,
                                   nulls=int((~present).sum()),
                                   distribution=dist))
    return out


def _histogram_of(vals, present: np.ndarray, kind, bins: int,
                  text_bins: int, value_range=None) -> np.ndarray:
    if is_numeric_kind(kind):
        arr = np.asarray(
            [float(v) if (v is not None and not isinstance(v, str)) else np.nan
             for v in vals] if isinstance(vals, list) else vals,
            dtype=np.float64)
        keep = present & np.isfinite(arr)
        if not keep.any():
            return np.zeros(bins)
        if value_range is not None:
            lo, hi = value_range
        else:
            lo, hi = float(arr[keep].min()), float(arr[keep].max())
        if lo == hi:
            hi = lo + 1.0
        h, _ = np.histogram(arr[keep], bins=bins, range=(lo, hi))
        return h.astype(np.float64)
    # text-ish: hash values into text_bins (≙ text hashed into bins)
    h = np.zeros(text_bins)
    for v, p in zip(vals, present):
        if not p or v is None:
            continue
        for item in (v if isinstance(v, (list, set, tuple)) else [v]):
            h[_stable_text_bin(item, text_bins)] += 1.0
    return h


@dataclass
class RawFeatureFilterResults:
    """≙ RawFeatureFilterResults."""

    train_distributions: List[FeatureDistribution] = field(default_factory=list)
    score_distributions: List[FeatureDistribution] = field(default_factory=list)
    dropped: List[str] = field(default_factory=list)
    dropped_map_keys: Dict[str, List[str]] = field(default_factory=dict)
    reasons: Dict[str, List[str]] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "rawFeatureDistributions": [d.to_json() for d in self.train_distributions],
            "scoringFeatureDistributions": [d.to_json() for d in self.score_distributions],
            "featuresDropped": self.dropped,
            "mapKeysDropped": self.dropped_map_keys,
            "exclusionReasons": self.reasons,
        }


class RawFeatureFilter:
    """≙ RawFeatureFilter.scala: configurable thresholds, train + optional
    scoring reader."""

    def __init__(self, min_fill_rate: float = 0.001,
                 max_fill_difference: float = 0.9,
                 max_fill_ratio_diff: float = 20.0,
                 max_js_divergence: float = 0.9,
                 max_correlation: float = 0.95,
                 bins: int = 100, text_bins: int = 255,
                 score_reader=None, protected_features: Sequence[str] = ()):
        self.min_fill_rate = float(min_fill_rate)
        self.max_fill_difference = float(max_fill_difference)
        self.max_fill_ratio_diff = float(max_fill_ratio_diff)
        self.max_js_divergence = float(max_js_divergence)
        self.max_correlation = float(max_correlation)
        self.bins = int(bins)
        self.text_bins = int(text_bins)
        self.score_reader = score_reader
        self.protected = set(protected_features)

    def filter_batch(self, batch: ColumnBatch, raw_features: Sequence[Feature]
                     ) -> Tuple[ColumnBatch, List[Feature], RawFeatureFilterResults]:
        """≙ generateFilteredRaw:486: returns (clean batch, dropped features,
        results)."""
        results = RawFeatureFilterResults()
        dists: Dict[str, List[FeatureDistribution]] = {}
        label_values: Optional[np.ndarray] = None
        label_name = next((f.name for f in raw_features if f.is_response), None)
        if label_name and label_name in batch:
            label_values = np.asarray(batch[label_name].values, dtype=np.float64)

        score_batch = None
        if self.score_reader is not None:
            score_batch = self.score_reader.generate_batch(
                [f for f in raw_features if not f.is_response])

        for f in raw_features:
            if f.name not in batch or f.is_response:
                continue
            # shared Summary range over BOTH readers so train and score bin
            # identically (≙ Summary.scala) — a mean shift must move mass to
            # different bins, or JS divergence can never see it
            ranges = numeric_ranges(f, batch[f.name])
            score_col = (score_batch[f.name] if score_batch is not None
                         and f.name in score_batch else None)
            if score_col is not None:
                ranges = merge_ranges(ranges, numeric_ranges(f, score_col))
            fdists = compute_distribution(f, batch[f.name], self.bins,
                                          self.text_bins, ranges=ranges)
            dists[f.name] = fdists
            results.train_distributions.extend(fdists)
            sdists: List[FeatureDistribution] = []
            if score_col is not None:
                sdists = compute_distribution(f, score_col, self.bins,
                                              self.text_bins, ranges=ranges)
                results.score_distributions.extend(sdists)
            if f.name in self.protected:
                continue

            reasons: List[str] = []
            # minimum fill rate (≙ minFill)
            if all(d.fill_rate < self.min_fill_rate for d in fdists):
                reasons.append(
                    f"fill rate {fdists[0].fill_rate:.4f} < minFillRate")
            # null-label correlation (leakage through missingness)
            if label_values is not None and len(np.unique(label_values)) > 1:
                presence = _value_presence(batch[f.name]).astype(np.float64)
                if presence.std() > 0:
                    corr = float(np.corrcoef(presence, label_values)[0, 1])
                    if np.isfinite(corr) and abs(corr) > self.max_correlation:
                        reasons.append(
                            f"null-label correlation {corr:.4f} > max")

            # train-vs-score distribution shift, compared PER KEY for maps
            # (≙ getFeaturesToExclude pairing distributions by (name, key));
            # shifted map keys drop individually, the whole feature drops
            # only when every key fails
            sd_by_key = {d.key: d for d in sdists}
            shifted_keys: List[str] = []
            for d in fdists:
                sd = sd_by_key.get(d.key)
                if sd is None:
                    continue
                kreasons = []
                if d.relative_fill_rate(sd) > self.max_fill_difference:
                    kreasons.append("fill rate difference train/score too large")
                if d.relative_fill_ratio(sd) > self.max_fill_ratio_diff:
                    kreasons.append("fill rate ratio train/score too large")
                js = d.js_divergence(sd)
                if js > self.max_js_divergence:
                    kreasons.append(f"JS divergence {js:.4f} > max")
                if not kreasons:
                    continue
                if d.key is None:
                    reasons.extend(kreasons)
                else:
                    shifted_keys.append(d.key)
                    results.reasons[f"{f.name}[{d.key}]"] = kreasons
            all_keys = [d.key for d in fdists if d.key is not None]
            if shifted_keys:
                results.dropped_map_keys[f.name] = shifted_keys
                if len(shifted_keys) == len(all_keys):
                    reasons.append("every map key failed train/score checks")
            if reasons:
                results.dropped.append(f.name)
                results.reasons[f.name] = reasons + \
                    results.reasons.get(f.name, [])

        dropped = set(results.dropped)
        dropped_features = [f for f in raw_features if f.name in dropped]
        clean = batch.drop(results.dropped)
        # strip dropped keys out of surviving map columns (≙ generateFilteredRaw
        # cleaning map values of excluded keys)
        for name, keys in results.dropped_map_keys.items():
            if name in dropped or name not in clean:
                continue
            kset = set(keys)
            col = clean[name]
            vals = np.empty(len(col), dtype=object)
            for i, m in enumerate(col.values):
                vals[i] = ({k: v for k, v in m.items() if k not in kset}
                           if m else m)
            clean = clean.with_columns({name: Column(col.kind, vals)})
        return clean, dropped_features, results
