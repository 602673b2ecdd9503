"""Bucketizers, calibrators and scalers (port of
``transmogrifai_tpu/ops/bucketizers.py``; reference:
NumericBucketizer.scala, DecisionTreeNumericBucketizer.scala:60,74,
DecisionTreeNumericMapBucketizer.scala, PercentileCalibrator.scala,
ScalerTransformer.scala, DescalerTransformer.scala and
IsotonicRegressionCalibrator.scala).

Bucketizing is a ``searchsorted`` and a one-hot on the host.  The
decision-tree bucketizers fit a gini tree a column (or a map key) against
the label on the port's tree engine (``models/trees.fit_trees``: the
``tree_hist``, ``tree_split_gini`` and ``tree_route`` kernels on the card),
all of a stage's columns in one fit: each column is a lane of the batch,
weighted by its present rows (absent rows add nothing), whose node mask
lets it split only on its own column.  Isotonic calibration is
pool-adjacent-violators on the sorted scores, interpolated linearly at
predict time.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columns import Column, ColumnBatch, host_array
from ..device import DeviceLike, resolve_device
from ..stages.base import Estimator, Transformer, TransformerModel
from ..types import OPNumeric, OPVector, Real, RealNN
from ..vector_meta import NULL_INDICATOR, VectorColumnMeta, VectorMeta

# reference defaults (DecisionTreeNumericBucketizer.scala:293-300)
DT_BUCKETIZER_MAX_DEPTH = 5
DT_BUCKETIZER_MAX_BINS = 32
DT_BUCKETIZER_MIN_INSTANCES = 1
DT_BUCKETIZER_MIN_INFO_GAIN = 0.01
INVALID_INDICATOR = "OTHER"  # the reference tracks invalid values as OTHER


def splits_to_bucket_labels(splits: Sequence[float],
                            inclusion: str = "Left") -> List[str]:
    """≙ NumericBucketizer.splitsToBucketLabels: range labels."""
    lo, hi = ("[", ")") if inclusion == "Left" else ("(", "]")
    return [f"{lo}{splits[i]}-{splits[i + 1]}{hi}"
            for i in range(len(splits) - 1)]


def bucketize_values(v: np.ndarray, mask: Optional[np.ndarray],
                     splits: np.ndarray, *, inclusion: str = "Left",
                     track_nulls: bool = True,
                     track_invalid: bool = False) -> np.ndarray:
    """One-hot bucket matrix of ``v`` against ``splits`` (B + 1 points,
    usually bracketed by ±inf): B buckets [+ invalid] [+ null]
    (≙ NumericBucketizer.bucketize)."""
    v = np.asarray(v, dtype=np.float64)
    n = len(v)
    B = len(splits) - 1
    present = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
    # ±inf count as values (nan_to_num makes them finite); NaN does not
    finite = np.isfinite(np.nan_to_num(v, nan=np.inf)) & ~np.isnan(v)
    side = "right" if inclusion == "Left" else "left"
    idx = np.searchsorted(splits, v, side=side) - 1
    valid = present & finite & (idx >= 0) & (idx < B)
    cols = B + int(track_invalid) + int(track_nulls)
    out = np.zeros((n, cols), np.float32)
    rows = np.flatnonzero(valid)
    out[rows, np.clip(idx[rows], 0, B - 1)] = 1.0
    c = B
    if track_invalid:
        out[present & ~valid, c] = 1.0
        c += 1
    if track_nulls:
        out[~present, c] = 1.0
    return out


def _bucket_meta(feature_name: str, kind_name: str, out_name: str,
                 labels: Sequence[str], track_nulls: bool,
                 track_invalid: bool) -> VectorMeta:
    cols = [VectorColumnMeta(feature_name, kind_name, indicator_value=lbl)
            for lbl in labels]
    if track_invalid:
        cols.append(VectorColumnMeta(feature_name, kind_name,
                                     indicator_value=INVALID_INDICATOR))
    if track_nulls:
        cols.append(VectorColumnMeta(feature_name, kind_name,
                                     indicator_value=NULL_INDICATOR))
    return VectorMeta(out_name, cols)


def _numeric(col: Column) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(f64 values, presence or None) of a numeric column on the host."""
    mask = None if col.mask is None else np.asarray(host_array(col.mask),
                                                    bool)
    return np.asarray(host_array(col.values), np.float64), mask


def _out(arr: np.ndarray, batch: ColumnBatch) -> torch.Tensor:
    return torch.as_tensor(arr, device=batch.device)


class NumericBucketizer(Transformer):
    """Fixed-split bucketization of a numeric feature into a one-hot
    vector (≙ NumericBucketizer.scala); ``splits`` strictly increasing;
    values outside them are invalid (tracked with ``track_invalid``)."""

    in_kinds = (OPNumeric,)
    out_kind = OPVector
    is_device_op = False

    def __init__(self, splits: Sequence[float] = (-np.inf, 0.0, np.inf),
                 bucket_labels: Optional[Sequence[str]] = None,
                 split_inclusion: str = "Left", track_nulls: bool = True,
                 track_invalid: bool = False, **params):
        splits = [float(s) for s in splits]
        if sorted(splits) != splits or len(set(splits)) != len(splits):
            raise ValueError("splits must be strictly increasing")
        if len(splits) < 3:
            raise ValueError("at least 3 split points required")
        super().__init__(splits=splits,
                         bucket_labels=list(bucket_labels or []),
                         split_inclusion=split_inclusion,
                         track_nulls=track_nulls,
                         track_invalid=track_invalid, **params)

    def transform(self, batch: ColumnBatch) -> Column:
        (f,) = self.input_features
        v, mask = _numeric(batch[f.name])
        splits = np.asarray(self.get("splits"), np.float64)
        inclusion = self.get("split_inclusion", "Left")
        labels = (self.get("bucket_labels")
                  or splits_to_bucket_labels(splits, inclusion))
        out = bucketize_values(v, mask, splits, inclusion=inclusion,
                               track_nulls=self.get("track_nulls", True),
                               track_invalid=self.get("track_invalid", False))
        meta = _bucket_meta(f.name, f.kind.__name__, self.output_name(),
                            labels, self.get("track_nulls", True),
                            self.get("track_invalid", False))
        return Column(OPVector, _out(out, batch), meta=meta)


# --------------------------------------------------------------------------
# the decision-tree bucketizers' fit
# --------------------------------------------------------------------------

def tree_splits_for_columns(values: np.ndarray, present: np.ndarray,
                            y: np.ndarray, *,
                            max_depth: int = DT_BUCKETIZER_MAX_DEPTH,
                            max_bins: int = DT_BUCKETIZER_MAX_BINS,
                            min_instances: int = DT_BUCKETIZER_MIN_INSTANCES,
                            min_gain: float = DT_BUCKETIZER_MIN_INFO_GAIN,
                            device: DeviceLike = None) -> List[np.ndarray]:
    """The split thresholds of a single-feature gini tree fit against the
    label for each column of ``values`` [N, K] over its ``present`` [N, K]
    rows (≙ ``tree_splits_for_feature``, JAX ``ops/bucketizers.py:125``, a
    column at a time): the column's bin splits from its present rows alone
    (``build_bin_splits``), statistics (1, one-hot of the present rows'
    ``np.unique`` labels, at least 2 classes).  Columns whose present rows
    hold the same classes grow together in one ``fit_trees`` call, a lane
    a column: each lane's statistics are zero on the column's absent rows
    (they add nothing to any histogram: the sums are the one-column fit's
    integer counts) and its node mask keeps it on its own column, so each
    lane's thresholds equal the one-column fit's.  Returns each column's
    sorted thresholds (f64; empty where it has no present row or no
    split)."""
    from ..models.trees import bin_data, build_bin_splits, fit_trees
    values = np.asarray(values, np.float64)
    present = np.asarray(present, bool)
    y = np.asarray(y)
    N, K = values.shape
    dev = resolve_device(device)
    out = [np.asarray([], np.float64) for _ in range(K)]
    groups: Dict[tuple, List[int]] = {}
    for k in range(K):
        if present[:, k].any():
            key = tuple(np.unique(y[present[:, k]]).tolist())
            groups.setdefault(key, []).append(k)
    for classes, cols in groups.items():
        Kg = len(cols)
        C = max(len(classes), 2)
        splits = np.full((Kg, max_bins - 1), np.inf, np.float32)
        X = np.zeros((N, Kg), np.float32)
        for i, k in enumerate(cols):
            xk = values[present[:, k], k].astype(np.float32)
            splits[i] = build_bin_splits(xk[:, None], max_bins)[0]
            X[present[:, k], i] = xk
        sp = torch.as_tensor(splits, device=dev)
        B = bin_data(torch.as_tensor(X, device=dev), sp)
        pres = torch.as_tensor(present[:, cols].T.copy(), device=dev)
        y_idx = torch.as_tensor(np.searchsorted(np.asarray(classes), y),
                                device=dev).clamp_(0, C - 1)
        w = pres.to(torch.float32)                               # [Kg, N]
        stats = torch.zeros((Kg, N, 1 + C), dtype=torch.float32, device=dev)
        stats[:, :, 0] = w
        stats.scatter_(2, (1 + y_idx)[None, :, None].expand(Kg, N, 1),
                       w[:, :, None])
        node_masks = None
        if Kg > 1:
            own = torch.eye(Kg, dtype=torch.bool, device=dev)[:, None, :]
            node_masks = [own.expand(Kg, 1 << lvl, Kg).contiguous()
                          for lvl in range(max_depth)]
        tree = fit_trees(
            B, sp, stats, torch.ones(Kg, dtype=torch.bool, device=dev),
            max_depth=max_depth, n_bins=max_bins,
            min_instances=torch.full((Kg,), float(min_instances),
                                     device=dev),
            min_gain=torch.full((Kg,), float(min_gain), device=dev),
            impurity="gini", node_masks=node_masks)
        feat = tree.feature.cpu().numpy()
        thr = tree.threshold.cpu().numpy()
        for i, k in enumerate(cols):
            used = thr[i][(feat[i] >= 0) & np.isfinite(thr[i])]
            out[k] = np.unique(used).astype(np.float64)
    return out


def tree_splits_for_feature(x: np.ndarray, y: np.ndarray, *,
                            max_depth: int = DT_BUCKETIZER_MAX_DEPTH,
                            max_bins: int = DT_BUCKETIZER_MAX_BINS,
                            min_instances: int = DT_BUCKETIZER_MIN_INSTANCES,
                            min_gain: float = DT_BUCKETIZER_MIN_INFO_GAIN,
                            device: DeviceLike = None) -> np.ndarray:
    """The split thresholds of a single-feature gini decision tree fit
    against the label — the reference's use of DecisionTreeClassifier's
    splits as bucket boundaries (DecisionTreeNumericBucketizer.scala:
    253-275); every row present."""
    x = np.asarray(x, np.float64)
    if len(x) == 0:
        return np.asarray([], np.float64)
    return tree_splits_for_columns(
        x[:, None], np.ones((len(x), 1), bool), y, max_depth=max_depth,
        max_bins=max_bins, min_instances=min_instances, min_gain=min_gain,
        device=device)[0]


def _fit_kw(stage) -> Dict[str, Any]:
    return dict(
        max_depth=int(stage.get("max_depth", DT_BUCKETIZER_MAX_DEPTH)),
        max_bins=int(stage.get("max_bins", DT_BUCKETIZER_MAX_BINS)),
        min_instances=int(stage.get("min_instances_per_node", 1)),
        min_gain=float(stage.get("min_info_gain", 0.01)))


def _with_bounds(inner: np.ndarray) -> np.ndarray:
    return (np.r_[-np.inf, inner, np.inf] if len(inner)
            else np.asarray([], np.float64))


class DecisionTreeNumericBucketizerModel(TransformerModel):
    out_kind = OPVector
    allow_label_as_input = True
    is_device_op = False

    def transform(self, batch: ColumnBatch) -> Column:
        f = self.input_features[1]
        v, mask = _numeric(batch[f.name])
        track_nulls = self.get("track_nulls", True)
        track_invalid = self.get("track_invalid", False)
        should_split = bool(self.fitted["should_split"])
        splits = np.asarray(self.fitted["splits"], np.float64)
        if should_split:
            out = bucketize_values(v, mask, splits, inclusion="Right",
                                   track_nulls=track_nulls,
                                   track_invalid=track_invalid)
            labels = splits_to_bucket_labels(splits, "Right")
        else:
            # no usable split: the null indicator only (the reference emits
            # an empty vector and the optional null tracking)
            present = np.ones(len(v), bool) if mask is None else mask
            out = ((~present).astype(np.float32)[:, None] if track_nulls
                   else np.zeros((len(v), 0), np.float32))
            labels = []
        meta = _bucket_meta(f.name, f.kind.__name__, self.output_name(),
                            labels, track_nulls,
                            should_split and track_invalid)
        return Column(OPVector, _out(out, batch), meta=meta)


class DecisionTreeNumericBucketizer(Estimator):
    """Buckets a numeric feature at the split points of a single-feature
    decision tree trained against the label (≙
    DecisionTreeNumericBucketizer.scala:60,74).  Inputs (label: RealNN,
    feature: numeric)."""

    in_kinds = (RealNN, OPNumeric)
    out_kind = OPVector
    allow_label_as_input = True

    def __init__(self, max_depth: int = DT_BUCKETIZER_MAX_DEPTH,
                 max_bins: int = DT_BUCKETIZER_MAX_BINS,
                 min_instances_per_node: int = DT_BUCKETIZER_MIN_INSTANCES,
                 min_info_gain: float = DT_BUCKETIZER_MIN_INFO_GAIN,
                 track_nulls: bool = True, track_invalid: bool = True,
                 **params):
        super().__init__(max_depth=max_depth, max_bins=max_bins,
                         min_instances_per_node=min_instances_per_node,
                         min_info_gain=min_info_gain, track_nulls=track_nulls,
                         track_invalid=track_invalid, **params)

    def output_name(self) -> str:
        return f"{self.input_features[1].name}_dtBucketized_{self.uid[-6:]}"

    def fit(self, batch: ColumnBatch) -> DecisionTreeNumericBucketizerModel:
        label_f, f = self.input_features
        y = np.asarray(host_array(batch[label_f.name].values), np.float64)
        x, mask = _numeric(batch[f.name])
        present = np.ones(len(x), bool) if mask is None else mask.copy()
        present &= ~np.isnan(x)
        (inner,) = tree_splits_for_columns(x[:, None], present[:, None], y,
                                           device=batch.device,
                                           **_fit_kw(self))
        model = DecisionTreeNumericBucketizerModel(
            fitted={"should_split": len(inner) > 0,
                    "splits": _with_bounds(inner)}, **self._params)
        return self._finalize_model(model)


def _map_keys_values(col: Column, keys=None):
    """(keys, [N, K] f64 of the map column's values at them, NaN where a key
    is absent or None); ``keys`` None: every key of the column, sorted.
    Through the column's cached expansion (``ops/map_profile``: one native
    walk, shared with MapVectorizer), or one Python pass over the dicts
    where a value is not a number."""
    from .map_profile import map_expansion
    exp = map_expansion(col)
    maps = [v if isinstance(v, dict) else {} for v in col.values]
    if keys is None:
        keys = sorted(exp.keys if exp is not None
                      else {k for m in maps for k in m})
    out = np.full((len(maps), len(keys)), np.nan)
    if exp is not None:
        at = exp.key_index()
        for j, k in enumerate(keys):
            if k in at:
                out[:, j] = exp.vals[:, at[k]]
        return keys, out
    idx = {k: j for j, k in enumerate(keys)}
    for i, m in enumerate(maps):
        for k, v in m.items():
            j = idx.get(k)
            if j is not None and v is not None:
                out[i, j] = float(v)
    return keys, out


class DecisionTreeNumericMapBucketizerModel(TransformerModel):
    out_kind = OPVector
    allow_label_as_input = True
    is_device_op = False

    def transform(self, batch: ColumnBatch) -> Column:
        f = self.input_features[1]
        col = batch[f.name]
        n = len(col)
        track_nulls = self.get("track_nulls", True)
        track_invalid = self.get("track_invalid", False)
        blocks, cols_meta = [], []
        keys, table = _map_keys_values(col, list(self.fitted["keys"]))
        for j, k in enumerate(keys):
            ks = self.fitted["splits_by_key"].get(k)
            vals = table[:, j]
            mask = ~np.isnan(vals)
            split = ks is not None and len(ks) > 0
            if split:
                splits = np.asarray(ks, np.float64)
                blocks.append(bucketize_values(
                    vals, mask, splits, inclusion="Right",
                    track_nulls=track_nulls, track_invalid=track_invalid))
                cols_meta += [VectorColumnMeta(f.name, f.kind.__name__,
                                               grouping=k, indicator_value=lbl)
                              for lbl in splits_to_bucket_labels(splits,
                                                                 "Right")]
                if track_invalid:
                    cols_meta.append(VectorColumnMeta(
                        f.name, f.kind.__name__, grouping=k,
                        indicator_value=INVALID_INDICATOR))
            else:
                blocks.append((~mask).astype(np.float32)[:, None]
                              if track_nulls else np.zeros((n, 0), np.float32))
            # a split key's block ends in its null column already: one null
            # column a key, as the metadata has it (the JAX package's model
            # writes a split key's null column twice, so its block is wider
            # than its metadata)
            if track_nulls:
                cols_meta.append(VectorColumnMeta(
                    f.name, f.kind.__name__, grouping=k,
                    indicator_value=NULL_INDICATOR))
        out = (np.concatenate(blocks, axis=1) if blocks
               else np.zeros((n, 0), np.float32))
        return Column(OPVector, _out(out, batch),
                      meta=VectorMeta(self.output_name(), cols_meta))


class DecisionTreeNumericMapBucketizer(Estimator):
    """Per-key bucketization of a numeric map (≙
    DecisionTreeNumericMapBucketizer.scala): each key's values at its own
    label-driven tree splits, all keys' trees grown in one fit."""

    in_kinds = (RealNN, None)
    out_kind = OPVector
    allow_label_as_input = True

    def __init__(self, max_depth: int = DT_BUCKETIZER_MAX_DEPTH,
                 max_bins: int = DT_BUCKETIZER_MAX_BINS,
                 min_instances_per_node: int = DT_BUCKETIZER_MIN_INSTANCES,
                 min_info_gain: float = DT_BUCKETIZER_MIN_INFO_GAIN,
                 track_nulls: bool = True, track_invalid: bool = False,
                 max_keys: int = 100, **params):
        super().__init__(max_depth=max_depth, max_bins=max_bins,
                         min_instances_per_node=min_instances_per_node,
                         min_info_gain=min_info_gain, track_nulls=track_nulls,
                         track_invalid=track_invalid, max_keys=max_keys,
                         **params)

    def fit(self, batch: ColumnBatch) -> DecisionTreeNumericMapBucketizerModel:
        label_f, f = self.input_features
        y = np.asarray(host_array(batch[label_f.name].values), np.float64)
        keys, vals = _map_keys_values(batch[f.name])
        keep = int(self.get("max_keys", 100))
        keys, vals = keys[:keep], vals[:, :keep]
        inner = tree_splits_for_columns(vals, ~np.isnan(vals), y,
                                        device=batch.device, **_fit_kw(self))
        model = DecisionTreeNumericMapBucketizerModel(
            fitted={"keys": keys,
                    "splits_by_key": {k: _with_bounds(s)
                                      for k, s in zip(keys, inner)}},
            **self._params)
        return self._finalize_model(model)


# --------------------------------------------------------------------------
# percentile calibration
# --------------------------------------------------------------------------

class PercentileCalibratorModel(TransformerModel):
    out_kind = RealNN
    is_device_op = False

    def transform(self, batch: ColumnBatch) -> Column:
        (f,) = self.input_features
        v, _ = _numeric(batch[f.name])
        splits = np.asarray(self.fitted["splits"], np.float64)
        expected = int(self.get("expected_num_buckets", 100))
        actual = len(splits)
        idx = np.searchsorted(splits, v, side="left")
        if actual >= expected:
            out = np.maximum(idx - 1, 0)
        else:
            # the sparser bucket range scaled onto [0, expected - 1]
            # (≙ PercentileCalibratorModel.scale)
            old_max, new_max = max(actual - 1, 1), expected - 1
            out = np.round(idx * (new_max / old_max))
        return Column(RealNN,
                      np.clip(out, 0, expected - 1).astype(np.float32))


class PercentileCalibrator(Estimator):
    """A real-valued score as percentile ranks in [0, expected_num_buckets
    - 1] (≙ PercentileCalibrator.scala; QuantileDiscretizer with
    relativeError 0)."""

    in_kinds = (RealNN,)
    out_kind = RealNN

    def __init__(self, expected_num_buckets: int = 100, **params):
        super().__init__(expected_num_buckets=expected_num_buckets, **params)

    def fit(self, batch: ColumnBatch) -> PercentileCalibratorModel:
        (f,) = self.input_features
        v, _ = _numeric(batch[f.name])
        buckets = int(self.get("expected_num_buckets", 100))
        qs = np.linspace(0.0, 1.0, buckets + 1)[1:-1]
        inner = np.unique(np.quantile(v, qs)) if len(v) else np.asarray([])
        splits = np.r_[-np.inf, inner, np.inf]
        model = PercentileCalibratorModel(
            fitted={"splits": splits, "actual_num_buckets": len(splits)},
            **self._params)
        model.metadata["origSplits"] = [float(s) for s in splits]
        return self._finalize_model(model)


# --------------------------------------------------------------------------
# scaler / descaler
# --------------------------------------------------------------------------

_SCALERS: Dict[str, Tuple[Any, Any]] = {
    # scaling_type -> (forward, inverse); arguments from the stage's params
    "Linear": (lambda v, a: a.get("slope", 1.0) * v + a.get("intercept", 0.0),
               lambda v, a: (v - a.get("intercept", 0.0))
               / a.get("slope", 1.0)),
    "Logarithmic": (lambda v, a: np.log(v), lambda v, a: np.exp(v)),
}


class ScalerTransformer(Transformer):
    """An invertible scaling, its parameters kept so that a
    DescalerTransformer can undo it (≙ ScalerTransformer.scala, Scaler.scala:
    LinearScaler / LogScaler)."""

    in_kinds = (Real,)
    out_kind = Real
    is_device_op = False

    def __init__(self, scaling_type: str = "Linear",
                 scaling_args: Optional[Dict[str, float]] = None, **params):
        if scaling_type not in _SCALERS:
            raise ValueError(f"unknown scaling type {scaling_type!r}")
        scaling_args = dict(scaling_args or {})
        if scaling_type == "Linear" and scaling_args.get("slope", 1.0) == 0.0:
            raise ValueError("LinearScaler must have a non-zero slope")
        super().__init__(scaling_type=scaling_type, scaling_args=scaling_args,
                         **params)

    def transform(self, batch: ColumnBatch) -> Column:
        (f,) = self.input_features
        col = batch[f.name]
        fwd, _ = _SCALERS[self.get("scaling_type")]
        v, _ = _numeric(col)
        return Column(Real, fwd(v, self.get("scaling_args")).astype(np.float32),
                      mask=col.mask)


class DescalerTransformer(Transformer):
    """Undo the scaling of a ScalerTransformer: inputs (the value to
    descale, a feature the scaler made) (≙ DescalerTransformer.scala)."""

    in_kinds = (Real, Real)
    out_kind = Real
    is_device_op = False

    def _find_scaler(self) -> ScalerTransformer:
        origin = self.input_features[1].origin_stage
        if not isinstance(origin, ScalerTransformer):
            raise ValueError(
                "DescalerTransformer input 2 must be produced by a "
                f"ScalerTransformer, got {type(origin).__name__}")
        return origin

    def transform(self, batch: ColumnBatch) -> Column:
        scaler = self._find_scaler()
        col = batch[self.input_features[0].name]
        _, inv = _SCALERS[scaler.get("scaling_type")]
        v, _ = _numeric(col)
        return Column(Real, inv(v, scaler.get("scaling_args")).astype(
            np.float32), mask=col.mask)


# --------------------------------------------------------------------------
# isotonic calibration
# --------------------------------------------------------------------------

def pav_fit(x: np.ndarray, y: np.ndarray, w: Optional[np.ndarray] = None,
            increasing: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Pool-adjacent-violators on (x, y) → (boundaries, values) of the
    fitted step function (≙ Spark ml IsotonicRegression; predictions
    interpolate linearly between boundaries)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    w = np.ones_like(y) if w is None else np.asarray(w, np.float64)
    order = np.argsort(x, kind="mergesort")
    xs, ys, ws = x[order], y[order], w[order]
    if not increasing:
        ys = -ys
    # the block stack: each block's weighted mean, weight and first index
    means: List[float] = []
    weights: List[float] = []
    starts: List[int] = []
    for i in range(len(ys)):
        means.append(float(ys[i]))
        weights.append(float(ws[i]))
        starts.append(i)
        while len(means) > 1 and means[-2] >= means[-1]:
            m2, w2 = means.pop(), weights.pop()
            starts.pop()
            means[-1] = ((means[-1] * weights[-1] + m2 * w2)
                         / (weights[-1] + w2))
            weights[-1] += w2
    bounds, vals = [], []
    starts.append(len(ys))
    for bi in range(len(means)):
        lo, hi = starts[bi], starts[bi + 1] - 1
        v = means[bi] if increasing else -means[bi]
        bounds.append(xs[lo])
        vals.append(v)
        if xs[hi] != xs[lo]:
            bounds.append(xs[hi])
            vals.append(v)
    return np.asarray(bounds), np.asarray(vals)


class IsotonicRegressionCalibratorModel(TransformerModel):
    out_kind = RealNN
    allow_label_as_input = True
    is_device_op = False

    def transform(self, batch: ColumnBatch) -> Column:
        v, _ = _numeric(batch[self.input_features[1].name])
        out = np.interp(v, np.asarray(self.fitted["boundaries"]),
                        np.asarray(self.fitted["predictions"]))
        return Column(RealNN, out.astype(np.float32))


class IsotonicRegressionCalibrator(Estimator):
    """Calibrates scores monotonically against the label: inputs (label:
    RealNN, score: RealNN) → a calibrated RealNN (≙
    IsotonicRegressionCalibrator.scala, wrapping ml.IsotonicRegression)."""

    in_kinds = (RealNN, RealNN)
    out_kind = RealNN
    allow_label_as_input = True

    def __init__(self, isotonic: bool = True, **params):
        super().__init__(isotonic=isotonic, **params)

    def output_name(self) -> str:
        return f"{self.input_features[1].name}_calibrated_{self.uid[-6:]}"

    def fit(self, batch: ColumnBatch) -> IsotonicRegressionCalibratorModel:
        label_f, score_f = self.input_features
        y = np.asarray(host_array(batch[label_f.name].values), np.float64)
        x, _ = _numeric(batch[score_f.name])
        bounds, vals = pav_fit(x, y,
                               increasing=bool(self.get("isotonic", True)))
        model = IsotonicRegressionCalibratorModel(
            fitted={"boundaries": bounds, "predictions": vals},
            **self._params)
        return self._finalize_model(model)
