"""Temporal vectorizers (port of ``transmogrifai_tpu/ops/dates.py``;
reference: DateToUnitCircleTransformer.scala, DateListVectorizer.scala,
TimePeriodTransformer.scala).

Dates are epoch milliseconds (int64 host columns).  The period's modulo
runs on the host in int64 — epoch milliseconds (~1.5e12) overflow int32 and
lose ~131 s in f32 — and only the fraction of the period, in [0, 1), goes
to the batch's device as f32 for sin / cos.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence

import numpy as np
import torch

from ..columns import Column, ColumnBatch
from ..stages.base import Estimator, Transformer, TransformerModel
from ..types import Integral, OPVector
from ..vector_meta import NULL_INDICATOR, VectorColumnMeta, VectorMeta

_MS_HOUR = 3600 * 1000
_MS_DAY = 24 * _MS_HOUR
_MS_WEEK = 7 * _MS_DAY
# epoch 1970-01-01 was a Thursday; shift so 0 = Monday like ISO
_EPOCH_DOW_SHIFT = 3 * _MS_DAY
_MS_YEAR = int(365.2425 * _MS_DAY)
_MS_MONTH = int(30.44 * _MS_DAY)     # an approximate month, as the reference


def _period_fraction(ms: np.ndarray, period: str) -> np.ndarray:
    """The fraction in [0, 1) of ``period`` (≙ ``_period_fraction``,
    ``transmogrifai_tpu/ops/dates.py:30``): the int64 modulo on the host,
    the small remainder divided in f64 and rounded to f32."""
    ms = np.asarray(ms, np.int64)
    if period == "HourOfDay":
        shift, per = 0, _MS_DAY
    elif period == "DayOfWeek":
        shift, per = _EPOCH_DOW_SHIFT, _MS_WEEK
    elif period == "DayOfMonth":
        shift, per = 0, _MS_MONTH
    elif period == "DayOfYear":
        shift, per = 0, _MS_YEAR
    else:
        raise ValueError(f"unknown time period {period}")
    return (((ms + shift) % per) / per).astype(np.float32)


def _date_values(col: Column):
    """(int64 epoch ms, bool presence) of a date column on the host."""
    v = np.asarray(col.values, np.int64)
    m = (np.ones(len(v), bool) if col.mask is None
         else np.asarray(col.mask, bool))
    return v, m


class DateToUnitCircleModel(TransformerModel):
    out_kind = OPVector
    is_device_op = False       # the int64 host modulo, then device sin / cos

    def transform(self, batch: ColumnBatch) -> Column:
        dev = batch.device
        outs = []
        for f in self.input_features:
            v, m = _date_values(batch[f.name])
            mask = torch.as_tensor(m, device=dev)
            for p in self.get("periods"):
                frac = torch.as_tensor(_period_fraction(v, p), device=dev)
                ang = 2 * math.pi * frac
                outs.append(torch.where(mask, torch.sin(ang), 0.0)[:, None])
                outs.append(torch.where(mask, torch.cos(ang), 0.0)[:, None])
            if self.get("track_nulls", True):
                outs.append((~mask).to(torch.float32)[:, None])
        return Column(OPVector, torch.cat(outs, dim=1),
                      meta=self.fitted["meta"])


class DateToUnitCircleVectorizer(Estimator):
    """sin / cos circular embedding of date periods
    (≙ DateToUnitCircleTransformer + transmogrify's circular-date
    default)."""

    out_kind = OPVector

    def __init__(self, periods: Sequence[str] = ("HourOfDay", "DayOfWeek",
                                                 "DayOfMonth", "DayOfYear"),
                 track_nulls: bool = True, **params):
        super().__init__(periods=list(periods), track_nulls=track_nulls,
                         **params)

    def fit(self, batch: ColumnBatch) -> TransformerModel:
        cols_meta: List[VectorColumnMeta] = []
        for f in self.input_features:
            for p in self.get("periods"):
                cols_meta.append(VectorColumnMeta(
                    f.name, f.kind.__name__, descriptor_value=f"sin({p})"))
                cols_meta.append(VectorColumnMeta(
                    f.name, f.kind.__name__, descriptor_value=f"cos({p})"))
            if self.get("track_nulls", True):
                cols_meta.append(VectorColumnMeta(
                    f.name, f.kind.__name__, indicator_value=NULL_INDICATOR))
        meta = VectorMeta(self.output_name(), cols_meta)
        return self._finalize_model(DateToUnitCircleModel(
            fitted={"meta": meta}, **self.params))


class TimePeriodTransformer(Transformer):
    """Date → integral period value (≙ TimePeriodTransformer.scala); an
    int64 host column."""

    out_kind = Integral
    is_device_op = False

    def __init__(self, period: str = "DayOfWeek", **params):
        super().__init__(period=period, **params)

    def transform(self, batch: ColumnBatch) -> Column:
        (f,) = self.input_features
        col = batch[f.name]
        v = np.asarray(col.values, np.int64)
        p = self.get("period")
        if p == "HourOfDay":
            out = (v % _MS_DAY) // _MS_HOUR
        elif p == "DayOfWeek":
            out = ((v + _EPOCH_DOW_SHIFT) % _MS_WEEK) // _MS_DAY + 1
        elif p == "DayOfMonth":
            out = (v % _MS_MONTH) // _MS_DAY + 1
        elif p == "DayOfYear":
            out = (v % _MS_YEAR) // _MS_DAY + 1
        elif p == "WeekOfYear":
            out = (v % _MS_YEAR) // _MS_WEEK + 1
        elif p == "MonthOfYear":
            out = (v % _MS_YEAR) // _MS_MONTH + 1
        else:
            raise ValueError(f"unknown period {p}")
        return Column(Integral, out, mask=col.mask)


_MODES = {"ModeDay": ("DayOfWeek", 7), "ModeMonth": ("MonthOfYear", 12),
          "ModeHour": ("HourOfDay", 24)}


def _mode_slot(ms: int, name: str) -> int:
    if name == "DayOfWeek":
        return int(((ms + _EPOCH_DOW_SHIFT) % _MS_WEEK) // _MS_DAY)
    if name == "MonthOfYear":
        return int((ms % _MS_YEAR) // _MS_MONTH) % 12
    return int((ms % _MS_DAY) // _MS_HOUR)


class DateListVectorizerModel(TransformerModel):
    out_kind = OPVector
    is_device_op = False

    def transform(self, batch: ColumnBatch) -> Column:
        pivot = self.get("pivot")
        ref = self.get("reference_ms")
        outs = []
        for f in self.input_features:
            lists = batch[f.name].values
            if pivot in ("SinceFirst", "SinceLast"):
                pick = min if pivot == "SinceFirst" else max
                present = np.fromiter((bool(lst) for lst in lists), bool,
                                      len(lists))
                vals = np.fromiter(
                    ((ref - pick(lst)) / _MS_DAY if lst else 0.0
                     for lst in lists), np.float64, len(lists))
                outs.append(vals.astype(np.float32)[:, None])
                if self.get("track_nulls", True):
                    outs.append((~present).astype(np.float32)[:, None])
            else:      # ModeDay / ModeMonth / ModeHour one-hot the mode
                name, width = _MODES[pivot]
                block = np.zeros((len(lists), width), np.float32)
                for i, lst in enumerate(lists):
                    if lst:
                        cnt = Counter(_mode_slot(ms, name) for ms in lst)
                        block[i, cnt.most_common(1)[0][0]] = 1.0
                outs.append(block)
        arr = np.concatenate(outs, axis=1)
        return Column(OPVector, torch.as_tensor(arr, device=batch.device),
                      meta=self.fitted["meta"])


class DateListVectorizer(Estimator):
    """DateList pivots (≙ DateListVectorizer.scala): SinceFirst / SinceLast
    days or a mode-of-period one-hot."""

    out_kind = OPVector

    def __init__(self, pivot: str = "SinceLast",
                 reference_ms: int = 1500000000000, track_nulls: bool = True,
                 **params):
        super().__init__(pivot=pivot, reference_ms=reference_ms,
                         track_nulls=track_nulls, **params)

    def fit(self, batch: ColumnBatch) -> TransformerModel:
        cols_meta: List[VectorColumnMeta] = []
        pivot = self.get("pivot")
        for f in self.input_features:
            if pivot in ("SinceFirst", "SinceLast"):
                cols_meta.append(VectorColumnMeta(
                    f.name, f.kind.__name__, descriptor_value=pivot))
                if self.get("track_nulls", True):
                    cols_meta.append(VectorColumnMeta(
                        f.name, f.kind.__name__,
                        indicator_value=NULL_INDICATOR))
            else:
                for j in range(_MODES[pivot][1]):
                    cols_meta.append(VectorColumnMeta(
                        f.name, f.kind.__name__,
                        descriptor_value=f"{pivot}_{j}"))
        meta = VectorMeta(self.output_name(), cols_meta)
        return self._finalize_model(DateListVectorizerModel(
            fitted={"meta": meta}, **self.params))
