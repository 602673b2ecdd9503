"""Numeric vectorizers (port of ``transmogrifai_tpu/ops/numeric.py``;
reference: RealVectorizer.scala, RealNNVectorizer.scala).

Fit = a masked-mean reduction; transform = fill + null-indicator concat.
These are sequence stages: one stage vectorizes many features of the same
kind into a single [N, D] block with per-column lineage metadata.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..columns import Column, ColumnBatch, to_device_f32
from ..stages.base import Estimator, TransformerModel
from ..types import OPVector
from ..vector_meta import NULL_INDICATOR, VectorColumnMeta, VectorMeta


def _masked_f32(col: Column, device):
    v = to_device_f32(col.values, device)
    m = (torch.ones(v.shape[0], dtype=torch.bool, device=device)
         if col.mask is None else torch.as_tensor(col.mask, device=device))
    return v, m


def _masked_means(vs, ms) -> torch.Tensor:
    """Every column's masked mean, NaNs treated as 0 (≙ ``_masked_means``,
    ``transmogrifai_tpu/ops/numeric.py:32``)."""
    return torch.stack([
        torch.where(m, torch.nan_to_num(v), 0.0).sum()
        / torch.clamp(m.sum(), min=1)
        for v, m in zip(vs, ms)])


def _value_null_meta(stage) -> VectorMeta:
    """Output lineage: each input's value column, then its null flag."""
    cols_meta: List[VectorColumnMeta] = []
    for f in stage.input_features:
        cols_meta.append(VectorColumnMeta(f.name, f.kind.__name__))
        if stage.get("track_nulls", True):
            cols_meta.append(VectorColumnMeta(
                f.name, f.kind.__name__, indicator_value=NULL_INDICATOR))
    return VectorMeta(stage.output_name(), cols_meta)


class RealVectorizerModel(TransformerModel):
    out_kind = OPVector

    def place_fitted(self, device) -> None:
        self.fitted["fills"] = to_device_f32(self.fitted["fills"], device)

    def transform(self, batch: ColumnBatch) -> Column:
        fills = self.fitted["fills"]
        track_nulls = self.get("track_nulls", True)
        outs = []
        for i, f in enumerate(self.input_features):
            v, m = _masked_f32(batch[f.name], batch.device)
            fill = fills[i].to(batch.device)
            outs.append(torch.where(m, torch.nan_to_num(v), fill)[:, None])
            if track_nulls:
                outs.append((~m).to(torch.float32)[:, None])
        return Column(OPVector, torch.cat(outs, dim=1),
                      meta=self.fitted["meta"])


class RealVectorizer(Estimator):
    """Fill missing reals with the train mean (or a constant) + a null
    indicator (≙ RealVectorizer.scala).  fill_mode: 'mean' | 'constant'."""

    out_kind = OPVector

    def __init__(self, fill_mode: str = "mean", fill_value: float = 0.0,
                 track_nulls: bool = True, **params):
        super().__init__(fill_mode=fill_mode, fill_value=fill_value,
                         track_nulls=track_nulls, **params)

    def vector_meta(self) -> VectorMeta:
        return _value_null_meta(self)

    def fit(self, batch: ColumnBatch) -> TransformerModel:
        if self.get("fill_mode") == "mean":
            pairs = [_masked_f32(batch[f.name], batch.device)
                     for f in self.input_features]
            fills = _masked_means([v for v, _ in pairs], [m for _, m in pairs])
        else:
            fills = torch.full((len(self.input_features),),
                               float(self.get("fill_value")),
                               dtype=torch.float32, device=batch.device)
        model = RealVectorizerModel(
            fitted={"fills": fills, "meta": _value_null_meta(self)}, **self.params)
        return self._finalize_model(model)


class RealNNVectorizerModel(TransformerModel):
    out_kind = OPVector

    def transform(self, batch: ColumnBatch) -> Column:
        outs = [to_device_f32(batch[f.name].values, batch.device)[:, None]
                for f in self.input_features]
        return Column(OPVector, torch.cat(outs, dim=1),
                      meta=self.fitted["meta"])


class RealNNVectorizer(Estimator):
    """Non-nullable reals: straight passthrough into the vector
    (≙ RealNNVectorizer.scala)."""

    out_kind = OPVector

    def fit(self, batch: ColumnBatch) -> TransformerModel:
        meta = VectorMeta(self.output_name(), [
            VectorColumnMeta(f.name, f.kind.__name__)
            for f in self.input_features])
        return self._finalize_model(RealNNVectorizerModel(fitted={"meta": meta}))


class IntegralVectorizerModel(RealVectorizerModel):
    """Filled integrals, as ``RealVectorizerModel`` fills reals (its own class
    name, as the JAX package's bundles name it)."""


class IntegralVectorizer(Estimator):
    """Fill missing integrals with the train mode (most frequent value; the
    smallest of equals) + a null indicator (≙ IntegralVectorizer.scala)."""

    out_kind = OPVector

    def __init__(self, fill_mode: str = "mode", fill_value: int = 0,
                 track_nulls: bool = True, **params):
        super().__init__(fill_mode=fill_mode, fill_value=fill_value,
                         track_nulls=track_nulls, **params)

    def fit(self, batch: ColumnBatch) -> TransformerModel:
        fills = []
        for f in self.input_features:
            col = batch[f.name]
            vals = np.asarray(col.values)
            m = (np.ones(len(vals), bool) if col.mask is None
                 else np.asarray(col.mask))
            if self.get("fill_mode") == "mode" and m.any():
                uniq, counts = np.unique(vals[m], return_counts=True)
                fills.append(float(uniq[np.argmax(counts)]))
            else:
                fills.append(float(self.get("fill_value")))
        meta = _value_null_meta(self)
        return self._finalize_model(IntegralVectorizerModel(fitted={
            "fills": torch.tensor(fills, dtype=torch.float32,
                                  device=batch.device),
            "meta": meta}, **self.params))


class BinaryVectorizerModel(TransformerModel):
    out_kind = OPVector

    def transform(self, batch: ColumnBatch) -> Column:
        outs = []
        for f in self.input_features:
            v, m = _masked_f32(batch[f.name], batch.device)
            outs.append(torch.where(m, v, 0.0)[:, None])
            if self.get("track_nulls", True):
                outs.append((~m).to(torch.float32)[:, None])
        return Column(OPVector, torch.cat(outs, dim=1),
                      meta=self.fitted["meta"])


class BinaryVectorizer(Estimator):
    """Booleans → {0, 1} + a null indicator (≙ BinaryVectorizer.scala)."""

    out_kind = OPVector

    def __init__(self, track_nulls: bool = True, **params):
        super().__init__(track_nulls=track_nulls, **params)

    def fit(self, batch: ColumnBatch) -> TransformerModel:
        return self._finalize_model(BinaryVectorizerModel(
            fitted={"meta": _value_null_meta(self)}, **self.params))
