"""Geolocation vectorizer (port of ``transmogrifai_tpu/ops/geo.py``;
reference: GeolocationVectorizer.scala): missing (lat, lon, accuracy)
filled with the train mean, and a null indicator.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..columns import Column, ColumnBatch, host_array
from ..stages.base import Estimator, TransformerModel
from ..types import OPVector
from ..vector_meta import NULL_INDICATOR, VectorColumnMeta, VectorMeta


def _geo_arrays(col: Column) -> tuple:
    """A Geolocation column → ([N, 3] f32, [N] bool presence): host lists
    of (lat, lon, accuracy) or an [N, 3] array with its mask (≙
    ``_geo_arrays``, ``transmogrifai_tpu/ops/geo.py:19``)."""
    if col.is_host_object():
        n = len(col.values)
        arr = np.zeros((n, 3), np.float32)
        mask = np.zeros(n, bool)
        for i, v in enumerate(col.values):
            if v:
                arr[i] = v[:3]
                mask[i] = True
        return arr, mask
    arr = np.asarray(host_array(col.values), np.float32)
    mask = (np.ones(len(arr), bool) if col.mask is None
            else np.asarray(host_array(col.mask), bool))
    return arr, mask


class GeolocationVectorizerModel(TransformerModel):
    out_kind = OPVector
    is_device_op = False

    def transform(self, batch: ColumnBatch) -> Column:
        outs = []
        for k, f in enumerate(self.input_features):
            arr, mask = _geo_arrays(batch[f.name])
            fill = np.asarray(self.fitted["fills"][k], np.float32)
            outs.append(np.where(mask[:, None], arr, fill[None, :]))
            if self.get("track_nulls", True):
                outs.append((~mask).astype(np.float32)[:, None])
        out = np.concatenate(outs, axis=1).astype(np.float32)
        return Column(OPVector, torch.as_tensor(out, device=batch.device),
                      meta=self.fitted["meta"])


class GeolocationVectorizer(Estimator):
    """(lat, lon, accuracy) with the train mean where missing, and a null
    indicator (≙ GeolocationVectorizer.scala); ``fill_mode`` "mean" or
    anything else for zeros."""

    out_kind = OPVector

    def __init__(self, track_nulls: bool = True, fill_mode: str = "mean",
                 **params):
        super().__init__(track_nulls=track_nulls, fill_mode=fill_mode,
                         **params)

    def vector_meta(self) -> VectorMeta:
        """Each input's lat, lon and accuracy columns, then its null
        flag."""
        cols_meta: List[VectorColumnMeta] = []
        for f in self.input_features:
            for d in ("lat", "lon", "accuracy"):
                cols_meta.append(VectorColumnMeta(
                    f.name, f.kind.__name__, descriptor_value=d))
            if self.get("track_nulls", True):
                cols_meta.append(VectorColumnMeta(
                    f.name, f.kind.__name__, indicator_value=NULL_INDICATOR))
        return VectorMeta(self.output_name(), cols_meta)

    def model(self, fills) -> GeolocationVectorizerModel:
        """The fitted model of ``fills`` [F, 3]."""
        return self._finalize_model(GeolocationVectorizerModel(
            fitted={"fills": np.asarray(fills, np.float32),
                    "meta": self.vector_meta()}, **self.params))

    def fit(self, batch: ColumnBatch) -> TransformerModel:
        fills = []
        for f in self.input_features:
            arr, mask = _geo_arrays(batch[f.name])
            if self.get("fill_mode") == "mean" and mask.any():
                fills.append(arr[mask].mean(axis=0))
            else:
                fills.append(np.zeros(3, np.float32))
        return self.model(np.stack(fills))
