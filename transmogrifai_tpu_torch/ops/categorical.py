"""Categorical pivots (port of the one-hot part of
``transmogrifai_tpu/ops/categorical.py``; reference:
OpOneHotVectorizer.scala).

Fit finds each feature's top-K values by count (with a minimum support);
transform encodes strings to vocabulary ids on the host through the cached
column profile, and the one-hot expansion is a comparison on the device.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from ..columns import Column, ColumnBatch
from ..stages.base import Estimator, TransformerModel
from ..types import OPVector
from ..vector_meta import (NULL_INDICATOR, OTHER_INDICATOR, VectorColumnMeta,
                           VectorMeta)


def _col_strings(col: Column) -> np.ndarray:
    """Host view of a text-ish column as an object array of str | None."""
    if col.is_host_object():
        return col.values
    vals = np.asarray(col.values).astype(str)
    if col.mask is not None:
        out = vals.astype(object)
        out[~np.asarray(col.mask)] = None
        return out
    return vals.astype(object)


def top_values_by_count(counts, top_k: int, min_support: int) -> List[str]:
    """The reference's top values (SmartTextVectorizer.scala:97-100,
    OpOneHotVectorizer): drop values below ``min_support``, order by (count
    desc, value asc), take ``top_k``.  The order is the pivot's column
    layout, most frequent value first."""
    eligible = [(v, c) for v, c in counts.items() if c >= min_support]
    eligible.sort(key=lambda vc: (-vc[1], vc[0]))
    return [v for v, _ in eligible[:top_k]]


def encode_with_vocab(values, vocab: Dict[str, int],
                      other_id: int) -> np.ndarray:
    """strings → int ids: unseen → ``other_id``, None → ``other_id + 1``."""
    null_id = other_id + 1
    out = np.full(len(values), other_id, dtype=np.int32)
    for i, v in enumerate(values):
        out[i] = null_id if v is None else vocab.get(v, other_id)
    return out


def encode_column(col: Column, vocab: Dict[str, int],
                  other_id: int) -> np.ndarray:
    """``encode_with_vocab`` through the cached column profile: one table
    lookup over the interned codes instead of a dict probe per row."""
    if not col.is_host_object():
        return encode_with_vocab(_col_strings(col), vocab, other_id)
    from .text_profile import column_profile
    iv = column_profile(col).values(-1)
    if not iv.uniq:    # all-null column
        return np.full(len(iv.codes), other_id + 1, np.int32)
    table = np.fromiter((vocab.get(v, other_id) for v in iv.uniq), np.int32,
                        count=len(iv.uniq))
    return np.where(iv.codes < 0, np.int32(other_id + 1),
                    table[np.maximum(iv.codes, 0)]).astype(np.int32)


def one_hot(ids: np.ndarray, cols, device) -> torch.Tensor:
    """[N, len(cols)] f32 indicators ``ids == cols[j]``, expanded on the
    device from the narrowest id type."""
    wire = ids.astype(np.uint8) if ids.max(initial=0) < 256 else ids
    idsd = torch.from_numpy(wire).to(device).to(torch.int32)
    cols_d = torch.as_tensor(np.asarray(cols, np.int32), device=device)
    return (idsd[:, None] == cols_d[None, :]).to(torch.float32)


class OneHotModel(TransformerModel):
    out_kind = OPVector
    # host vocabulary lookup, then the one-hot block on the device
    is_device_op = False
    supports_staging = True

    def transform(self, batch: ColumnBatch) -> Column:
        track_other = self.get("track_other", True)
        track_nulls = self.get("track_nulls", True)
        outs = []
        for f in self.input_features:
            vocab: Dict[str, int] = self.fitted["vocabs"][f.name]
            other_id = len(vocab)
            ids = encode_column(batch[f.name], vocab, other_id)
            # the encoding is [vocab..., OTHER, NULL]; keep the tracked
            # slots so the columns line up with the meta
            cols = list(range(other_id))
            if track_other:
                cols.append(other_id)
            if track_nulls:
                cols.append(other_id + 1)
            outs.append(one_hot(ids, cols, batch.device))
        out = (torch.cat(outs, dim=1) if outs else
               torch.zeros((len(batch), 0), device=batch.device))
        return Column(OPVector, out, meta=self.fitted["meta"])


class OneHotEstimator(Estimator):
    """Pivot the top-K values into indicator columns with OTHER and null
    slots (≙ OpOneHotVectorizer / OneHotEstimator)."""

    out_kind = OPVector

    def __init__(self, top_k: int = 20, min_support: int = 10,
                 track_nulls: bool = True, track_other: bool = True,
                 max_pct_cardinality: float = 1.0, **params):
        super().__init__(top_k=top_k, min_support=min_support,
                         track_nulls=track_nulls, track_other=track_other,
                         max_pct_cardinality=max_pct_cardinality, **params)

    def fit(self, batch: ColumnBatch) -> TransformerModel:
        vocabs: Dict[str, Dict[str, int]] = {}
        cols_meta: List[VectorColumnMeta] = []
        top_k, min_support = self.get("top_k"), self.get("min_support")
        for f in self.input_features:
            col = batch[f.name]
            if col.is_host_object():
                from .text_profile import column_profile
                counts = column_profile(col).values(-1).value_counts()
            else:
                counts = Counter(
                    v for v in _col_strings(col) if v is not None)
            top = top_values_by_count(counts, top_k, min_support)
            vocabs[f.name] = {v: i for i, v in enumerate(top)}
            kind = f.kind.__name__
            cols_meta.extend(VectorColumnMeta(f.name, kind, indicator_value=v)
                             for v in top)
            if self.get("track_other", True):
                cols_meta.append(VectorColumnMeta(
                    f.name, kind, indicator_value=OTHER_INDICATOR))
            if self.get("track_nulls", True):
                cols_meta.append(VectorColumnMeta(
                    f.name, kind, indicator_value=NULL_INDICATOR))
        meta = VectorMeta(self.output_name(), cols_meta)
        return self._finalize_model(OneHotModel(
            fitted={"vocabs": vocabs, "meta": meta}, **self.params))
