"""Map vectorizer for numeric-valued maps (port of the numeric branch of
``transmogrifai_tpu/ops/maps.py``; reference: OPMapVectorizer.scala).

Fit picks the keys (most frequent first, ties by first occurrence, capped at
``max_keys``, then sorted) and each key's mean fill; transform fills absent
values and interleaves a null indicator per key, on the device.  Binary,
date, text, pick-list, multi-pick-list and geolocation maps come with later
slices of the port.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..columns import Column, ColumnBatch
from ..stages.base import Estimator, TransformerModel
from ..types import Binary, Date, OPVector, is_numeric_kind, map_value_kind
from ..vector_meta import NULL_INDICATOR, VectorColumnMeta, VectorMeta
from .map_profile import MapExpansion, map_expansion


def _numeric_value_kind(kind) -> bool:
    vk = map_value_kind(kind)
    return is_numeric_kind(vk) and not issubclass(vk, (Binary, Date))


def _map_values(col) -> List[Dict[str, Any]]:
    return [v if isinstance(v, dict) else {} for v in col.values]


def _numeric_map_arrays(col, keys: List[str], exp: Optional[MapExpansion]):
    """(vals [N, K] f32, presence [N, K] bool) in fitted-key order: from the
    cached expansion, or (values holding bools) by the Python walk, where
    ``float(v)`` reads a bool as 0/1 as the JAX package's fallback does."""
    n, K = len(col), len(keys)
    vals = np.zeros((n, K), np.float32)
    pres = np.zeros((n, K), bool)
    if exp is not None:
        idx = exp.key_index()
        for jj, k in enumerate(keys):
            j = idx.get(k)
            if j is not None:
                vals[:, jj] = exp.vals[:, j]
                pres[:, jj] = exp.present[:, j]
        return vals, pres
    for i, m in enumerate(_map_values(col)):
        for jj, k in enumerate(keys):
            v = m.get(k)
            if v is not None:
                vals[i, jj] = float(v)
                pres[i, jj] = True
    return vals, pres


def _fill_and_interleave(vals: torch.Tensor, pres: torch.Tensor,
                         fills: torch.Tensor, track_nulls: bool):
    """Fill absent values with the key's fill and, with ``track_nulls``,
    interleave [value, null] per key (≙ ``_fill_and_interleave``)."""
    filled = torch.where(pres, vals, fills[None, :])
    if not track_nulls:
        return filled
    return torch.stack([filled, (~pres).to(torch.float32)],
                       dim=2).reshape(vals.shape[0], 2 * vals.shape[1])


class MapVectorizerModel(TransformerModel):
    out_kind = OPVector
    # host key expansion, then the filled block on the device
    is_device_op = False
    supports_staging = True

    def transform(self, batch: ColumnBatch) -> Column:
        (f,) = self.input_features
        col = batch[f.name]
        keys: List[str] = self.fitted["keys"]
        vals, pres = _numeric_map_arrays(col, keys, map_expansion(col))
        dev = batch.device
        fills = torch.as_tensor(np.asarray(
            [self.fitted["fills"].get(k, 0.0) for k in keys], np.float32),
            device=dev)
        out = _fill_and_interleave(torch.from_numpy(vals).to(dev),
                                   torch.from_numpy(pres).to(dev), fills,
                                   self.get("track_nulls", True))
        return Column(OPVector, out, meta=self.fitted["meta"])


class MapVectorizer(Estimator):
    """Per-key expansion of a numeric map feature (≙ OPMapVectorizer)."""

    out_kind = OPVector

    def __init__(self, top_k: int = 20, min_support: int = 10,
                 track_nulls: bool = True, max_keys: int = 100,
                 allow_list: List[str] = None, block_list: List[str] = None,
                 **params):
        super().__init__(top_k=top_k, min_support=min_support,
                         track_nulls=track_nulls, max_keys=max_keys,
                         allow_list=allow_list, block_list=block_list,
                         **params)

    def fit(self, batch: ColumnBatch) -> TransformerModel:
        (f,) = self.input_features
        if not _numeric_value_kind(f.kind):
            raise NotImplementedError(
                f"MapVectorizer: {f.kind.__name__} (values of "
                f"{map_value_kind(f.kind).__name__}) arrives with a later "
                "slice of the port (ROADMAP queue 1 item 7)")
        col = batch[f.name]
        exp = map_expansion(col)
        if exp is not None:
            # in_dict counts key occurrences; the order is (-count, first
            # occurrence), Counter.most_common's
            order = sorted(range(len(exp.keys)),
                           key=lambda j: (-int(exp.in_dict[j]), j))
            top = [exp.keys[j] for j in order[:self.get("max_keys")]]
        else:
            key_counts: Counter = Counter()
            for m in _map_values(col):
                key_counts.update(m.keys())
            top = [k for k, _ in key_counts.most_common(self.get("max_keys"))]
        allow = self.get("allow_list")
        block = set(self.get("block_list") or ())
        keys = sorted(k for k in top
                      if (allow is None or k in allow) and k not in block)
        fills: Dict[str, float] = {}
        if exp is not None:
            idx = exp.key_index()
            for k in keys:
                j = idx[k]
                pres = exp.present[:, j]
                fills[k] = float(exp.vals[pres, j].mean()) if pres.any() \
                    else 0.0
        else:
            maps = _map_values(col)
            for k in keys:
                vals = [float(m[k]) for m in maps if m.get(k) is not None]
                fills[k] = float(np.mean(vals)) if vals else 0.0
        kind = f.kind.__name__
        cols_meta: List[VectorColumnMeta] = []
        for k in keys:
            cols_meta.append(VectorColumnMeta(f.name, kind, grouping=k))
            if self.get("track_nulls", True):
                cols_meta.append(VectorColumnMeta(
                    f.name, kind, grouping=k, indicator_value=NULL_INDICATOR))
        fitted = {"keys": keys, "fills": fills,
                  "meta": VectorMeta(self.output_name(), cols_meta)}
        return self._finalize_model(MapVectorizerModel(fitted=fitted,
                                                       **self.params))
