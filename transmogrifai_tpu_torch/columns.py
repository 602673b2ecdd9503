"""Columnar data for the port (rewrite of ``transmogrifai_tpu/columns.py``).

A ``ColumnBatch`` is an ordered mapping of feature name → ``Column``.  Raw
columns hold numpy arrays on the host; stage outputs hold ``torch.Tensor``s on
the batch's device.  The batch carries that device, so every stage that moves
host data to the device knows where to put it.  A batch given no device means
CUDA, under the entry points' rule (:func:`..device.resolve_device`).

Unlike the JAX package there is no bf16 wire or bf16 matrix storage and no
transfer cache: values cross to the device once, as exact f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Type

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .sparse.matrix import SparseMatrix
from .types import (Binary, Date, DateTime, FeatureType, Integral, OPVector,
                    Prediction, is_numeric_kind, is_text_kind)
from .vector_meta import VectorMeta


def to_device_f32(values, device: DeviceLike):
    """Exact f32 tensor of ``values`` on ``device`` (≙ ``to_device_f32``,
    minus the TPU bf16 wire).  A tensor already there passes through, and so
    does a ``SparseMatrix`` (moved to ``device``, never densified); ``None``
    means CUDA and raises where CUDA is absent."""
    device = resolve_device(device)
    if isinstance(values, SparseMatrix):
        return values.to(device)
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(values, dtype=np.float32),
                           device=device)


def host_array(values) -> np.ndarray:
    """``values`` as a numpy array on the host (a tensor is copied back)."""
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def device_matrix(values, device: DeviceLike):
    """Contiguous f32 feature matrix on ``device`` (≙ ``device_matrix``); a
    ``SparseMatrix`` stays sparse."""
    m = to_device_f32(values, device)
    return m if isinstance(m, SparseMatrix) else m.contiguous()


@dataclass
class Column:
    """A typed column of N rows.

    * numeric kinds — ``values``: numpy [N] or tensor [N]; ``mask``: bool [N]
      (True = present), None for non-nullable kinds.
    * text kinds    — ``values``: numpy object array [N] of str | None (host).
    * maps, lists   — ``values``: numpy object array [N] of dict / list (host).
    * OPVector      — ``values``: f32 tensor [N, D] or a ``SparseMatrix``
      (wide hashed text); ``meta``: VectorMeta.
    * Prediction    — ``values``: dict with 'prediction' [N] and optionally
      'probability' / 'rawPrediction' [N, 2] tensors.
    """

    kind: Type[FeatureType]
    values: Any
    mask: Optional[Any] = None
    meta: Optional[VectorMeta] = None

    def __len__(self) -> int:
        if isinstance(self.values, dict):
            return len(self.values["prediction"])
        return len(self.values)

    def is_host_object(self) -> bool:
        """True for host-side object columns (text, maps, lists): strings and
        dicts never reach the device; a fitted vectorizer lowers them."""
        return (isinstance(self.values, np.ndarray)
                and self.values.dtype == object)

    def row_value(self, i: int) -> FeatureType:
        """Row ``i`` as a typed value (≙ ``Column.row_value``,
        ``transmogrifai_tpu/columns.py:224``; the local-scoring path)."""
        k = self.kind
        if isinstance(self.values, dict):
            d = {"prediction": float(host_array(self.values["prediction"][i]))}
            for base in ("probability", "rawPrediction"):
                if base in self.values:
                    for j, v in enumerate(host_array(self.values[base][i])):
                        d[f"{base}_{j}"] = float(v)
            return Prediction(d)
        if issubclass(k, OPVector):
            if isinstance(self.values, SparseMatrix):
                return OPVector(self.values.dense_rows([i])[0].tolist())
            return OPVector(host_array(self.values[i]).tolist())
        if self.is_host_object():
            return k(self.values[i])
        v = host_array(self.values[i])
        if self.mask is not None and not bool(host_array(self.mask[i])):
            return k(None)
        if issubclass(k, Integral):
            return k(int(v))
        if issubclass(k, Binary):
            return k(bool(v))
        return k(float(v))


class ColumnBatch:
    """Ordered name → Column mapping; the working set of a workflow run."""

    def __init__(self, columns: Optional[Dict[str, Column]] = None,
                 length: Optional[int] = None, device=None):
        self._cols: Dict[str, Column] = dict(columns or {})
        self._length = length
        if self._length is None and self._cols:
            self._length = len(next(iter(self._cols.values())))
        self._device = device

    @property
    def device(self) -> torch.device:
        """Where stage outputs go: the device given, else CUDA (raises
        where CUDA is absent, never drops to the CPU)."""
        return resolve_device(self._device)

    def __len__(self) -> int:
        return self._length or 0

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> Column:
        return self._cols[name]

    def get(self, name: str) -> Optional[Column]:
        return self._cols.get(name)

    def names(self) -> List[str]:
        return list(self._cols)

    def items(self):
        return self._cols.items()

    def _like(self, cols: Dict[str, Column]) -> "ColumnBatch":
        return ColumnBatch(cols, self._length, self._device)

    def on(self, device) -> "ColumnBatch":
        """The same columns, with stage outputs going to ``device``."""
        return ColumnBatch(self._cols, self._length, device)

    def with_columns(self, cols: Dict[str, Column]) -> "ColumnBatch":
        new = dict(self._cols)
        new.update(cols)
        out = self._like(new)
        if out._length is None and cols:
            out._length = len(next(iter(cols.values())))
        return out

    def take_rows(self, idx) -> "ColumnBatch":
        """The rows ``idx`` (an integer array) of every column, in that
        order."""
        idx = np.asarray(idx, dtype=np.int64)

        def take(v):
            if v is None:
                return None
            if isinstance(v, dict):
                return {k: take(a) for k, a in v.items()}
            if isinstance(v, SparseMatrix):
                return v.take_rows(idx)
            if isinstance(v, torch.Tensor):
                return v[torch.as_tensor(idx, device=v.device)]
            return np.asarray(v)[idx]

        return ColumnBatch({n: Column(c.kind, take(c.values), take(c.mask),
                                      c.meta)
                            for n, c in self._cols.items()}, len(idx),
                           self._device)

    def select(self, names: Sequence[str]) -> "ColumnBatch":
        return self._like({n: self._cols[n] for n in names})

    def drop(self, names: Sequence[str]) -> "ColumnBatch":
        drop = set(names)
        return self._like({n: c for n, c in self._cols.items()
                           if n not in drop})


def prediction_column(prediction, probability=None,
                      raw_prediction=None) -> Column:
    values: Dict[str, Any] = {"prediction": prediction}
    if probability is not None:
        values["probability"] = probability
    if raw_prediction is not None:
        values["rawPrediction"] = raw_prediction
    return Column(Prediction, values)


def numeric_column(kind: Type[FeatureType], values: Iterable) -> Column:
    """A numeric column from Python values with Nones (≙ ``numeric_column``,
    ``transmogrifai_tpu/columns.py:271``): f32 values (NaN where empty) and a
    presence mask; integral and date kinds store int64, binary bool."""
    vals = list(values)
    mask = np.array([v is not None for v in vals], dtype=bool)
    if issubclass(kind, (Date, DateTime, Integral)):
        cast, zero, dtype = int, 0, np.int64
    elif issubclass(kind, Binary):
        cast, zero, dtype = bool, False, bool
    else:
        cast, zero, dtype = float, np.nan, np.float32
    arr = np.array([zero if v is None else cast(v) for v in vals], dtype=dtype)
    if kind.non_nullable and not mask.all():
        raise ValueError(f"{kind.__name__} column has {int((~mask).sum())} "
                         "empty values")
    return Column(kind, arr, mask=None if kind.non_nullable else mask)


def text_column(kind: Type[FeatureType], values: Iterable) -> Column:
    """Object column of str | None; the empty string is null."""
    return Column(kind, np.array([None if v is None or v == "" else str(v)
                                  for v in values], dtype=object))


def object_column(kind: Type[FeatureType], values: Iterable) -> Column:
    """Object column of the values as given (maps, lists)."""
    return Column(kind, np.array(list(values) + [None], dtype=object)[:-1])


def column_from_values(kind: Type[FeatureType], values: Iterable) -> Column:
    """A column of ``kind`` from Python values (≙ ``column_from_values``,
    ``transmogrifai_tpu/columns.py:327``)."""
    if is_numeric_kind(kind):
        return numeric_column(kind, values)
    if is_text_kind(kind):
        return text_column(kind, values)
    if issubclass(kind, OPVector):
        rows = [None if v is None else np.asarray(v, dtype=np.float32)
                for v in values]
        dim = next((len(r) for r in rows if r is not None and len(r)), 0)
        arr = np.zeros((len(rows), dim), dtype=np.float32)
        for i, r in enumerate(rows):
            if r is not None and len(r):
                arr[i] = r
        return Column(OPVector, arr)
    return object_column(kind, values)
