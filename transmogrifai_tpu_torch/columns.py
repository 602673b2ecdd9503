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
from typing import Any, Dict, List, Optional, Sequence, Type

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .types import FeatureType, Prediction
from .vector_meta import VectorMeta


def to_device_f32(values, device: DeviceLike) -> torch.Tensor:
    """Exact f32 tensor of ``values`` on ``device`` (≙ ``to_device_f32``,
    minus the TPU bf16 wire).  A tensor already there passes through;
    ``None`` means CUDA and raises where CUDA is absent."""
    device = resolve_device(device)
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(values, dtype=np.float32),
                           device=device)


def device_matrix(values, device: DeviceLike) -> torch.Tensor:
    """Contiguous f32 feature matrix on ``device`` (≙ ``device_matrix``)."""
    return to_device_f32(values, device).contiguous()


@dataclass
class Column:
    """A typed column of N rows.

    * numeric kinds — ``values``: numpy [N] or tensor [N]; ``mask``: bool [N]
      (True = present), None for non-nullable kinds.
    * OPVector      — ``values``: f32 tensor [N, D]; ``meta``: VectorMeta.
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
