"""Set vectorizers (port of ``transmogrifai_tpu/ops/collections.py``;
reference: OpSetVectorizer.scala): the top-K membership pivot of
MultiPickList sets with OTHER and null slots.
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
from .categorical import top_values_by_count


class MultiPickListVectorizerModel(TransformerModel):
    out_kind = OPVector
    is_device_op = False

    def transform(self, batch: ColumnBatch) -> Column:
        track_other = self.get("track_other", True)
        track_nulls = self.get("track_nulls", True)
        outs = []
        for f in self.input_features:
            vocab: Dict[str, int] = self.fitted["vocabs"][f.name]
            sets = batch[f.name].values
            width = len(vocab) + int(track_other) + int(track_nulls)
            block = np.zeros((len(sets), width), np.float32)
            other_col = len(vocab) if track_other else None
            for i, s in enumerate(sets):
                if not s:
                    if track_nulls:
                        block[i, width - 1] = 1.0
                    continue
                for v in s:
                    j = vocab.get(v)
                    if j is not None:
                        block[i, j] = 1.0
                    elif other_col is not None:
                        block[i, other_col] = 1.0
            outs.append(block)
        arr = np.concatenate(outs, axis=1)
        return Column(OPVector, torch.as_tensor(arr, device=batch.device),
                      meta=self.fitted["meta"])


class MultiPickListVectorizer(Estimator):
    """Top-K membership pivot of MultiPickList sets with OTHER and null
    slots (≙ OpSetVectorizer)."""

    out_kind = OPVector

    def __init__(self, top_k: int = 20, min_support: int = 10,
                 track_nulls: bool = True, track_other: bool = True,
                 **params):
        super().__init__(top_k=top_k, min_support=min_support,
                         track_nulls=track_nulls, track_other=track_other,
                         **params)

    def model(self, tops: Dict[str, List[str]]
              ) -> MultiPickListVectorizerModel:
        """The fitted model of each input's top values ``tops`` (by feature
        name, most frequent first): its pivot columns, OTHER, null."""
        cols_meta: List[VectorColumnMeta] = []
        for f in self.input_features:
            for v in tops[f.name]:
                cols_meta.append(VectorColumnMeta(
                    f.name, f.kind.__name__, indicator_value=v))
            if self.get("track_other", True):
                cols_meta.append(VectorColumnMeta(
                    f.name, f.kind.__name__, indicator_value=OTHER_INDICATOR))
            if self.get("track_nulls", True):
                cols_meta.append(VectorColumnMeta(
                    f.name, f.kind.__name__, indicator_value=NULL_INDICATOR))
        vocabs = {f.name: {v: i for i, v in enumerate(tops[f.name])}
                  for f in self.input_features}
        return self._finalize_model(MultiPickListVectorizerModel(
            fitted={"vocabs": vocabs,
                    "meta": VectorMeta(self.output_name(), cols_meta)},
            **self.params))

    def fit(self, batch: ColumnBatch) -> TransformerModel:
        tops: Dict[str, List[str]] = {}
        for f in self.input_features:
            counts = Counter()
            for s in batch[f.name].values:
                counts.update(s or ())
            tops[f.name] = top_values_by_count(counts, self.get("top_k"),
                                               self.get("min_support"))
        return self.model(tops)
