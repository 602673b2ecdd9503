"""VectorsCombiner — assemble feature vectors and merge their lineage
metadata (port of ``transmogrifai_tpu/ops/combiner.py``; reference:
VectorsCombiner.scala).  A concat on the device; metadata flattening mirrors
OpVectorMetadata.flatten.  Any sparse input block makes the output a
``SparseMatrix`` with the same column layout and metadata."""

from __future__ import annotations

import torch

from ..columns import Column, ColumnBatch, to_device_f32
from ..sparse.matrix import SparseMatrix
from ..stages.base import Transformer
from ..types import OPVector
from ..vector_meta import VectorColumnMeta, VectorMeta


class VectorsCombiner(Transformer):
    out_kind = OPVector

    def output_name(self) -> str:
        return f"features_{self.uid[-6:]}"

    def transform(self, batch: ColumnBatch) -> Column:
        arrays, metas = [], []
        for f in self.input_features:
            col = batch[f.name]
            v = to_device_f32(col.values, batch.device)
            if v.ndim == 1:
                v = v[:, None]
            arrays.append(v)
            metas.append(col.meta if col.meta is not None else VectorMeta(
                f.name, [VectorColumnMeta(f.name, f.kind.__name__)
                         for _ in range(v.shape[1])]))
        meta = self._flat_meta(metas)
        if any(isinstance(a, SparseMatrix) for a in arrays):
            # dense blocks contribute their nonzero cells at the column
            # offsets of the dense concat (≙ ``_transform_sparse``,
            # combiner.py:61-86)
            from ..sparse.transform import combine_blocks
            return Column(OPVector, combine_blocks(arrays, len(batch),
                                                   device=batch.device),
                          meta=meta)
        return Column(OPVector, torch.cat(arrays, dim=1).contiguous(),
                      meta=meta)

    def _flat_meta(self, metas) -> VectorMeta:
        """``VectorMeta.flatten`` of the blocks' metadata, kept while every
        block hands back the same metadata object, as a fitted vectorizer
        does on every batch: re-indexing 100,003 hash columns costs ~0.4 s
        of host time a call, whatever the batch's rows."""
        cached = getattr(self, "_meta_cache", None)
        if cached is not None and len(cached[0]) == len(metas) and all(
                a is b for a, b in zip(cached[0], metas)):
            return cached[1]
        meta = VectorMeta.flatten(self.output_name(), metas)
        self._meta_cache = (tuple(metas), meta)
        return meta
