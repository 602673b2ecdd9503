"""Predictor stage bases (port of ``transmogrifai_tpu/models/base.py``;
reference: OpPredictorWrapper.scala:67).

Every model estimator takes (label: RealNN, features: OPVector) and produces a
``Prediction`` column.  Array-level ``fit_arrays`` / ``fit_arrays_grid`` are
the entry points the ModelSelector's CV grid calls directly, so the
(fold × grid) training runs as batched lanes on the device.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Tuple, Type

import numpy as np
import torch

from ..columns import Column, ColumnBatch, device_matrix, prediction_column
from ..stages.base import Estimator, TransformerModel
from ..types import OPVector, Prediction, RealNN


def extract_xy(batch: ColumnBatch, label_feature, features_feature
               ) -> Tuple[Any, np.ndarray]:
    """(X [N, D] on the batch's device — a contiguous f32 tensor, or a
    ``SparseMatrix`` left sparse — and y [N] f32 numpy)."""
    y = np.asarray(batch[label_feature.name].values, dtype=np.float32)
    return device_matrix(batch[features_feature.name].values,
                         batch.device), y


class PredictionModel(TransformerModel):
    """Base fitted model: ``device_scores`` on the feature matrix → a
    Prediction column (≙ OpPredictionModel)."""

    in_kinds = (RealNN, OPVector)
    out_kind = Prediction
    allow_label_as_input = True

    def device_scores(self, X: torch.Tensor, full: bool = False
                      ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def place_fitted(self, device) -> None:
        """A bundle's arrays as the tensors ``device_scores`` reads, by
        ``convert``'s table of what each model reads; what the port derives
        from them (the walk's packed nodes, LOCO's node records) is rebuilt
        on use."""
        from ..convert import _model_fitted
        self.fitted = _model_fitted(type(self).__name__, self.fitted, device)

    def transform(self, batch: ColumnBatch) -> Column:
        X = device_matrix(batch[self.input_features[1].name].values,
                          batch.device)
        out = self.device_scores(X, full=True)
        return prediction_column(out["prediction"], out.get("probability"),
                                 out.get("rawPrediction"))


class PredictorEstimator(Estimator):
    """Base model estimator (label, features) → PredictionModel."""

    in_kinds = (RealNN, OPVector)
    out_kind = Prediction
    allow_label_as_input = True
    model_cls: Type[PredictionModel] = PredictionModel

    def fit_arrays(self, X, y, sample_weight=None,
                   device=None) -> Dict[str, Any]:
        """Array-level fit → the ``fitted`` dict of the model."""
        raise NotImplementedError

    def fit_arrays_grid(self, X, y, fold_weights, grids,
                        device=None) -> list:
        """Batched (fold × grid-point) training: fitted dicts indexed
        ``[fold][grid_point]``; ``fold_weights`` [F, N] are per-fold row
        weights over the SAME matrix (0 == held out).  This default fits
        each (fold, grid point) in turn with the fold's weights as
        ``sample_weight`` (≙ ``PredictorEstimator.fit_arrays_grid``,
        base.py:142-166); the linear and tree families batch them."""
        out = []
        for w in fold_weights:
            row = []
            for params in grids:
                est = copy.deepcopy(self)
                for k, v in params.items():
                    est.set(k, v)
                row.append(est.fit_arrays(X, y, sample_weight=w,
                                          device=device))
            out.append(row)
        return out

    def fit(self, batch: ColumnBatch) -> PredictionModel:
        label, feats = self.input_features
        X, y = extract_xy(batch, label, feats)
        model = self.model_cls(fitted=self.fit_arrays(X, y), **self._params)
        return self._finalize_model(model)
