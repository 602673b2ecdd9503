"""Stage abstractions (port of ``transmogrifai_tpu/stages/base.py``;
reference: OpPipelineStages.scala:55 and the Unary/Binary/Sequence bases).

Stages operate on columns: a ``Transformer`` maps a ``ColumnBatch`` to its
output ``Column``; ``Estimator.fit`` returns a fitted ``TransformerModel``.
Arity is data: ``set_input(*features)`` + ``in_kinds`` validation.  The
persistence hooks (``ctor_args``, ``to_json``, ``save_extra`` /
``load_extra``; JAX :129-143), the placement flags ``ScoreProgram`` reads
(``is_device_op`` / ``supports_staging``; JAX :159-167) and the one-row
``transform_row`` of local scoring (JAX :200-220) are the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Type

from ..columns import Column, ColumnBatch, column_from_values
from ..device import DeviceLike
from ..features import Feature, make_uid
from ..types import FeatureType


class PipelineStage:
    """Base of all stages (≙ OpPipelineStageBase)."""

    in_kinds: Optional[Tuple] = None
    out_kind: Type[FeatureType] = FeatureType
    num_outputs: int = 1
    # stages that legitimately consume the label (models, sanity checker)
    # mark their outputs as predictors (≙ AllowLabelAsInput)
    allow_label_as_input: bool = False

    def __init__(self, **params):
        self.uid = params.pop("uid", None) or make_uid(type(self).__name__)
        self._params: Dict[str, Any] = dict(params)
        self.input_features: Tuple[Feature, ...] = ()
        self._output: Optional[Any] = None

    # ---- params ------------------------------------------------------------
    def get(self, name: str, default=None):
        return self._params.get(name, default)

    def set(self, name: str, value) -> "PipelineStage":
        self._params[name] = value
        return self

    @property
    def params(self) -> Dict[str, Any]:
        return dict(self._params)

    @property
    def operation_name(self) -> str:
        return type(self).__name__

    # ---- wiring ------------------------------------------------------------
    def set_input(self, *features: Feature) -> "PipelineStage":
        self._check_input_kinds(features)
        self.input_features = tuple(features)
        self._output = None
        return self

    def _check_input_kinds(self, features: Sequence[Feature]):
        if self.in_kinds is None:
            return
        if len(self.in_kinds) != len(features):
            raise ValueError(
                f"{self.operation_name} expects {len(self.in_kinds)} inputs, "
                f"got {len(features)}")
        for i, (f, want) in enumerate(zip(features, self.in_kinds)):
            if want is not None and not issubclass(f.kind, want):
                raise TypeError(
                    f"{self.operation_name} input {i} ({f.name!r}) must be "
                    f"{want.__name__}, got {f.kind.__name__}")

    def output_name(self) -> str:
        base = "-".join(f.name for f in self.input_features[:3]) or "out"
        return f"{base}_{self.operation_name}_{self.uid[-6:]}"

    def output_is_response(self) -> bool:
        # ≙ reference default outputIsResponse = inputs.exists(_.isResponse)
        if self.allow_label_as_input:
            return False
        return any(f.is_response for f in self.input_features)

    def get_output(self) -> Feature:
        if self._output is None:
            if not self.input_features:
                raise ValueError(
                    f"{self.operation_name}: set_input before get_output")
            self._output = Feature(
                name=self.output_name(), kind=self.out_kind,
                is_response=self.output_is_response(), origin_stage=self,
                parents=self.input_features)
        return self._output

    @property
    def output_features(self) -> Tuple[Feature, ...]:
        return (self.get_output(),)

    # ---- serialization -----------------------------------------------------
    def ctor_args(self) -> Dict[str, Any]:
        """The constructor parameters a bundle stores (≙ ctor args by
        reflection, OpPipelineStageReaderWriter.scala)."""
        return dict(self._params)

    def to_json(self) -> Dict[str, Any]:
        from .serialization import stage_to_json
        return stage_to_json(self)

    def save_extra(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(JSON, named arrays) of nested state a bundle stores beside the
        stage (``SelectedModel``'s winner); read back by ``load_extra``."""
        return {}, {}

    def load_extra(self, extra_json: Dict[str, Any],
                   arrays: Dict[str, Any]) -> None:
        pass

    def __repr__(self):
        return f"{self.operation_name}({self.uid})"


class Transformer(PipelineStage):
    """A fitted/stateless column function (≙ OpTransformer).

    ``is_device_op``: the transform reads device-ready columns (numbers,
    vectors) and writes device tensors, so ``ScoreProgram`` runs it inside
    a device segment.  ``supports_staging``: a host-input stage whose
    transform lowers its strings on the host and then writes its block on
    the device (the text, pivot and map vectorizers), so it joins a device
    segment when its inputs are made before the segment."""

    is_device_op: bool = True
    supports_staging: bool = False

    def transform(self, batch: ColumnBatch) -> Column:
        raise NotImplementedError

    def transform_batch(self, batch: ColumnBatch) -> ColumnBatch:
        return batch.with_columns({self.get_output().name:
                                   self.transform(batch)})

    def transform_row(self, row: Dict[str, Any],
                      device: DeviceLike = None) -> FeatureType:
        """One record's output for local scoring: the inputs as a one-row
        batch on ``device`` through ``transform``, row 0 back as a typed
        value."""
        cols = {}
        for f in self.input_features:
            v = row[f.name]
            val = v.value if isinstance(v, FeatureType) else v
            cols[f.name] = column_from_values(f.kind, [val])
        return self.transform(ColumnBatch(cols, 1, device)).row_value(0)


class LambdaTransformer(Transformer):
    """A user's column function as a stage (≙ Unary/Binary/...
    LambdaTransformer; JAX :250-268): ``fn`` receives the input columns
    positionally and returns the output ``Column``.  Other keyword
    arguments are stage params."""

    def __init__(self, fn: Callable[..., Column],
                 out_kind: Type[FeatureType], name: Optional[str] = None,
                 **params):
        super().__init__(**params)
        self.fn = fn
        self.out_kind = out_kind
        self._name = name

    @property
    def operation_name(self) -> str:
        return self._name or f"Lambda[{getattr(self.fn, '__name__', 'fn')}]"

    def transform(self, batch: ColumnBatch) -> Column:
        return self.fn(*(batch[f.name] for f in self.input_features))


class TransformerModel(Transformer):
    """A fitted transformer produced by an Estimator; fitted state lives in
    ``self.fitted`` (tensors, numpy arrays and plain values)."""

    def __init__(self, **params):
        fitted = params.pop("fitted", None)
        super().__init__(**params)
        self.fitted: Dict[str, Any] = fitted or {}
        self.metadata: Dict[str, Any] = {}

    def place_fitted(self, device) -> None:
        """Turn the host arrays a bundle gave ``fitted`` into what the
        transform reads, on ``device``.  Stages whose fitted state is plain
        JSON and host index arrays keep it as loaded."""


class Estimator(PipelineStage):
    """Fits on a batch to produce a TransformerModel (≙ OpEstimator)."""

    def fit(self, batch: ColumnBatch) -> TransformerModel:
        raise NotImplementedError

    def _finalize_model(self, model: TransformerModel) -> TransformerModel:
        model.uid = self.uid + "_model"
        model.input_features = self.input_features
        model._output = self._output  # share output feature nodes
        return model
