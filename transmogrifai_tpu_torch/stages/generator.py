"""FeatureGeneratorStage — stage 0 of every DAG (port of
``transmogrifai_tpu/stages/generator.py``; reference:
FeatureGeneratorStage.scala:67).

The stage names and types a raw column and carries ``extract_fn: record →
raw value`` for local scoring (``local.score_function``).  The default
extractor looks the feature's name up in the record.  A custom extractor
given with ``extract_source`` (a Python expression over the record ``r``)
is saved as that text and rebuilt from it on load, as the JAX package does
(JAX :40-45).  The port's workflows take columnar input
(``Workflow.set_input_batch``); monoid aggregation comes with the
aggregators slice, so ``aggregate_window_ms`` is kept and saved but not
acted on.  ``extract_column`` builds a raw column from records with the
monoid zero of a non-nullable kind where a record has no value
(``non_nullable_empty_value``, JAX :19), as the serving engine's batches
and the columnar wire decoder need.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Type

from ..columns import Column, column_from_values
from ..types import FeatureType, Prediction
from .base import PipelineStage


def non_nullable_empty_value(kind: Type[FeatureType]):
    """The value a non-nullable kind takes when nothing was observed (≙ the
    reference's monoid zeros: SumRealNN → 0)."""
    if issubclass(kind, Prediction):
        return {"prediction": 0.0}
    return 0.0


class FeatureGeneratorStage(PipelineStage):
    def __init__(self, name: str, kind: Type[FeatureType],
                 extract_fn: Optional[Callable[[Dict[str, Any]], Any]] = None,
                 extract_source: Optional[str] = None, **params):
        super().__init__(**params)
        self.name = name
        self.kind = kind
        self.out_kind = kind
        self.has_custom_extract = extract_fn is not None
        if extract_fn is None and extract_source:
            extract_fn = eval(f"lambda r: ({extract_source})")  # noqa: S307
            self.has_custom_extract = True
        self.extract_fn = extract_fn or (lambda r, _n=name: r.get(_n))
        self.extract_source = extract_source

    @property
    def operation_name(self) -> str:
        return f"FeatureGenerator[{self.name}]"

    def output_name(self) -> str:
        return self.name

    def extract_column(self, records: Iterable[Dict[str, Any]]) -> Column:
        """The raw column of ``records`` (JAX :55-65)."""
        vals = [self.extract_fn(r) for r in records]
        if self.kind.non_nullable:
            zero = non_nullable_empty_value(self.kind)
            vals = [zero if v is None else v for v in vals]
        return column_from_values(self.kind, vals)

    def ctor_args(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind.__name__,
                "extract_source": self.extract_source}
