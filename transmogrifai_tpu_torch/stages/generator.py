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
acted on.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type

from ..types import FeatureType
from .base import PipelineStage


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

    def ctor_args(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind.__name__,
                "extract_source": self.extract_source}
