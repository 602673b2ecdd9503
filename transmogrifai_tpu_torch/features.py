"""Feature graph nodes and builders (port of ``transmogrifai_tpu/features.py``;
reference: FeatureLike.scala:50, FeatureBuilder.scala:48).

A ``Feature`` is a lazy symbolic column: name + kind + origin stage + parents.
The workflow reconstructs the stage DAG by DFS over ``parent_stages``.  The
DSL sugar the port carries: ``transmogrify``, ``sanity_check``, the
bucketizers' ``auto_bucketize``, ``bucketize``, ``scale`` and ``descale``, and
the dates' ``to_unit_circle`` and ``to_time_period``.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

from .types import FEATURE_TYPES, FeatureType, RealNN

_uid_counters: Dict[str, itertools.count] = {}


def make_uid(class_name: str) -> str:
    c = _uid_counters.setdefault(class_name, itertools.count())
    return f"{class_name}_{next(c):012x}"


class Feature:
    """A node in the feature DAG (≙ FeatureLike)."""

    def __init__(self, name: str, kind: Type[FeatureType], is_response: bool,
                 origin_stage, parents: Sequence["Feature"],
                 uid: Optional[str] = None):
        self.name = name
        self.kind = kind
        self.is_response = bool(is_response)
        self.origin_stage = origin_stage
        self.parents: Tuple[Feature, ...] = tuple(parents)
        self.uid = uid or make_uid("Feature")

    @property
    def is_raw(self) -> bool:
        from .stages.generator import FeatureGeneratorStage
        return (self.origin_stage is None
                or isinstance(self.origin_stage, FeatureGeneratorStage))

    def parent_stages(self) -> Dict[Any, int]:
        """DFS over lineage → stage → max distance from this feature
        (≙ FeatureLike.parentStages, used by computeDAG)."""
        dist: Dict[Any, int] = {}
        stack: List[Tuple[Feature, int]] = [(self, 0)]
        while stack:
            feat, d = stack.pop()
            st = feat.origin_stage
            if st is None:
                continue
            if dist.get(st, -1) < d:
                dist[st] = d
            for p in feat.parents:
                stack.append((p, d + 1))
        return dist

    def all_features(self) -> List["Feature"]:
        seen: Dict[str, Feature] = {}
        stack = [self]
        while stack:
            f = stack.pop()
            if f.uid in seen:
                continue
            seen[f.uid] = f
            stack.extend(f.parents)
        return list(seen.values())

    def __repr__(self):
        return f"Feature<{self.kind.__name__}>({self.name!r})"

    # ---- DSL sugar (≙ dsl/Rich*Feature) ----------------------------------
    def transform_with(self, stage, *others: "Feature") -> "Feature":
        stage.set_input(self, *others)
        return stage.get_output()

    def transmogrify(self, **kw) -> "Feature":
        from .ops.transmogrify import transmogrify
        return transmogrify([self], **kw)

    def sanity_check(self, feature_vector: "Feature", **kw) -> "Feature":
        from .preparators.sanity_checker import SanityChecker
        st = SanityChecker(**kw)
        st.set_input(self, feature_vector)
        return st.get_output()

    def auto_bucketize(self, label: "Feature", **kw) -> "Feature":
        """Label-driven decision-tree bucketization
        (≙ RichNumericFeature.autoBucketize)."""
        from .ops.bucketizers import DecisionTreeNumericBucketizer
        st = DecisionTreeNumericBucketizer(**kw)
        st.set_input(label, self)
        return st.get_output()

    def bucketize(self, splits, **kw) -> "Feature":
        """Fixed-split bucketization (≙ RichNumericFeature.bucketize)."""
        from .ops.bucketizers import NumericBucketizer
        return self.transform_with(NumericBucketizer(splits=splits, **kw))

    def scale(self, scaling_type: str = "Linear", scaling_args=None,
              **kw) -> "Feature":
        from .ops.bucketizers import ScalerTransformer
        return self.transform_with(ScalerTransformer(
            scaling_type=scaling_type, scaling_args=scaling_args, **kw))

    def descale(self, scaled: "Feature", **kw) -> "Feature":
        from .ops.bucketizers import DescalerTransformer
        return self.transform_with(DescalerTransformer(**kw), scaled)

    def to_unit_circle(self, **kw) -> "Feature":
        """sin / cos of date periods (≙ RichDateFeature.toUnitCircle)."""
        from .ops.dates import DateToUnitCircleVectorizer
        return self.transform_with(DateToUnitCircleVectorizer(**kw))

    def to_time_period(self, period: str = "DayOfWeek") -> "Feature":
        """A date's period as an integral (≙ RichDateFeature
        .toTimePeriod)."""
        from .ops.dates import TimePeriodTransformer
        return self.transform_with(TimePeriodTransformer(period=period))


class FeatureBuilder:
    """Typed feature declaration (≙ FeatureBuilder.scala:48)::

        x = FeatureBuilder.RealNN("x").as_predictor()
        label = FeatureBuilder.RealNN("label").as_response()

    The port's workflows read columnar batches (``Workflow.set_input_batch``),
    named by feature; ``extract`` gives local scoring its record extractor
    (``source``: the same as a Python expression over the record ``r``,
    which a saved model keeps), ``window`` an aggregation window that is
    saved but not yet acted on."""

    def __init__(self, name: str, kind: Type[FeatureType]):
        self.name = name
        self.kind = kind
        self._extract = None
        self._extract_source: Optional[str] = None
        self._window_ms: Optional[int] = None

    def extract(self, fn, source: Optional[str] = None) -> "FeatureBuilder":
        self._extract = fn
        self._extract_source = source
        return self

    def window(self, window_ms: int) -> "FeatureBuilder":
        self._window_ms = int(window_ms)
        return self

    def _build(self, is_response: bool) -> Feature:
        from .stages.generator import FeatureGeneratorStage
        stage = FeatureGeneratorStage(
            name=self.name, kind=self.kind, extract_fn=self._extract,
            extract_source=self._extract_source,
            aggregate_window_ms=self._window_ms)
        feat = Feature(self.name, self.kind, is_response, stage, parents=())
        stage._output = feat
        return feat

    def as_predictor(self) -> Feature:
        return self._build(is_response=False)

    def as_response(self) -> Feature:
        return self._build(is_response=True)


def _install_typed_constructors():
    for name, kind in FEATURE_TYPES.items():
        def ctor(fname: str, _k=kind) -> FeatureBuilder:
            return FeatureBuilder(fname, _k)
        setattr(FeatureBuilder, name, staticmethod(ctor))


_install_typed_constructors()


def features_from_schema(schema: Dict[str, Type[FeatureType]], response: str,
                         response_kind: Type[FeatureType] = RealNN
                         ) -> Tuple[Feature, List[Feature]]:
    """(response, predictors) from a name → kind schema, predictors in the
    schema's order (≙ ``features_from_schema``, features.py:389;
    FeatureBuilder.fromDataFrame)."""
    if response not in schema:
        raise ValueError(
            f"response feature {response!r} is not present in the schema; "
            f"available: {sorted(schema)}")
    resp = FeatureBuilder(response, response_kind).as_response()
    predictors = [FeatureBuilder(name, kind).as_predictor()
                  for name, kind in schema.items() if name != response]
    return resp, predictors
